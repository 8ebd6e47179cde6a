"""Card smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version at its path's full shapes, then runs
each path that carries a kernel on one GPU: the per-pair stereo path
(`match_pair`) at the full width of the `myself` preset, the tensor-core
sweep's entry point (`ncc_sweep_match_mxu`), bundle adjustment at the
bench size and the feature front end at full image size, each checked
against its own criteria.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. versions, card name and power limit; refuses to run without CUDA
  2. nvcc build of reconstruction_tpu_torch/csrc/*.cu (one process per
     source, into reconstruction_tpu_torch/_build/)
  3. each kernel against its plain version on the same inputs, bit-equal:
     K1 sweep (64-shift, guided +-2 with hole rows, rematch-style sparse
     holes; the blocks in each of its modes), K3 cost volume (slot-major,
     64-row bands and an edge-clamp case), K2 fused sweeps against as many
     plain single sweeps (30 across a window re-extraction, and 13), K5
     tensor-core sweep (also against K1; 64 shifts, and 256 in two
     chunks, with K1's time and the pairs K5 evaluates beside it), all at
     H=1920, W=1280, C=3; K4
     coupling at E=18, O=8, M=65,536, C=16.  Each kernel's device time
     (torch.profiler) beside its bound (bytes, float32 operations, or for
     K5 int8 tensor-core ones, of this run's inputs at the H100's peak
     rates; K2's taps counted once a launch) and its plain version's time;
     K1's, K3's and K5's whole wrapper call, which reads back an
     integer-grid flag (K5's split into its launch, the host's time before
     it and a read-back yardstick); K1 also on the
     guided and rematch cases, and timed by CUDA events around its launch
     (the profiler's stand-in where a session records no kernel); K3 beside a plain fill of a volume of its
     size; K4 beside scatter_add_ (the library yardstick)
  4. match_pair on a rendered 1280x1920 two-view scene, preset "myself",
     twice, with the kernels' launch counts, per-level times, cloud
     metrics and determinism, then torch.profiler over a third, warm run
     (device time and launches by kernel), and K1's launches of a fourth,
     one line each (call, shape, useful and evaluated pairs, modes, time,
     bound); the same path on a small scene against the plain CPU path
  5. ncc_sweep_match_mxu at the 64-shift 1920x1280 cell, equal to
     ncc_sweep_match (K1) on the same inputs, profiled
  6. bundle_adjust at 16 cameras, 65,536 points, 8 observations per
     point: cost drop, aligned point error, determinism, a profiled run,
     ms per ba_step
  7. Harris, colour descriptors, tracks and structure-only BA on three
     rendered 1280x1920 views (surface error), and at 160x120 card vs CPU
  8. the kernels line, the card line, and last {"ok": true, "device": {...}}

Full logs go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Published peaks of one H100 SXM: device memory, float32 outside the
# tensor cores, and int8 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12


def bound(nbytes: float, ops: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take for the work: the largest of the
    bytes that must move over the memory rate, the float32 operations over
    their peak rate and the int8 tensor-core operations over theirs (the
    two units run side by side), and which of bytes or operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, int8_ops / INT8_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops, bound_int8_ops=int8_ops)


def useful_pairs(active, lo, hi) -> float:
    """The (pixel, target) pairs the sweep scores: each active pixel's
    bounds clipped to the image's columns."""
    import torch
    W = lo.shape[1]
    n = hi.clamp(max=W - 1) - lo.clamp(min=0) + 1
    return float(torch.where(active, n.clamp_min(0), 0).double().sum())


def sweep_bound(L, active, lo, hi, r) -> dict:
    """K1's and K5's function: inputs L, R (H, W, C) f32, six (H, W) f32 or
    int32 maps and two bool maps read once, score and column written once;
    per (active pixel, target) pair it scores, C multiplies and C-1 adds of
    the product, 4r adds of the separable box and 5 for the score and the
    compare."""
    H, W, C = L.shape
    nbytes = H * W * (2 * C * 4 + 6 * 4 + 2 + 2 * 4)
    return bound(nbytes, useful_pairs(active, lo, hi) * (2 * C - 1 + 4 * r + 5))


def mxu_bound(L, active, lo, hi, r) -> dict:
    """K5's: the bytes of `sweep_bound`; per (active pixel, target) pair the
    window's (2r+1)^2 C multiplies and adds on int8 tensor cores, and 5
    float32 operations for the score and the compare."""
    H, W, C = L.shape
    pairs = useful_pairs(active, lo, hi)
    return bound(H * W * (2 * C * 4 + 6 * 4 + 2 + 2 * 4), pairs * 5,
                 pairs * 2 * (2 * r + 1) ** 2 * C)


def k1_plan(K13, active, lo, hi, r) -> dict:
    """K1's evaluated pairs and modes (`ops.ncc_sweep.sweep_plan`); -1 each
    for a package whose K1 has no modes (the one before its redesign, run
    by this script for an A/B)."""
    if hasattr(K13, "sweep_plan"):
        return K13.sweep_plan(active, lo, hi, r)
    return dict(evaluated=-1, heaviest_block=-1, sweep_blocks=-1,
                candidate_blocks=-1)


def tile_union_pairs(active, lo, hi, tx: int, ty: int) -> float:
    """Pairs a sweep evaluates that runs every pixel slot of each tx x ty
    tile over the union of its active pixels' shift ranges (clipped to
    +-(W-1)): the rule of K1 before its redesign, 32 x 8 tiles."""
    import torch
    import torch.nn.functional as F
    H, W = lo.shape
    x = torch.arange(W, dtype=torch.int32, device=lo.device)[None, :]
    big = 1 << 20
    ph, pw = -H % ty, -W % tx
    smin = F.pad(torch.where(active, lo - x, big), (0, pw, 0, ph), value=big)
    smax = F.pad(torch.where(active, hi - x, -big), (0, pw, 0, ph), value=-big)
    tiles = lambda m: m.reshape((H + ph) // ty, ty, (W + pw) // tx, tx)
    smin = tiles(smin).amin((1, 3)).clamp(-(W - 1), W - 1)
    smax = tiles(smax).amax((1, 3)).clamp(-(W - 1), W - 1)
    n = (smax - smin + 1).clamp_min(0)
    return float(n.double().sum()) * tx * ty


def volume_bound(cargs) -> dict:
    """K3: L, R (H, W, C) f32 and four (H, W) f32 moments read once, the
    (H, s_cap, W) f32 volume written once; per filled (pixel, slot), C
    multiplies and C-1 adds of the product, 4 adds of the 3x3 box and 6
    for the score."""
    import torch
    L, base_b, lo_b, hi_b, s_cap, band = (cargs[0],) + tuple(cargs[6:])
    H, W, C = L.shape
    rows = torch.arange(H, device=L.device) // band
    lo, hi, base = lo_b[rows].long(), hi_b[rows].long(), base_b[rows].long()
    # Filled slots per row: the shifts of [lo, hi] that land in [0, s_cap),
    # at least one when the range is not empty (the clamped edge slot).
    a = torch.maximum(lo - base, torch.zeros_like(lo))
    b = torch.minimum(hi - base, torch.full_like(hi, s_cap - 1))
    filled = torch.where(hi >= lo, (b - a + 1).clamp_min(1), 0)
    nbytes = H * W * (2 * C + 4) * 4 + H * W * s_cap * 4
    return bound(nbytes, float(filled.sum()) * W * (2 * C - 1 + 4 + 6))


def refine_bound(d, cv, j0, jref, inner, ws: float, sweeps: int) -> dict:
    """K2 over ``sweeps`` sweeps in one launch: d, j0, jref (4 bytes) and
    inner (1) read once and d written once; every 4-byte tap of the volume
    that one of the sweeps reads, counted once however many read it (the
    taps of the plain sweeps, from their anchors); ~70 float32 operations
    (the parabola, two exps, the blend) per pixel that can move (valid and
    inner) and sweep."""
    import torch
    from reconstruction_tpu_torch.config import NOMATCH
    from reconstruction_tpu_torch.ops import refine as K2
    H, W = d.shape
    S = cv.shape[1]
    movers = (d != NOMATCH) & inner
    rows = torch.arange(H, device=d.device)[:, None].expand(H, W)
    cols = torch.arange(W, device=d.device)[None, :].expand(H, W)
    touched = torch.zeros((H, S, W), dtype=torch.bool, device=d.device)
    reads = 0.0
    for _ in range(sweeps):
        j = (K2.CENTER + (torch.trunc(d - 1.5) - jref)).to(torch.int32)
        for off in (-1, 0, 1):
            jj = j + off
            k = j0 + jj
            ok = movers & (jj >= 0) & (jj < K2.MINI) & (k >= 0) & (k < S)
            touched[rows[ok], k[ok].long(), cols[ok]] = True
            reads += float(ok.sum())
        d = K2.refine_sweep_plain(d, cv, j0, jref, inner, ws)
    taps = float(touched.sum())
    del touched
    return dict(bound(H * W * 17 + taps * 4, sweeps * float(movers.sum()) * 70),
                taps_distinct=taps, tap_reads=reads)


def report(name: str, res: dict, card: str) -> None:
    share = res["bound_ms"] / res["ms"]
    lib = res.get("library_ms")
    call = f", wrapper call {res['call_ms']:.4f} ms" if "call_ms" in res else ""
    log(f"{name}: kernel {res['ms']:.4f} ms{call}, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), {100 * share:.1f}% of the bound, plain "
        f"{res['plain_ms']:.4f} ms, library "
        f"{'none' if lib is None else f'{lib:.4f} ms'} ({card})")


def device_events(run, attempts: int = 3) -> list:
    """The device events of torch.profiler (CPU and CUDA activity) over
    ``run``.  The profiler on the card's machine now and then records no
    device event in a session; such a session is run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    raise AssertionError(f"the profiler recorded no device event in {attempts} sessions")


def launch_event_ms(fn, reps: int) -> float:
    """Milliseconds per kernel launch of ``fn`` (reps calls) from CUDA events
    recorded around each `_build.launch`.  A spin kernel holds the stream
    while the host queues the events and the launch, so no host gap falls
    between them: the kernel's time plus two event records."""
    import torch
    from reconstruction_tpu_torch.ops import _build
    real, pairs = _build.launch, []

    def timed(entry, *args):
        torch.cuda._sleep(1 << 18)     # ~0.15 ms of spinning at the card's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(entry, *args)
        end.record()
        pairs.append((start, end))

    fn()
    torch.cuda.synchronize()
    _build.launch = timed
    try:
        for _ in range(reps):
            fn()
    finally:
        _build.launch = real
    torch.cuda.synchronize()
    if not pairs:
        raise AssertionError("no kernel launch to time")
    return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def launch_host_ms(fn, reps: int) -> float:
    """Host milliseconds from the start of a call of ``fn`` to its kernel
    launch (`_build.launch`), the mean of ``reps`` calls."""
    from reconstruction_tpu_torch.ops import _build
    real, marks = _build.launch, []

    def timed(entry, *args):
        marks.append(time.perf_counter())
        real(entry, *args)

    fn()
    _build.launch = timed
    total = 0.0
    try:
        for _ in range(reps):
            n, t0 = len(marks), time.perf_counter()
            fn()
            total += marks[n] - t0
    finally:
        _build.launch = real
    return total / reps * 1e3


def kernel_ms(fn, name: str, reps: int, sessions: int = 4, per_call: int = 1) -> float:
    """Milliseconds of device time per call of ``fn`` spent in kernels whose
    name contains ``name``, from torch.profiler: the kernels alone, without
    the wrapper's host work (K1's, K3's and K5's wrappers wait for an
    integer-grid flag) and the host's gaps; ``per_call`` kernels of that
    name a call (K5's prep and sweep) are summed.  The profiler on the
    card's machine drops events at the start of a session, so the session
    runs 2 * reps calls and the last reps calls' launches it recorded are
    averaged.
    Now and then a session records none of the kernels (only the flag's
    copies): it is run again, and after ``sessions`` such sessions the
    time comes from `launch_event_ms`, which the log says."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(2 * reps):
            fn()

    for _ in range(sessions):
        dev_events = device_events(run)
        hits = sorted((e for e in dev_events if name in e.name),
                      key=lambda e: e.time_range.start)[-reps * per_call:]
        calls = len(hits) // per_call
        if calls >= max(1, reps // 2):
            hits = hits[len(hits) - calls * per_call:]
            return sum(e.time_range.elapsed_us() for e in hits) / 1e3 / calls
        seen = sorted({e.name[:60] for e in dev_events})
        log(f"  the profiler saw {len(hits)} kernels named like {name} in "
            f"{2 * reps} calls (device events: {seen}); profiling again")
    ms = launch_event_ms(fn, reps)
    log(f"  {name}: {ms:.4f} ms from CUDA events around the launch, after "
        f"{sessions} profiler sessions without it")
    return ms


def phase_kernels(card: str) -> dict:
    """Each kernel against its plain version on the card, same inputs."""
    import torch
    from reconstruction_tpu_torch.config import NOMATCH
    from reconstruction_tpu_torch.ops import ba_coupling as K4
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.margins import find_margin, inner_box
    from reconstruction_tpu_torch.stereo.matching import _centered, ncc_moments
    from reconstruction_tpu_torch.stereo.refine import (_band_ranges,
                                                        resolve_recenter)

    dev = torch.device("cuda")
    H, W, C, r = 1920, 1280, 3, 2
    gen = torch.Generator(device=dev).manual_seed(7)
    base = torch.randint(0, 256, (H, W + 64, C), generator=gen, device=dev)
    imgL = base[:, 40:W + 40].float().contiguous()
    imgR = torch.clamp(base[:, :W].float()
                       + torch.randint(-3, 4, (H, W, C), generator=gen,
                                       device=dev), 0, 255).contiguous()
    yy = torch.arange(H, device=dev)[:, None].float()
    xx = torch.arange(W, device=dev)[None, :].float()
    valid = (((yy - H / 2) / (0.45 * H)) ** 2
             + ((xx - W / 2) / (0.45 * W)) ** 2) < 1.0
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    L, R = _centered(imgL), _centered(imgR)
    momL, momR = ncc_moments(L, r), ncc_moments(R, r)
    margs = (L, R, (momL.n * momL.mean).contiguous(), momL.inv_norm,
             momR.mean, momR.inv_norm)
    results = {}

    # K1, case 1: the 64-shift sweep of the bench cell (bounds x..x+63).
    lo = x.contiguous()
    hi = torch.clamp(x + 63, max=W - 1).contiguous()
    # K1, case 2: guided-style +-2 bounds around d=40, a few wide hole rows.
    lo2 = torch.clamp(x + 38, max=W - 1).clone()
    hi2 = torch.clamp(x + 42, max=W - 1).clone()
    for row in (100, 101, 900, 1500):
        lo2[row] = 2
        hi2[row] = W - 3
    # K1, case 3: rematch-style sparse holes (2%) with bounds up to 80 wide.
    holes = valid & (torch.rand((H, W), generator=gen, device=dev) < 0.02)
    lo3 = torch.clamp(x + torch.randint(-40, 1, (H, W), generator=gen, device=dev,
                                        dtype=torch.int32), 0, W - 1)
    hi3 = torch.clamp(lo3 + torch.randint(0, 81, (H, W), generator=gen, device=dev,
                                          dtype=torch.int32), 0, W - 1)
    errs = []
    cases = [(valid, lo, hi), (valid, lo2.contiguous(), hi2.contiguous()),
             (holes, lo3.contiguous(), hi3.contiguous())]
    for i, (act, a, b) in enumerate(cases):
        args = margs + (valid, act, a, b, r)
        sk, tk = K13.ncc_sweep(*args)
        sp, tp = K13.ncc_sweep_plain(*args)
        torch.cuda.synchronize()
        equal = torch.equal(sk, sp) and torch.equal(tk, tp)
        err = max(float((sk - sp).abs().max()), float((tk - tp).abs().max()))
        plan = k1_plan(K13, act, a, b, r)
        log(f"K1 ncc_sweep case {i}: bit-equal={equal} max_abs_err={err} "
            f"matched={int((tk >= 0).sum())} blocks in sweep mode "
            f"{plan['sweep_blocks']}, in candidate mode {plan['candidate_blocks']}")
        if not equal:
            raise AssertionError(f"K1 case {i} differs from its plain version")
        errs.append(err)
    args = margs + (valid, valid, lo, hi, r)
    ms = kernel_ms(lambda: K13.ncc_sweep(*args), "ncc_sweep_kernel", 20)
    # kernel_ms's last resort, run on every pass so that it is known to work.
    event_ms = launch_event_ms(lambda: K13.ncc_sweep(*args), 20)
    call_ms = cuda_ms(lambda: K13.ncc_sweep(*args), 20)
    plain_ms = cuda_ms(lambda: K13.ncc_sweep_plain(*args), 2)
    results["ncc_sweep"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                library_ms=None, call_ms=call_ms, event_ms=event_ms,
                                **sweep_bound(L, valid, lo, hi, r))
    report(f"K1 ncc_sweep 64 shifts {H}x{W}", results["ncc_sweep"], card)
    log(f"K1 ncc_sweep 64 shifts: {event_ms:.4f} ms from CUDA events around "
        f"the launch (profiler {ms:.4f} ms)")
    # The guided and rematch yardsticks: cases 1 and 2.
    for label, (act, a, b) in (("guided +-2 with hole rows", cases[1]),
                               ("rematch-style holes", cases[2])):
        yargs = margs + (valid, act, a, b, r)
        y_ms = kernel_ms(lambda: K13.ncc_sweep(*yargs), "ncc_sweep_kernel", 10)
        yb = sweep_bound(L, act, a, b, r)
        log(f"K1 ncc_sweep {label} {H}x{W}: kernel {y_ms:.4f} ms, bound "
            f"{yb['bound_ms']:.4f} ms ({yb['bound_by']}), "
            f"{100 * yb['bound_ms'] / y_ms:.1f}% of the bound ({card})")
        results["ncc_sweep"][label] = dict(ms=y_ms, bound_ms=yb["bound_ms"])

    # K3: the banded cost volume, s_cap 128, band 64, around d ~ 40; and
    # the clamped edge slots of bands whose range lies beyond +-W.
    d = torch.where(valid, 40.0 + torch.randint(-3, 4, (H, W), generator=gen,
                                                device=dev).float(),
                    torch.tensor(float(NOMATCH), device=dev))
    d_far = d.clone()
    d_far[:128] = torch.where(valid[:128], W + 100.0, float(NOMATCH))
    d_far[128:256] = torch.where(valid[128:256], -(W + 100.0), float(NOMATCH))
    s_cap, band = 128, 64
    m1 = ncc_moments(L, 1)
    m1R = ncc_moments(R, 1)
    for case, dd in (("64-row bands", d), ("edge clamp", d_far)):
        cargs = (L, R, (m1.n * m1.mean).contiguous(), m1.inv_norm, m1R.mean,
                 m1R.inv_norm, *_band_ranges(dd, s_cap, band, 16), s_cap, band)
        cvk = K13.cost_volume(*cargs)
        cvp = K13.cost_volume_plain(*cargs)
        torch.cuda.synchronize()
        equal = torch.equal(cvk, cvp)
        err = float((cvk - cvp).abs().max())
        edges = bool((cvk[:128, 0] != 0.5).any() and
                     (cvk[128:256, s_cap - 1] != 0.5).any())
        log(f"K3 cost_volume ({case}): bit-equal={equal} max_abs_err={err} "
            f"edge slots written={edges}")
        if not equal or (dd is d_far and not edges):
            raise AssertionError(f"K3 ({case}) differs from its plain version")
        del cvp
    cargs = (L, R, (m1.n * m1.mean).contiguous(), m1.inv_norm, m1R.mean,
             m1R.inv_norm, *_band_ranges(d, s_cap, band, 16), s_cap, band)
    base_b = cargs[6]
    cvk = K13.cost_volume(*cargs)
    # Yardsticks of what bounds K3: a plain fill of a volume of the same
    # size (the card's write rate), and K3 on bands with nothing to fill
    # (its own store pattern without the NCC work).
    fill = torch.empty_like(cvk)
    fill_ms = cuda_ms(lambda: fill.fill_(0.5), 10)
    del fill
    nm = torch.full_like(d, float(NOMATCH))
    eargs = cargs[:6] + _band_ranges(nm, s_cap, band, 16) + cargs[9:]
    empty_ms = kernel_ms(lambda: K13.cost_volume(*eargs), "cost_volume_kernel", 10)
    log(f"K3 yardsticks: fill_ of the volume {fill_ms:.4f} ms, K3 with no "
        f"filled slot {empty_ms:.4f} ms ({card})")
    ms = kernel_ms(lambda: K13.cost_volume(*cargs), "cost_volume_kernel", 10)
    call_ms = cuda_ms(lambda: K13.cost_volume(*cargs), 10)
    plain_ms = cuda_ms(lambda: K13.cost_volume_plain(*cargs), 1)
    results["cost_volume"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=None, call_ms=call_ms, fill_ms=fill_ms,
                                  empty_ms=empty_ms, **volume_bound(cargs))
    report(f"K3 cost_volume s_cap {s_cap} band {band} {H}x{W}",
           results["cost_volume"], card)

    # K2: the fused sweeps against as many plain single sweeps, on the
    # volume above: 30 sweeps with the auto re-extraction (18 + 12), and 13
    # sweeps (13 % T != 0).
    m = find_margin(valid, r)
    inner = inner_box(m, H, W, inset=1).contiguous()
    rowbase = base_b.repeat_interleave(band)[:H].contiguous()

    def sweeps(fused: bool, total: int, every: int):
        dd, done = d.contiguous(), 0
        while done < total:
            j0, jref = K2.window_anchors(dd, rowbase)
            n = min(every, total - done)
            if fused:
                dd = K2.refine_sweeps_fused(dd, cvk, j0, jref, inner, 0.03, n)
            else:
                for _ in range(n):
                    dd = K2.refine_sweep_plain(dd, cvk, j0, jref, inner, 0.03)
            done += n
        return dd

    T = K2.SWEEPS_PER_LAUNCH
    errs = []
    for total, every in ((30, resolve_recenter(30, -1)), (13, 0)):
        every = every or total
        n0 = K2.refine_sweeps_fused.launches
        dk = sweeps(True, total, every)
        launched = K2.refine_sweeps_fused.launches - n0
        dp = sweeps(False, total, every)
        torch.cuda.synchronize()
        equal = torch.equal(dk, dp)
        errs.append(float((dk - dp).abs().max()))
        log(f"K2 refine_sweeps_fused {total} sweeps (window every {every}, "
            f"T={T}, {launched} launches): bit-equal={equal} "
            f"max_abs_err={errs[-1]} "
            f"moved={float(((dk != d) & valid).float().mean()):.4f}")
        if not equal:
            raise AssertionError("K2 differs from its plain sweeps")
    j0, jref = K2.window_anchors(d, rowbase)
    ms = kernel_ms(lambda: K2.refine_sweeps_fused(d, cvk, j0, jref, inner,
                                                  0.03, T), "refine_sweeps_kernel", 20)
    plain_ms = cuda_ms(lambda: K2.refine_sweeps_fused_plain(
        d, cvk, j0, jref, inner, 0.03, T), 2)
    results["refine_sweeps_fused"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        sweeps=T, ms_per_sweep=ms / T,
        **refine_bound(d, cvk, j0, jref, inner, 0.03, T))
    kb = results["refine_sweeps_fused"]
    log(f"K2 taps of one launch: {kb['taps_distinct']:.0f} distinct of "
        f"{kb['tap_reads']:.0f} reads over {T} sweeps; bound "
        f"{kb['bound_bytes'] / 1e6:.1f} MB, {kb['bound_ms'] / T:.4f} ms a sweep")
    report(f"K2 refine_sweeps_fused, one launch of {T} sweeps {H}x{W} "
           f"({ms / T:.4f} ms a sweep)", results["refine_sweeps_fused"], card)

    # K5: the tensor-core sweep against its plain version and against K1,
    # on K1's 64-shift case (one 128-shift chunk; the bounds gate the rest)
    # and on x-128..x+127 at pad_shift 128 (two full chunks, the TPU
    # kernel's whole range).  Its kernel time sums all its launches a call.
    per_call = getattr(K5, "KERNELS_PER_CALL", 1)
    k5_cases = (("64 shifts", lo, hi),
                ("256 shifts", (x - 128).contiguous(), (x + 127).contiguous()))
    for label, a, b in k5_cases:
        args = margs + (valid, valid, a, b, r)
        s5, t5 = K5.ncc_sweep_mxu(*args, pad_shift=128)
        sp, tp = K5.ncc_sweep_mxu_plain(*args, pad_shift=128)
        s1, t1 = K13.ncc_sweep(*args)
        torch.cuda.synchronize()
        equal = torch.equal(s5, sp) and torch.equal(t5, tp)
        equal_k1 = torch.equal(s5, s1) and torch.equal(t5, t1)
        err = max(float((s5 - sp).abs().max()), float((t5 - tp).abs().max()))
        del sp, tp, s1, t1
        useful = useful_pairs(valid, a, b)
        plan = (K5.mma_plan(valid, a, b, r, 128) if hasattr(K5, "mma_plan")
                else dict(evaluated=-1))
        evaluated = plan["evaluated"]
        log(f"K5 ncc_sweep_mxu {label}: bit-equal to plain={equal} to K1={equal_k1} "
            f"max_abs_err={err} useful pairs {useful:.0f}, evaluated {evaluated} "
            f"({evaluated / useful:.3f}x); words fetched per pixel: "
            f"{ {k: round(v, 3) for k, v in plan.items() if k.endswith('fetches')} }")
        if not (equal and equal_k1):
            raise AssertionError(f"K5 ({label}) differs from its plain version or from K1")
        ms = kernel_ms(lambda: K5.ncc_sweep_mxu(*args), "ncc_sweep_mxu", 10,
                       per_call=per_call)
        # The prep pass alone, where the kernel has one.
        prep_ms = (kernel_ms(lambda: K5.ncc_sweep_mxu(*args), "ncc_sweep_mxu_prep", 10)
                   if per_call > 1 else None)
        call_ms = cuda_ms(lambda: K5.ncc_sweep_mxu(*args), 10)
        # The call's time above its kernels: CUDA events around the launch
        # (the state's memset and both kernels, no host gap), the host's
        # time from a call's start to its launch (the card idles then), and
        # K1's call, whose wrapper also reads a flag back.
        event_ms = launch_event_ms(lambda: K5.ncc_sweep_mxu(*args), 10)
        host_ms = launch_host_ms(lambda: K5.ncc_sweep_mxu(*args), 10)
        ms_k1 = kernel_ms(lambda: K13.ncc_sweep(*args), "ncc_sweep_kernel", 10)
        call_k1 = cuda_ms(lambda: K13.ncc_sweep(*args), 10)
        plain_ms = cuda_ms(lambda: K5.ncc_sweep_mxu_plain(*args), 1)
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, k1_ms=ms_k1,
                   call_ms=call_ms, event_ms=event_ms, host_ms=host_ms,
                   k1_call_ms=call_k1, library_ms=None, useful_pairs=useful,
                   evaluated_pairs=evaluated, kernels_per_call=per_call, prep_ms=prep_ms,
                   fetches={k: v for k, v in plan.items() if k.endswith("fetches")},
                   **mxu_bound(L, valid, a, b, r))
        report(f"K5 ncc_sweep_mxu {label} {H}x{W} (K1 {ms_k1:.4f} ms"
               + (f", prep pass {prep_ms:.4f} ms" if prep_ms is not None else "") + ")",
               res, card)
        log(f"K5 {label} call: {call_ms:.4f} ms = kernels {ms:.4f} (events around "
            f"the launch {event_ms:.4f}) + {call_ms - ms:.4f}, of which the host's "
            f"{host_ms:.4f} before the launch; K1 call {call_k1:.4f} = kernel "
            f"{ms_k1:.4f} + {call_k1 - ms_k1:.4f}; bound's operations: int8 "
            f"{res['bound_int8_ops'] / INT8_OPS_PER_S * 1e3:.4f} ms, float32 "
            f"{res['bound_ops'] / F32_OPS_PER_S * 1e3:.4f} ms ({card})")
        if label == "64 shifts":
            results["ncc_sweep_mxu"] = res
        else:
            results["ncc_sweep_mxu"][label] = res
    # The read-back's cost against the wait before it: a spin kernel as long
    # as K5's kernels in each case, then a 4-byte read back, against the
    # spin alone (back to back).
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    unit = cuda_ms(lambda: torch.cuda._sleep(1 << 20), 5) / (1 << 20)
    for res in (results["ncc_sweep_mxu"], results["ncc_sweep_mxu"]["256 shifts"]):
        cycles = int(res["ms"] / unit)
        spin = cuda_ms(lambda: torch.cuda._sleep(cycles), 10)
        spin_read = cuda_ms(lambda: (torch.cuda._sleep(cycles), flag.item()), 10)
        res["readback_ms"] = spin_read - spin
        log(f"read-back yardstick: spin {spin:.4f} ms, then a read back "
            f"{spin_read:.4f} ms: +{spin_read - spin:.4f} ms ({card})")

    # K4: the BA coupling contraction at the bench shape, some cams -1.
    E, O, M, C = 18, 8, 1 << 16, 16
    He = torch.randn((E, O, M), generator=gen, device=dev)
    cam = torch.randint(0, C, (O, M), generator=gen, device=dev,
                        dtype=torch.int32)
    cam[:, torch.randint(0, M, (M // 16,), generator=gen, device=dev)] = -1
    Wk = K4.ba_coupling(He, cam, C)
    Wp = K4.ba_coupling_plain(He, cam, C)
    torch.cuda.synchronize()
    equal = torch.equal(Wk, Wp)
    err = float((Wk - Wp).abs().max())
    log(f"K4 ba_coupling: bit-equal={equal} max_abs_err={err}")
    if not equal:
        raise AssertionError("K4 differs from its plain version")
    ms = kernel_ms(lambda: K4.ba_coupling(He, cam, C), "ba_coupling_kernel", 20)
    plain_ms = cuda_ms(lambda: K4.ba_coupling_plain(He, cam, C), 5)
    # The library yardstick: one scatter_add_ into (E, C+1, M), padding
    # cameras sent to slot C, the index prepared outside the timed region.
    idx = torch.where(cam < 0, C, cam).long()[None].expand(E, O, M)
    acc = torch.zeros((E, C + 1, M), device=dev)
    library_ms = cuda_ms(lambda: acc.scatter_add_(1, idx, He), 20)
    del acc, idx
    nbytes = (He.numel() + cam.numel() + Wk.numel()) * 4
    results["ba_coupling"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms,
                                  **bound(nbytes, He.numel()))
    report(f"K4 ba_coupling E={E} O={O} M={M} C={C}", results["ba_coupling"],
           card)
    return results


# Substrings of the port's kernel names, as the profiler reports them.
PORT_KERNELS = {"ncc_sweep": "ncc_sweep_kernel", "cost_volume": "cost_volume_kernel",
                "refine": "refine_sweep", "ba_coupling": "ba_coupling_kernel",
                "ncc_sweep_mxu": "ncc_sweep_mxu"}


def profile_run(run, label: str, card: str, top: int = 12) -> dict:
    """torch.profiler (CPU and CUDA activity) over one warm ``run``: device
    time and launches summed by kernel name, the port's kernels apart."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = device_events(run)
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    port = {}
    for key, sub in PORT_KERNELS.items():
        hits = [(ms, n) for name, (ms, n) in by_name.items() if sub in name]
        if hits:
            port[key] = dict(ms=sum(h[0] for h in hits),
                             launches=sum(h[1] for h in hits))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]
    log(f"profile of {label} ({card}): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{sum(n for _, n in by_name.values())} device events")
    for key, v in port.items():
        log(f"  port kernel {key}: {v['ms']:.3f} ms in {v['launches']} launches")
    for name, (ms, n) in ranked[:top]:
        log(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, port_kernels=port,
                top=[dict(name=k, ms=v[0], launches=v[1]) for k, v in ranked])


def _sweep_caller():
    """(level, call) of the matcher that is calling the sweep, from the
    stack: the pyramid level of `match_one_level` (0 is the coarsest) and
    brute, guided or rematch."""
    f, level, call = sys._getframe(2), None, None
    while f is not None:
        name = f.f_code.co_name
        if call is None and name in ("brute_force_match", "guided_match", "rematch"):
            call = name.split("_")[0]
        if name == "match_one_level":
            level = f.f_locals["level"]
            break
        f = f.f_back
    return level, call


def k1_launch_table(run, card: str) -> dict:
    """K1's launches in one warm ``run`` of match_pair, one line each: the
    sweep that `stereo.matching` calls is wrapped here (not in the
    package) to keep each call's arguments; each call is then replayed
    under the profiler.  Useful pairs: what the sweep scores; tile-union
    pairs: what a kernel that sweeps each 32 x 8 tile over its active
    pixels' shift union evaluates (the rule of K1 before its redesign);
    K1 evaluated: what K1 evaluates by its own per-block mode rule
    (`ops.ncc_sweep.sweep_plan`), with its blocks in each mode and the
    most pairs one block evaluates; maxw: the widest active pixel's target
    range."""
    import torch
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.stereo import matching

    calls = []
    real = matching.ncc_sweep

    def capture(*a):
        level, call = _sweep_caller()
        calls.append(dict(level=level, call=call, args=tuple(
            t.clone() if torch.is_tensor(t) else t for t in a)))
        return real(*a)

    matching.ncc_sweep = capture
    try:
        run()
    finally:
        matching.ncc_sweep = real
    seen = {}
    for c in calls:   # the directions run one after the other per call
        key = (c["level"], c["call"])
        c["dir"] = seen.get(key, 0)
        seen[key] = c["dir"] + 1

    ms_each = [kernel_ms(lambda: K13.ncc_sweep(*c["args"]), "ncc_sweep_kernel", 5)
               for c in calls]
    rows = []
    log(f"K1 launches of one warm match_pair ({card}):")
    log("   #  lvl dir call     HxW        active   useful pairs  tile-union "
        "K1 evaluated sweep  cand  heaviest  maxw    ms      bound ms  share")
    for i, c in enumerate(calls):
        L, active, lo, hi, r = (c["args"][0], c["args"][7], c["args"][8],
                                c["args"][9], c["args"][10])
        H, W = lo.shape
        ms = ms_each[i]
        b = sweep_bound(L, active, lo, hi, r)
        row = dict(level=c["level"], dir=c["dir"], call=c["call"], H=H, W=W,
                   active=int(active.sum()), useful=useful_pairs(active, lo, hi),
                   tile_union=tile_union_pairs(active, lo, hi, 32, 8),
                   max_width=int(torch.where(active, hi.clamp(max=W - 1)
                                             - lo.clamp(min=0) + 1, 0).max()),
                   ms=ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        plan = k1_plan(K13, active, lo, hi, r)
        row.update(evaluated=plan["evaluated"], sweep_blocks=plan["sweep_blocks"],
                   candidate_blocks=plan["candidate_blocks"],
                   heaviest_block=plan["heaviest_block"])
        rows.append(row)
        log(f"  {i:2d}  {row['level']}   {row['dir']}  {row['call']:7s} "
            f"{H:4d}x{W:<5d} {row['active']:8d} {row['useful']:13.0f} "
            f"{row['tile_union']:13.0f} {plan['evaluated']:13d} "
            f"{plan['sweep_blocks']:5d} {plan['candidate_blocks']:5d} "
            f"{plan['heaviest_block']:8d} {row['max_width']:5d}  {ms:8.4f}  "
            f"{b['bound_ms']:8.4f}  {100 * b['bound_ms'] / ms:5.1f}%")
    tot = {k: sum(r[k] for r in rows) for k in (
        "active", "useful", "tile_union", "evaluated", "ms", "bound_ms")}
    log(f"  sum {len(rows)} launches: active {tot['active']}, useful pairs "
        f"{tot['useful']:.0f}, tile-union pairs {tot['tile_union']:.0f}, K1 "
        f"evaluated pairs {tot['evaluated']}, {tot['ms']:.4f} ms against a "
        f"bound of {tot['bound_ms']:.4f} ms ({card})")
    del calls
    return dict(launches=rows, total=tot)


def cloud_metrics(cloud) -> dict:
    """tests/test_stereo_e2e.py's criteria on the compacted cloud."""
    from reconstruction_tpu_torch.utils.synthetic import surface_fn
    pts = cloud.compact().xyz
    sel = (np.abs(pts[:, 0]) < 1.6) & (np.abs(pts[:, 1]) < 1.6)
    dz = np.abs(pts[sel][:, 2] - surface_fn(pts[sel][:, 0], pts[sel][:, 1]))
    return dict(points=int(len(pts)), outlier_frac=float((dz > 0.15).mean()),
                inlier_rmse=float(np.sqrt((dz[dz <= 0.15] ** 2).mean())))


def phase_slice(card: str) -> dict:
    import torch
    from reconstruction_tpu_torch.config import NOMATCH, preset
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

    cfg = preset("myself")
    size = cfg.finest_size                         # (1280, 1920) W x H
    t0 = time.perf_counter()
    cams, imgs, masks = make_stereo_scene(image_size=size, span_deg=7.0,
                                          device="cuda")
    log(f"scene {size[0]}x{size[1]} rendered in {time.perf_counter() - t0:.2f} s")
    args = (cfg, imgs[0], imgs[1], masks[0], masks[1], cams[0].K, cams[0].Rt,
            cams[1].K, cams[1].Rt)

    wrappers = (("ncc_sweep", K13.ncc_sweep), ("cost_volume", K13.cost_volume),
                ("refine_sweeps_fused", K2.refine_sweeps_fused))
    for _, w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = match_pair(*args, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers}
    log(f"match_pair (first run, build excluded): {wall:.3f} s wall ({card})")
    log(f"per-level ms (CUDA events): {[round(v, 3) for v in res.level_ms]}")
    log(f"launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by match_pair")

    d = res.disparity
    assert tuple(d.shape) == (size[1], size[0]) and d.dtype == torch.float32
    assert bool(torch.isfinite(d).all())
    mask = res.rect_masks[0] == 255
    frac = float(((d != NOMATCH) & mask).sum()) / max(int(mask.sum()), 1)
    log(f"matched fraction of mask pixels: {frac:.4f}")
    log(f"refine drift p99 (levels x directions): "
        f"{res.refine_drift.cpu().numpy().round(4).tolist()}")
    metrics = cloud_metrics(res.cloud)
    log(f"cloud: {metrics}")
    if not (metrics["points"] > 5000 and metrics["outlier_frac"] < 0.02
            and metrics["inlier_rmse"] < 0.05):
        raise AssertionError(f"cloud outside the e2e criteria: {metrics}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = match_pair(*args, device="cuda")
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    same = torch.equal(res2.disparity, res.disparity)
    log(f"match_pair (second run): {wall2:.3f} s wall, per-level ms "
        f"{[round(v, 3) for v in res2.level_ms]}, deterministic={same} ({card})")
    if not same:
        raise AssertionError("two runs of match_pair on the card differ")
    prof = profile_run(lambda: match_pair(*args, device="cuda"),
                       "one warm match_pair", card)
    k1 = k1_launch_table(lambda: match_pair(*args, device="cuda"), card)
    return dict(launches=launches, wall_s=[wall, wall2],
                level_ms=[res.level_ms, res2.level_ms], matched_frac=frac,
                cloud=metrics, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                profile=prof, k1_launches=k1)


def phase_small_reference() -> dict:
    """The same path at the tiny preset on the card and on the CPU (the
    plain versions, which the CPU tests hold bit-equal to the JAX
    package)."""
    import torch
    from reconstruction_tpu_torch.config import NOMATCH, preset
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

    cfg = preset("tiny").replace(pyramid_levels=2, lowest_level_size=(80, 60))
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120), span_deg=24.0)
    args = (cfg, imgs[0], imgs[1], masks[0], masks[1], cams[0].K, cams[0].Rt,
            cams[1].K, cams[1].Rt)
    gpu = match_pair(*args, device="cuda").disparity.cpu().numpy()
    cpu = match_pair(*args, device="cpu").disparity.numpy()
    same_nm = float(((gpu == NOMATCH) == (cpu == NOMATCH)).mean())
    both = (gpu != NOMATCH) & (cpu != NOMATCH)
    diff = np.abs(gpu - cpu)[both]
    exact = float((diff == 0).mean())
    close = float((diff <= 0.05).mean())
    within1 = float((diff <= 1.0).mean())
    log(f"tiny preset, card vs CPU plain path: exact={exact:.4f} "
        f"same_NOMATCH={same_nm:.4f} within0.05={close:.4f} "
        f"within1={within1:.4f} p99={float(np.quantile(diff, 0.99)):.4f} "
        f"matched={int(both.sum())}")
    # The card's rsqrtf rounds inverse norms differently from the CPU's
    # rsqrt (last bit); the refine amplifies that at pixels whose anchor
    # sits on a trunc(d - 1.5) boundary, so agreement is statistical.
    if not (np.isfinite(gpu).all() and same_nm >= 0.99 and close >= 0.85
            and within1 >= 0.99 and both.sum() > 5000):
        raise AssertionError("card and CPU paths disagree on the tiny preset")
    return dict(exact=exact, same_nomatch=same_nm, within_0_05=close,
                within_1=within1)


def phase_mxu_path(card: str) -> dict:
    """The tensor-core sweep's entry point on the bench cell's inputs
    (64 shifts, 1920x1280x3, r=2), against `ncc_sweep_match` (K1)."""
    import torch
    from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
    from reconstruction_tpu_torch.ops.ncc_sweep_mxu import ncc_sweep_match_mxu
    from reconstruction_tpu_torch.stereo.matching import ncc_sweep_match

    dev = torch.device("cuda")
    H, W, C = 1920, 1280, 3
    gen = torch.Generator(device=dev).manual_seed(11)
    base = torch.randint(0, 256, (H, W + 64, C), generator=gen, device=dev)
    imgL = base[:, 40:W + 40].float().contiguous()
    imgR = base[:, :W].float().contiguous()
    valid = torch.ones((H, W), dtype=torch.bool, device=dev)
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    lo = x.contiguous()
    hi = torch.clamp(x + 63, max=W - 1).contiguous()
    K5.ncc_sweep_mxu.launches = 0
    torch.cuda.synchronize()
    res = ncc_sweep_match_mxu(imgL, imgR, valid, valid, lo, hi, 2)
    torch.cuda.synchronize()
    launches = K5.ncc_sweep_mxu.launches
    if launches <= 0:
        raise AssertionError("ncc_sweep_match_mxu launched no K5")
    prof = profile_run(lambda: ncc_sweep_match_mxu(imgL, imgR, valid, valid,
                                                   lo, hi, 2),
                       "one ncc_sweep_match_mxu", card, top=0)
    ref = ncc_sweep_match(imgL, imgR, valid, valid, lo, hi, 2)
    same = (torch.equal(res.disparity, ref.disparity)
            and torch.equal(res.score, ref.score))
    true_d = float((res.disparity == 40).float().mean())   # imgL(x) = imgR(x + 40)
    log(f"ncc_sweep_match_mxu {H}x{W}: equal to ncc_sweep_match={same}, "
        f"launches={launches}, fraction at the true disparity {true_d:.4f}")
    if not (same and true_d > 0.9):
        raise AssertionError("the tensor-core sweep's entry point disagrees")
    return dict(launches=launches, equal_k1=same, true_disparity_frac=true_d,
                profile=prof)


def _ba_problem(dev, num_cams=16, num_pts=1 << 16, obs=8, seed=0):
    """The ba_schur bench size on a 16-camera arc: points in [-1, 1]^3,
    each seen by `obs` of the cameras, noiseless projections, base poses
    perturbed by 0.01 (camera 0, the gauge anchor, exact), points by 0.05
    (tests/test_ba.py:16-54 at scale).  Returns (problem, Rt_true, pts_true)."""
    import torch
    from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem
    from reconstruction_tpu_torch.core.camera import synthetic_rig
    from reconstruction_tpu_torch.core.rectify import rodrigues_mat

    rng = np.random.default_rng(seed)
    cams = synthetic_rig(num_cams, span_deg=30.0)
    K = np.stack([np.asarray(c.K, np.float64) for c in cams])
    Rt_true = np.stack([np.asarray(c.Rt, np.float64) for c in cams])
    pts = rng.uniform(-1, 1, size=(num_pts, 3))
    cam = np.sort(np.argsort(rng.random((num_pts, num_cams)), axis=1)[:, :obs],
                  axis=1).astype(np.int32)
    xc = np.einsum("moij,mj->moi", Rt_true[cam][..., :3], pts) + Rt_true[cam][..., 3]
    uvw = np.einsum("moij,moj->moi", K[cam], xc)
    uv = uvw[..., :2] / uvw[..., 2:3]
    Rt0 = Rt_true.copy()
    for ci in range(1, num_cams):
        dR = rodrigues_mat(rng.normal(scale=0.01, size=3))
        Rt0[ci, :, :3] = dR @ Rt_true[ci, :, :3]
        Rt0[ci, :, 3] = dR @ Rt_true[ci, :, 3] + rng.normal(scale=0.01, size=3)
    pts0 = pts + rng.normal(scale=0.05, size=pts.shape)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    prob = BAProblem(K=t(K), Rt0=t(Rt0), points0=t(pts0), obs_uv=t(uv),
                     obs_cam=t(cam, torch.int32),
                     obs_ok=torch.ones((num_pts, obs), dtype=torch.bool, device=dev))
    return prob, Rt_true, pts


def _aligned_point_error(points: np.ndarray, Rt_true, pts_true) -> np.ndarray:
    """Point errors after the similarity about camera 0's center that the
    free gauge leaves open (tests/test_ba.py:107-113)."""
    R0, t0 = Rt_true[0][:, :3], Rt_true[0][:, 3]
    C0 = -R0.T @ t0
    est = points.astype(np.float64) - C0
    ref = pts_true - C0
    s = float((est * ref).sum() / max(float((est * est).sum()), 1e-12))
    return np.linalg.norm(C0 + s * est - pts_true, axis=1)


def phase_ba(card: str) -> dict:
    """bundle_adjust at the bench size (16 cams, 65,536 points, 8 obs per
    point), twice, and the ms of one ba_step with K4 and with K4's plain
    version in its place."""
    import importlib
    import torch
    from reconstruction_tpu_torch.ops import ba_coupling as K4
    tb = importlib.import_module("reconstruction_tpu_torch.ba.bundle_adjust")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    prob, Rt_true, pts_true = _ba_problem(dev)
    log(f"BA problem (16 cams, 65536 points, 8 obs) built in "
        f"{time.perf_counter() - t0:.2f} s")
    runs = []
    for i in range(2):
        K4.ba_coupling.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, points, costs = tb.bundle_adjust(prob, iterations=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(launches=K4.ba_coupling.launches, wall_s=wall,
                         costs=costs.tolist(), points=points))
        log(f"bundle_adjust run {i}: {wall:.3f} s wall, K4 launches "
            f"{K4.ba_coupling.launches}, costs {[f'{c:.6g}' for c in costs.tolist()]}")
    launches = runs[0]["launches"]
    costs = runs[0]["costs"]
    err = _aligned_point_error(runs[0]["points"].cpu().numpy(), Rt_true, pts_true)
    same = (runs[0]["costs"] == runs[1]["costs"]
            and torch.equal(runs[0]["points"], runs[1]["points"]))
    med = float(np.median(err))
    log(f"BA: cost {costs[0]:.6g} -> {costs[-1]:.6g} "
        f"(drop {costs[0] / max(costs[-1], 1e-30):.3g}x), median aligned "
        f"point error {med:.3g}, two runs identical={same}")
    if launches <= 0:
        raise AssertionError("bundle_adjust launched no K4")
    if not (np.isfinite(costs).all() and costs[-1] * 1e3 <= costs[0]
            and med < 5e-3 and same):
        raise AssertionError("bundle adjustment outside its criteria")

    prof = profile_run(lambda: tb.bundle_adjust(prob, iterations=10),
                       "one bundle_adjust (10 iterations)", card, top=5)
    poses0 = torch.zeros((16, 6), device=dev)
    step_ms = cuda_ms(lambda: tb.ba_step(prob, poses0, prob.points0, 16), 10)
    tb.ba_coupling = K4.ba_coupling_plain
    try:
        step_plain_ms = cuda_ms(lambda: tb.ba_step(prob, poses0, prob.points0, 16), 5)
    finally:
        tb.ba_coupling = K4.ba_coupling
    log(f"ba_step 16 cams / 65536 points / 8 obs: {step_ms:.3f} ms with K4, "
        f"{step_plain_ms:.3f} ms with its plain version ({card})")
    return dict(launches=launches, costs=costs, median_point_err=med,
                deterministic=same, wall_s=[r["wall_s"] for r in runs],
                step_ms=step_ms, step_plain_ms=step_plain_ms, profile=prof)


def _front_end(image_size, device, max_features):
    """Harris on gray, colour window descriptors, tracks over pairs (0,1),
    (1,2), (0,2) and a structure-only bundle adjustment on three rendered
    views.  Colour, because at 1280x1920 the scene's texture is smooth over
    a 9x9 window: gray windows are near-linear ramps that match any window
    of the same gradient direction at NCC > 0.95 (at 640x960, gray gave a
    median |dz| of 0.142 and colour 0.021, on the CPU)."""
    import torch
    from reconstruction_tpu_torch.ba import (build_tracks, bundle_adjust,
                                             describe, harris_corners)
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

    render_dev = device if device == "cuda" else "cpu"
    cams, imgs, masks = make_stereo_scene(image_size=image_size, span_deg=10.0,
                                          num_cameras=3, device=render_dev)
    feats, descs = [], []
    for img, msk in zip(imgs, masks):
        gray = torch.as_tensor(img.mean(-1), device=device)
        f = harris_corners(gray, torch.as_tensor(msk > 200, device=device),
                           max_features=max_features)
        feats.append(f)
        descs.append(describe(torch.as_tensor(img, device=device), f, radius=4))
    K = [np.asarray(c.K, np.float64) for c in cams]
    Rt = [np.asarray(c.Rt, np.float64) for c in cams]
    prob = build_tracks(feats, descs, K, Rt, pairs=[(0, 1), (1, 2), (0, 2)],
                        threshold=0.7)
    _, points, costs = bundle_adjust(prob, iterations=6, fix_cameras=True)
    return prob, points.cpu().numpy(), costs.numpy()


def _median_dz(points: np.ndarray) -> float:
    from reconstruction_tpu_torch.utils.synthetic import surface_fn
    sel = (np.abs(points[:, 0]) < 1.5) & (np.abs(points[:, 1]) < 1.5)
    return float(np.median(np.abs(points[sel][:, 2]
                                  - surface_fn(points[sel][:, 0], points[sel][:, 1]))))


def phase_front_end(card: str) -> dict:
    """The feature front end at the myself finest size (1280x1920), then at
    160x120 on the card and on the CPU."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob, points, costs = _front_end((1280, 1920), "cuda", 1024)
    wall = time.perf_counter() - t0
    dz = _median_dz(points)
    log(f"front end 1280x1920 (render included): {wall:.2f} s, "
        f"{points.shape[0]} tracks, costs {costs[0]:.6g} -> {costs[-1]:.6g}, "
        f"median |dz| {dz:.4f}")
    if not (points.shape[0] > 20 and costs[-1] <= costs[0] and dz < 0.1):
        raise AssertionError("full-size front end outside its criteria")

    pg, xg, cg = _front_end((160, 120), "cuda", 256)
    pc, xc, cc = _front_end((160, 120), "cpu", 256)
    rel = float(np.abs(cg[-1] - cc[-1]) / max(abs(cc[-1]), 1e-30))
    log(f"front end 160x120: tracks card {xg.shape[0]} CPU {xc.shape[0]}, "
        f"final cost card {cg[-1]:.6g} CPU {cc[-1]:.6g} (rel {rel:.2e}), "
        f"median |dz| card {_median_dz(xg):.4f}")
    if not (xg.shape[0] == xc.shape[0] and rel < 1e-3):
        raise AssertionError("front end differs between card and CPU")
    return dict(wall_s=wall, tracks=int(points.shape[0]), median_dz=dz,
                costs=[float(costs[0]), float(costs[-1])],
                small_tracks=[int(xg.shape[0]), int(xc.shape[0])],
                small_cost_rel=rel)


def main() -> int:
    import torch
    # The package comes first: alone in a directory the script stops here.
    from reconstruction_tpu_torch.ops import _build
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    kern = phase_kernels(card)
    sl = phase_slice(card)
    small = phase_small_reference()
    mxu = phase_mxu_path(card)
    ba = phase_ba(card)
    front = phase_front_end(card)

    src = "reconstruction_tpu_torch/csrc/"
    rows = [
        dict(name="ncc_sweep", route="cuda", source=src + "ncc_sweep.cu",
             replaces="reconstruction_tpu/ops/ncc_sweep_pallas.py:48"),
        dict(name="cost_volume", route="cuda", source=src + "ncc_sweep.cu",
             replaces="reconstruction_tpu/stereo/refine.py:39"),
        dict(name="refine_sweeps_fused", route="cuda", source=src + "refine.cu",
             replaces="reconstruction_tpu/ops/refine_pallas.py:69"),
        dict(name="ba_coupling", route="cuda", source=src + "ba_coupling.cu",
             replaces="reconstruction_tpu/ops/ba_coupling_pallas.py:39"),
        dict(name="ncc_sweep_mxu", route="cuda", source=src + "ncc_sweep_mxu.cu",
             replaces="reconstruction_tpu/ops/ncc_sweep_mxu.py:68"),
    ]
    path_launches = dict(sl["launches"], ba_coupling=ba["launches"],
                         ncc_sweep_mxu=mxu["launches"])
    for row in rows:
        row["launches"] = path_launches[row["name"]]
        row.update({k: kern[row["name"]][k]
                    for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")})
        # The wrapper's whole call where it reads a check back from the card.
        if "call_ms" in kern[row["name"]]:
            row["call_ms"] = kern[row["name"]]["call_ms"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=rows, kernel_times=kern, slice=sl,
                       small=small, mxu_path=mxu, ba=ba, front_end=front,
                       build_log=_build.build_log), f, indent=1)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
