"""Card smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version at its path's full shapes, then runs
each path that carries a kernel on one GPU: the per-pair stereo path
(`match_pair`) at the full width of the `myself` preset, the tensor-core
sweep's entry point (`ncc_sweep_match_mxu`), bundle adjustment at the
bench size and the feature front end at full image size, the whole
pipeline at the bench configuration and at the 32-camera `dome32` preset
(3840x2160), each checked against its own criteria.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. versions, card name and power limit; refuses to run without CUDA
  2. nvcc build of reconstruction_tpu_torch/csrc/*.cu (one process per
     source, into reconstruction_tpu_torch/_build/)
  3. each kernel against its plain version on the same inputs, bit-equal:
     K1 sweep (64-shift, guided +-2 with hole rows, rematch-style sparse
     holes; the blocks in each of its modes), K3 cost volume (slot-major,
     64-row bands and an edge-clamp case), K2 fused sweeps against as many
     plain single sweeps (30 across a window re-extraction, and 13), K3
     and K2 also in their bfloat16 instances (the TPU refine's bfloat16
     cost window; K3's bound counts 2-byte entries, K2's 2-byte taps), K5
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
     size; K4 beside scatter_add_ (the library yardstick); K6 ordering and
     K7 bound propagation on the inputs a `myself` pair gives them at its
     finest level (1920x1280), both directions (`phase_constraints`): each
     once under torch.cuda.set_sync_debug_mode("error"), K6 bit-equal to
     its plain version everywhere, K7 at every mask-valid source pixel
     (the entries elsewhere that differ counted), the work that sets their
     time (K6's greedy steps a row and the points that cross any; K7's
     segments a column and runs a row), device time, whole call,
     plain time and byte bound
  4. match_pair on a rendered 1280x1920 two-view scene, preset "myself",
     twice, with the kernels' launch counts, per-level times, cloud
     metrics and determinism, its seconds by stage (the card synchronized
     around each; ordering and bound propagation summed over the levels),
     then torch.profiler over a warm run
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
  8. reconstruct at the bench configuration, twice (phase_reconstruct),
     then once with the bfloat16 cost window (the same gates), and in a
     fresh subprocess the first and second call of the splat, a sort and
     an rFFT (`first_calls`)
  9. the CLI on the reference's on-disk format at that configuration: a
     subprocess `python3 -m reconstruction_tpu_torch config.yml` against an
     in-process reconstruct of the same config, PLY bytes equal
 10. the multi-device layer (`parallel/`) at the bench configuration: one
     NCCL rank in this process (reconstruct(mesh=...), ba_step_sharded,
     refine_tiled at 1280x1920 with 120 sweeps, the z-sharded multigrid at
     256^3, each bit-equal to its single-device counterpart); four gloo
     ranks on the card (`parallel_rank`: the 4 pairs one a rank bit-equal
     to match_pair with K1/K3/K2 on every rank, the tile refine bit-equal,
     BA within the JAX package's criteria with K4 on every rank, splat
     within 1e-4, multigrid within 1e-6; each rank's wall, collective
     seconds (`CommClock`) and peak memory; the splat with its points of
     weight 0 left in, not gated; `parallel/dryrun.py` over one rank and
     over the four); the CLI with --sharded, PLY bytes equal
 11. reconstruct_video: 4 frames of 6 views at 1280x1920, the rig orbiting
     1.5 degrees a frame, closures every 3 frames; the pose estimate card
     against CPU at 320x240
 12. the other modes: segment_frame at 1280x1920 and card against CPU,
     depth_to_points card against CPU, run_batch over a 10-camera take,
     cut_image_dir
 13. the dome (phase_dome): preset "dome32" itself, 16 pairs at 3840x2160,
     5 levels, refine 30 + 30*level, through reconstruct(mesh=...) on one
     NCCL rank (the JAX dome tool's gates, wall by stage, peak memory);
     pair (0, 1) in float32 and with the bfloat16 cost window (the bf16
     kernels' launches in the kernels line, the disparity deviation), K3
     and K2 of each run bit-equal to their plain versions on its finest
     level's inputs (the 2160x128x3840 volume, all 150 sweeps), K6 and K7
     of the float32 run likewise (2160x3840, both directions, timed); the
     pair's seconds by stage and a profile of its finest level
 14. the port's headline bench (phase_bench, before the dome): `python -m
     reconstruction_tpu_torch.bench` in a fresh process at its defaults
     (the kernel cells, stereo-only, a cold and two timed `reconstruct`s at
     the bench configuration), its line's keys, value, kernel cells'
     utilizations <= 1 and mesh gates (the vertex count equal to phase 8's);
     then `python -m reconstruction_tpu_torch.tools.demo_video` (16 frames
     of 4 views at 320x240, the JAX tool's gates)
 15. the scaling harness (phase_scaling, before the dome): `python -m
     reconstruction_tpu_torch.tools.bench_scaling` in a fresh process at
     1920x1280 (--base 240 160 --levels 4), counts 1, 2 and 4 on the pair
     axis (gloo ranks sharing the card, K1/K3/K2 on every rank), 2 repeats:
     every key in every line, launches per pair equal across counts, each
     pair's digest equal at every count and to an in-process chain of
     `match_one_level` on the same pairs, in which K1 (pair 0's calls) and
     K3 and K2 (its finest level's first refine) are bit-equal to their
     plain versions; dev_eff, the wall efficiencies and comm_bytes logged
 16. the kernels line, the card line, and last {"ok": true, "device": {...}}

Named phases run alone (no kernels line, no result): kernels, slice, small,
mxu, ba, front, reconstruct, cli, video, satellites, parallel, dome, bench,
scaling.

Full logs go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from reconstruction_tpu_torch.tools.k67_phase_clocks import keep_constraint_calls
from reconstruction_tpu_torch.tools.pair_stages import (
    device_events, digest, pair_digests, profile_pair, timed)


def log(*a):
    print(*a, flush=True)


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


def peaks() -> dict:
    """The card's published peaks (`utils/profiling.CHIP_PEAKS`): device
    memory bytes/s, float32 outside the tensor cores, int8 on them."""
    from reconstruction_tpu_torch.utils.profiling import CHIP_PEAKS
    return CHIP_PEAKS["h100"]


def bound(nbytes: float, ops: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take for the work: the largest of the
    bytes that must move over the memory rate, the float32 operations over
    their peak rate and the int8 tensor-core operations over theirs (the
    two units run side by side), and which of bytes or operations sets it."""
    p = peaks()
    t_bytes = nbytes / p["hbm_gbps"] * 1e3
    t_ops = max(ops / p["flops_f32"], int8_ops / p["int8_ops"]) * 1e3
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


def volume_bound(cargs, elem: int = 4) -> dict:
    """K3: L, R (H, W, C) f32 and four (H, W) f32 moments read once, the
    (H, s_cap, W) volume of ``elem``-byte entries (4 float32, 2 bfloat16)
    written once; per filled (pixel, slot), C multiplies and C-1 adds of
    the product, 4 adds of the 3x3 box and 6 for the score."""
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
    nbytes = H * W * (2 * C + 4) * 4 + H * W * s_cap * elem
    return bound(nbytes, float(filled.sum()) * W * (2 * C - 1 + 4 + 6))


def refine_bound(d, cv, j0, jref, inner, ws: float, sweeps: int) -> dict:
    """K2 over ``sweeps`` sweeps in one launch: d, j0, jref (4 bytes) and
    inner (1) read once and d written once; every tap of the volume that
    one of the sweeps reads (4 bytes in float32, 2 in bfloat16), counted
    once however many read it (the taps of the plain sweeps, from their
    anchors); ~70 float32 operations (the parabola, two exps, the blend)
    per pixel that can move (valid and inner) and sweep."""
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
    return dict(bound(H * W * 17 + taps * cv.element_size(),
                      sweeps * float(movers.sum()) * 70),
                taps_distinct=taps, tap_reads=reads)


def report(name: str, res: dict, card: str) -> None:
    share = res["bound_ms"] / res["ms"]
    lib = res.get("library_ms")
    call = f", wrapper call {res['call_ms']:.4f} ms" if "call_ms" in res else ""
    log(f"{name}: kernel {res['ms']:.4f} ms{call}, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), {100 * share:.1f}% of the bound, plain "
        f"{res['plain_ms']:.4f} ms, library "
        f"{'none' if lib is None else f'{lib:.4f} ms'} ({card})")


def launch_event_ms(fn, reps: int) -> float:
    """Milliseconds per kernel launch of ``fn`` (reps calls) from CUDA events
    recorded around each `_build.launch`.  A spin kernel holds the stream
    while the host queues the events and the launch, so no host gap falls
    between them: the kernel's time plus two event records."""
    import torch
    from reconstruction_tpu_torch.ops import _build
    real, pairs = _build.launch, []

    def marked(entry, *args):
        torch.cuda._sleep(1 << 18)     # ~0.15 ms of spinning at the card's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(entry, *args)
        end.record()
        pairs.append((start, end))

    fn()
    torch.cuda.synchronize()
    _build.launch = marked
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

    def marked(entry, *args):
        marks.append(time.perf_counter())
        real(entry, *args)

    fn()
    _build.launch = marked
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
    copies), or `device_events` records no device event at all in its own
    retries: it is run again, and after ``sessions`` such sessions the
    time comes from `launch_event_ms`, which the log says."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(2 * reps):
            fn()

    for _ in range(sessions):
        try:
            dev_events = device_events(run)
        except AssertionError as e:     # no device event at all in its sessions
            log(f"  {e} while timing {name}; profiling again")
            continue
        hits = sorted((e for e in dev_events if name in e.name),
                      key=lambda e: e.start_us)[-reps * per_call:]
        calls = len(hits) // per_call
        if calls >= max(1, reps // 2):
            hits = hits[len(hits) - calls * per_call:]
            return sum(e.us for e in hits) / 1e3 / calls
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
    bf16 = torch.bfloat16
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
        del cvp, cvk
        # K3's bfloat16 instance against its plain version (the float32
        # plain volume cast to bfloat16).
        cvb = K13.cost_volume(*cargs, dtype=bf16)
        cvp = K13.cost_volume_plain(*cargs, dtype=bf16)
        torch.cuda.synchronize()
        equal = torch.equal(cvb, cvp)
        err_b = float((cvb.float() - cvp.float()).abs().max())
        log(f"K3 cost_volume bfloat16 ({case}): bit-equal={equal} max_abs_err={err_b}")
        if not (equal and cvb.dtype == bf16):
            raise AssertionError(f"K3 bfloat16 ({case}) differs from its plain version")
        del cvb, cvp
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

    # K3's bfloat16 instance at the same shape (the TPU refine's bfloat16
    # window: half the stores), with the same two yardsticks.
    cvb = K13.cost_volume(*cargs, dtype=bf16)
    fill = torch.empty_like(cvb)
    fill_b = cuda_ms(lambda: fill.fill_(0.5), 10)
    del fill
    empty_b = kernel_ms(lambda: K13.cost_volume(*eargs, dtype=bf16), "cost_volume_kernel", 10)
    log(f"K3 bfloat16 yardsticks: fill_ of the volume {fill_b:.4f} ms, K3 with no "
        f"filled slot {empty_b:.4f} ms ({card})")
    ms = kernel_ms(lambda: K13.cost_volume(*cargs, dtype=bf16), "cost_volume_kernel", 10)
    call_ms = cuda_ms(lambda: K13.cost_volume(*cargs, dtype=bf16), 10)
    plain_ms = cuda_ms(lambda: K13.cost_volume_plain(*cargs, dtype=bf16), 1)
    results["cost_volume_bf16"] = dict(max_abs_err=err_b, ms=ms, plain_ms=plain_ms,
                                       library_ms=None, call_ms=call_ms, fill_ms=fill_b,
                                       empty_ms=empty_b, **volume_bound(cargs, elem=2))
    report(f"K3 cost_volume bfloat16 s_cap {s_cap} band {band} {H}x{W}",
           results["cost_volume_bf16"], card)

    # K2: the fused sweeps against as many plain single sweeps, on the
    # volumes above (float32, then bfloat16): 30 sweeps with the auto
    # re-extraction (18 + 12), and 13 sweeps (13 % T != 0).
    m = find_margin(valid, r)
    inner = inner_box(m, H, W, inset=1).contiguous()
    rowbase = base_b.repeat_interleave(band)[:H].contiguous()

    def sweeps(cv, fused: bool, total: int, every: int):
        dd, done = d.contiguous(), 0
        while done < total:
            j0, jref = K2.window_anchors(dd, rowbase)
            n = min(every, total - done)
            if fused:
                dd = K2.refine_sweeps_fused(dd, cv, j0, jref, inner, 0.03, n)
            else:
                for _ in range(n):
                    dd = K2.refine_sweep_plain(dd, cv, j0, jref, inner, 0.03)
            done += n
        return dd

    T = K2.SWEEPS_PER_LAUNCH
    j0, jref = K2.window_anchors(d, rowbase)
    for key, cv in (("refine_sweeps_fused", cvk), ("refine_sweeps_fused_bf16", cvb)):
        errs = []
        entry = K2.SWEEP_ENTRIES[cv.dtype]
        for total, every in ((30, resolve_recenter(30, -1)), (13, 0)):
            every = every or total
            n0 = K2.refine_sweeps_fused.launches[entry]
            dk = sweeps(cv, True, total, every)
            launched = K2.refine_sweeps_fused.launches[entry] - n0
            dp = sweeps(cv, False, total, every)
            torch.cuda.synchronize()
            equal = torch.equal(dk, dp)
            errs.append(float((dk - dp).abs().max()))
            log(f"K2 {key} {total} sweeps (window every {every}, "
                f"T={T}, {launched} launches): bit-equal={equal} "
                f"max_abs_err={errs[-1]} "
                f"moved={float(((dk != d) & valid).float().mean()):.4f}")
            chunks = [every] * (total // every) + [total % every] * (total % every > 0)
            if not (equal and launched == sum(-(-n // T) for n in chunks)):
                raise AssertionError(f"K2 ({key}) differs from its plain sweeps")
        ms = kernel_ms(lambda: K2.refine_sweeps_fused(d, cv, j0, jref, inner,
                                                      0.03, T), "refine_sweeps_kernel", 20)
        plain_ms = cuda_ms(lambda: K2.refine_sweeps_fused_plain(
            d, cv, j0, jref, inner, 0.03, T), 2)
        results[key] = dict(
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
            sweeps=T, ms_per_sweep=ms / T,
            **refine_bound(d, cv, j0, jref, inner, 0.03, T))
        kb = results[key]
        log(f"K2 {key} taps of one launch: {kb['taps_distinct']:.0f} distinct of "
            f"{kb['tap_reads']:.0f} reads over {T} sweeps; bound "
            f"{kb['bound_bytes'] / 1e6:.1f} MB, {kb['bound_ms'] / T:.4f} ms a sweep")
        report(f"K2 {key}, one launch of {T} sweeps {H}x{W} "
               f"({ms / T:.4f} ms a sweep)", kb, card)
    del cvb

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
            f"{res['bound_int8_ops'] / peaks()['int8_ops'] * 1e3:.4f} ms, float32 "
            f"{res['bound_ops'] / peaks()['flops_f32'] * 1e3:.4f} ms ({card})")
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

    # K6 and K7 on the inputs the myself pair gives them at its finest level.
    results.update(phase_constraints(card))
    return results


# Substrings of the port's kernel names, as the profiler reports them.
PORT_KERNELS = {"ncc_sweep": "ncc_sweep_kernel", "cost_volume": "cost_volume_kernel",
                "refine": "refine_sweep", "ba_coupling": "ba_coupling_kernel",
                "ncc_sweep_mxu": "ncc_sweep_mxu", "ordering": "ordering_constraint_kernel",
                "propagate_bounds": "propagate_bounds_"}


def profile_run(run, label: str, card: str, top: int = 12) -> dict:
    """torch.profiler (CPU and CUDA activity) over one warm ``run``
    (`tools/pair_stages.profile_pair`): device time and launches summed by
    kernel name, the port's kernels apart."""
    prof = profile_pair(run)
    by_name, wall_ms, busy = prof["by_name"], prof["wall_ms"], prof["busy_ms"]
    port = {}
    for key, sub in PORT_KERNELS.items():
        hits = [(ms, n) for name, (ms, n) in by_name.items() if sub in name]
        if hits:
            port[key] = dict(ms=sum(h[0] for h in hits),
                             launches=sum(h[1] for h in hits))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]
    log(f"profile of {label} ({card}): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{prof['events']} device events")
    for key, v in port.items():
        log(f"  port kernel {key}: {v['ms']:.3f} ms in {v['launches']} launches")
    for name, (ms, n) in ranked[:top]:
        log(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_events=prof["events"],
                port_kernels=port,
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
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.tools.pair_stages import pair_stage_seconds, scene_args

    size = preset("myself").finest_size            # (1280, 1920) W x H
    args, render_s = timed(lambda: scene_args("myself"))
    log(f"scene {size[0]}x{size[1]} rendered in {render_s:.2f} s")

    res, wall, launches = counted(lambda: match_pair(*args, device="cuda"))
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
    digests = pair_digests(res)
    log(f"digests (sha256 of dtype, shape and bytes): disparity {digests['disparity']}, xyz {digests['xyz']}, "
        f"colors {digests['colors']}, valid {digests['valid']}")
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
    stages = pair_stage_seconds(lambda: match_pair(*args, device="cuda"))
    log_stages("myself pair", stages, card)
    prof = profile_run(lambda: match_pair(*args, device="cuda"),
                       "one warm match_pair", card)
    k1 = k1_launch_table(lambda: match_pair(*args, device="cuda"), card)
    return dict(launches=launches, wall_s=[wall, wall2], digests=digests,
                level_ms=[res.level_ms, res2.level_ms], matched_frac=frac,
                cloud=metrics, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                pair_stages=stages, profile=prof, k1_launches=k1)


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
    # The card's NCC inverse norms are an IEEE sqrt and divide, like the
    # CPU's rsqrt on these inputs: the card's pair equals the CPU's.
    if not (np.isfinite(gpu).all() and exact == 1.0 and same_nm == 1.0
            and both.sum() > 5000):
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
    from reconstruction_tpu_torch.bench import ba_problem
    from reconstruction_tpu_torch.ops import ba_coupling as K4
    tb = importlib.import_module("reconstruction_tpu_torch.ba.bundle_adjust")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    prob, Rt_true, pts_true = ba_problem(device=dev)
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


def counted(fn, bf16: bool = False):
    """(result, seconds, launches by kernel) of ``fn()``: the pair path's
    kernel counts (K1's, K3's and K2's by C entry, K6's and K7's) set to 0
    just before it and read just after, for K3 and K2 in the volume type of the path
    (float32, or bfloat16 with ``bf16``, named with a "_bf16" suffix).
    Raises if ``fn`` launched K3 or K2 in the other type."""
    import torch
    from reconstruction_tpu_torch.ops import constraints as K67
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.ops import refine as K2
    dt = torch.bfloat16 if bf16 else torch.float32
    keyed = {"cost_volume": (K13.cost_volume, K13.VOLUME_ENTRIES[dt]),
             "refine_sweeps_fused": (K2.refine_sweeps_fused, K2.SWEEP_ENTRIES[dt])}
    K13.ncc_sweep.launches = 0
    K67.ordering.launches = 0
    K67.propagate_bounds.launches = 0
    for w, _ in keyed.values():
        w.launches.clear()
    out, seconds = timed(fn)
    other = {e: n for w, entry in keyed.values() for e, n in w.launches.items() if e != entry}
    if other:
        raise AssertionError(f"the {dt} path launched kernels of the other volume type: "
                             f"{other}")
    sfx = "_bf16" if bf16 else ""
    return out, seconds, dict(ncc_sweep=K13.ncc_sweep.launches,
                              **{name + sfx: w.launches[entry]
                                 for name, (w, entry) in keyed.items()},
                              ordering=K67.ordering.launches,
                              propagate_bounds=K67.propagate_bounds.launches)


# The JAX package's full bench on this configuration (BENCH_r05.json "mesh").
REF_MESH_VERTS = 282_709
RMSE_LIMIT = 0.0091                 # 1.2x its surface RMSE of 0.00755
BENCH_PAIRS = ((0, 1), (2, 3), (4, 5), (7, 6))


def bench_config():
    """The bench configuration at its 4 pairs, the port's bench's
    (`reconstruction_tpu_torch.bench.bench_config`, the JAX package's
    `bench.py:99-125`): the myself preset, mls_radius 0.02, a 256^3 Poisson
    grid, no dedup; the bench's RECON_BENCH_* knobs, where set, cut it."""
    from reconstruction_tpu_torch.bench import bench_config as config
    return config(len(BENCH_PAIRS))


def quantized(imgs, masks):
    """Views as the bench stores them: 8-bit images, masks at 0/255."""
    return ([np.clip(im, 0, 255).astype(np.uint8).astype(np.float32) for im in imgs],
            [np.where(m > 127, 255.0, 0.0).astype(np.float32) for m in masks])


def bench_scene(num_cameras: int, span_deg: float, size):
    """Cameras, 8-bit views and 0/255 masks of the rendered scene, rendered
    on the card."""
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene
    cams, imgs, masks = make_stereo_scene(image_size=size, span_deg=span_deg,
                                          num_cameras=num_cameras, device="cuda")
    return (cams,) + quantized(imgs, masks)


def first_calls() -> dict:
    """Seconds of the first and the second call, in a fresh process, of
    device operations a process pays for once: the deterministic splat
    (`surface/poisson._splat3`, sort-based `index_put_`) of 2^20 points
    into a 256^3 grid, a stable sort of 2^20 int64 keys and a 256^3
    rFFT/irFFT round trip; the card synchronized around each call.  Run in
    a subprocess of its own by `phase_reconstruct`."""
    import torch
    from reconstruction_tpu_torch.surface.poisson import _splat3

    dev = torch.device("cuda")
    _, context_s = timed(lambda: torch.zeros(1, device=dev))
    g = torch.Generator(device="cpu").manual_seed(0)
    pts = (torch.rand((1 << 20, 3), generator=g) * 250.0).to(dev)
    vals = torch.rand((1 << 20, 4), generator=g).to(dev)
    w = torch.ones(1 << 20, device=dev)
    keys = torch.randint(0, 1 << 24, (1 << 20,), generator=g).to(dev)
    f = torch.rand((256, 256, 256), generator=g).to(dev)
    ops = {
        "splat3": lambda: _splat3(torch.zeros((256, 256, 256, 4), device=dev), pts, w, vals),
        "sort_int64": lambda: torch.sort(keys, stable=True),
        "rfftn_256": lambda: torch.fft.irfftn(torch.fft.rfftn(f), s=f.shape),
    }
    return dict(context_s=context_s,
                **{name: [timed(op)[1], timed(op)[1]] for name, op in ops.items()})


def phase_reconstruct(card: str) -> dict:
    """`reconstruct` at the full bench configuration (`bench.py:69-139`):
    the myself preset at 1280x1920, 8 cameras on a 42-degree arc rendered
    on the card (quantized as the bench stores them), pairs (0,1), (2,3),
    (4,5), (7,6), mls_radius 0.02, a 256^3 Poisson grid, no dedup.  Two
    runs: stage seconds, K1/K3/K2/K6/K7 launches, mesh against the scene's
    surface and against the reference's vertex count, runs identical.
    A third run with the bfloat16 cost window (refine_cv_dtype), held to
    the same gates.  Then SOR and normals on one pair's raw cloud and MLS
    on the fused cloud, on the device path and on the native host path."""
    import dataclasses

    import torch
    from reconstruction_tpu_torch import native
    from reconstruction_tpu_torch.cloud.filters import sor_filter
    from reconstruction_tpu_torch.cloud.mls import mls_smooth
    from reconstruction_tpu_torch.cloud.normals import estimate_normals
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput, reconstruct
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse

    cfg = bench_config()
    (cams, imgs, masks), render_s = timed(lambda: bench_scene(8, 42.0, cfg.finest_size))
    pairs = [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                       K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                       K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
             for a, b in cfg.cam_pairs]
    _, native_s = timed(native.load)
    log(f"reconstruct scene: 8 views {cfg.finest_size[0]}x{cfg.finest_size[1]} rendered "
        f"in {render_s:.2f} s; native library ready in {native_s:.2f} s "
        f"(g++ {native.build_seconds if native.build_seconds is not None else 'cached'})")

    runs = []
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        rec, wall, launches = counted(lambda: reconstruct(cfg, pairs, device="cuda"))
        spans = {k: round(v, 4) for k, v in rec.timer.spans.items()}
        run = dict(wall_s=wall, spans=spans, launches=launches,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                   cloud_points=int(len(rec.cloud_xyz)), verts=int(len(rec.vertices)),
                   faces=int(len(rec.faces)),
                   rmse=point_to_surface_rmse(np.asarray(rec.vertices)),
                   stats=rec.stats.records)
        runs.append((rec, run))
        log(f"reconstruct run {i}: {wall:.2f} s wall ({card}); stage seconds "
            f"(synchronized spans): {spans}")
        log(f"reconstruct run {i}: fused cloud {run['cloud_points']} points, mesh "
            f"{run['verts']} vertices / {run['faces']} faces, point-to-surface RMSE "
            f"{run['rmse']:.6f}, peak device memory {run['peak_mem_gb']:.2f} GiB, "
            f"launches {launches}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched by reconstruct")
    (rec, run), (rec2, _) = runs
    same = (np.array_equal(rec.vertices, rec2.vertices)
            and np.array_equal(rec.faces, rec2.faces)
            and np.array_equal(rec.colors, rec2.colors))
    ratio = run["verts"] / REF_MESH_VERTS
    log(f"reconstruct gates: RMSE {run['rmse']:.6f} <= {RMSE_LIMIT}; vertices "
        f"{ratio:.3f}x of {REF_MESH_VERTS} within 0.8-1.25; two runs identical={same}")
    if not (run["rmse"] <= RMSE_LIMIT and 0.8 <= ratio <= 1.25 and same
            and np.isfinite(rec.vertices).all() and float(np.std(rec.colors)) > 10.0):
        raise AssertionError("reconstruct outside its gates")

    # The bfloat16 cost window (refine_cv_dtype="bfloat16": K3 and K2 in
    # bfloat16 at every level), once, with the float32 runs' gates.
    cfg_b = cfg.replace(stereo=dataclasses.replace(cfg.stereo, refine_cv_dtype="bfloat16"))
    torch.cuda.reset_peak_memory_stats()
    rec_b, wall_b, launches_b = counted(lambda: reconstruct(cfg_b, pairs, device="cuda"),
                                        bf16=True)
    bf = dict(wall_s=wall_b, launches=launches_b, verts=int(len(rec_b.vertices)),
              faces=int(len(rec_b.faces)), cloud_points=int(len(rec_b.cloud_xyz)),
              rmse=point_to_surface_rmse(np.asarray(rec_b.vertices)),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
              spans={k: round(v, 4) for k, v in rec_b.timer.spans.items()})
    bf["vert_ratio"] = bf["verts"] / REF_MESH_VERTS
    log(f"reconstruct bfloat16 cost window: {wall_b:.2f} s wall ({card}); fused cloud "
        f"{bf['cloud_points']} points, mesh {bf['verts']} vertices / {bf['faces']} faces "
        f"({bf['vert_ratio']:.3f}x of {REF_MESH_VERTS}), RMSE {bf['rmse']:.6f} (float32 "
        f"{run['rmse']:.6f}), peak {bf['peak_mem_gb']:.2f} GiB, K1/K3/K2/K6/K7 launches "
        f"{_launch_line(launches_b)}; stage seconds {bf['spans']}")
    if not (bf["rmse"] <= RMSE_LIMIT and 0.8 <= bf["vert_ratio"] <= 1.25
            and np.isfinite(rec_b.vertices).all() and all(launches_b.values())):
        raise AssertionError("reconstruct with the bfloat16 cost window outside its gates")
    del rec_b

    # What a fresh process pays once, operation by operation (the first
    # run's Poisson span holds ~12 s more than the second's).
    proc = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps(chip_smoke.first_calls()))"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"first_calls failed: {proc.stderr[-3000:]}")
    first = json.loads(proc.stdout.splitlines()[-1])
    log(f"a fresh process's first and second call, seconds ({card}): CUDA context "
        f"{first['context_s']:.3f}; " + "; ".join(
            f"{k} {v[0]:.3f} then {v[1]:.4f}" for k, v in first.items() if k != "context_s"))

    # The cloud stages on the two backends, each timed warm (one call first).
    cloud = rec.pair_results[0].cloud
    hx, hv = cloud.xyz.cpu().numpy(), cloud.valid.cpu().numpy()
    vp = np.asarray(rec.pair_results[0].rectification.T_final, np.float32)
    fused = torch.from_numpy(np.ascontiguousarray(rec.cloud_xyz)).cuda()
    fused_ok = torch.ones(len(fused), dtype=torch.bool, device="cuda")
    cc = cfg.cloud
    stages = {
        "sor": lambda b: sor_filter(cloud.xyz, cloud.valid, mean_k=cc.sor_mean_k,
                                    std_thresh=cc.sor_std_thresh, host_points=hx,
                                    host_valid=hv, backend=b),
        "normals": lambda b: estimate_normals(cloud.xyz, cloud.valid, cc.mls_radius, vp,
                                              host_points=hx, host_valid=hv, backend=b),
        "mls": lambda b: mls_smooth(fused, fused_ok, cc.mls_radius, rec.cloud_normals,
                                    host_points=rec.cloud_xyz,
                                    host_valid=np.ones(len(fused), bool), backend=b),
    }
    backends = {}
    for name, run_stage in stages.items():
        row = {}
        for b in ("torch", "native"):
            run_stage(b)
            out, s = timed(lambda: run_stage(b))
            row[b] = s
            row[b + "_out"] = out
        t_out, n_out = row.pop("torch_out"), row.pop("native_out")
        if name == "sor":
            row["agree"] = float((t_out.cpu().numpy() == n_out).mean())
        elif name == "normals":
            dots = np.abs((t_out.cpu().numpy() * n_out).sum(1))[hv]
            row["agree"] = float((dots > 0.995).mean())
        else:
            both = t_out[2].cpu().numpy() & n_out[2]
            row["agree"] = float(np.median(np.linalg.norm(
                t_out[0].cpu().numpy()[both] - n_out[0][both], axis=1)))
        backends[name] = row
    log(f"cloud backends, seconds ({card}): SOR and normals on pair 0's raw cloud "
        f"({int(hv.sum())} of {len(hv)} points), MLS on the fused cloud "
        f"({len(fused)} points); agreement: SOR keep share equal, normals share with "
        f"|cos| > 0.995, MLS median displacement: "
        + "; ".join(f"{k}: device {v['torch']:.3f} native {v['native']:.3f} "
                    f"agree {v['agree']:.4g}" for k, v in backends.items()))
    return dict(runs=[r for _, r in runs], identical=same, vert_ratio=ratio,
                launches=run["launches"], render_s=render_s, backends=backends, bf16=bf,
                first_calls=first,
                raw_points=int(hv.sum()), rec=rec, scene=(cams, imgs, masks))


# Scenes the CLI, video and satellite phases write (listed in .gitignore).
SCRATCH = "_smoke"


def write_calib(root: str, cams) -> None:
    from reconstruction_tpu_torch.io.opencv_yaml import save_opencv_yaml
    calib = {}
    for i, c in enumerate(cams):
        calib[f"intrinsic-{i}"] = np.asarray(c.K, np.float64)
        calib[f"extrinsic-{i}"] = np.asarray(c.Rt, np.float64)
    save_opencv_yaml(os.path.join(root, "calib_camera.yml"), calib)


def _launch_line(launches: dict) -> str:
    """K1/K3/K2/K6/K7 launches of a `counted` run."""
    return "/".join(str(n) for n in launches.values())


def log_seconds(stderr: str, t_launch: float, marker: str) -> float:
    """Seconds from ``t_launch`` (the host's clock) to the first line of the
    package's log (`utils/logging`: local time, milliseconds) that holds
    ``marker``."""
    import datetime
    for line in stderr.splitlines():
        if marker in line:
            stamp = datetime.datetime.strptime(" ".join(line.split(" ", 2)[:2]),
                                               "%Y-%m-%d %H:%M:%S,%f")
            return stamp.timestamp() - t_launch
    raise AssertionError(f"the CLI logged no line with {marker!r}")


def startup_seconds() -> dict:
    """A fresh interpreter's set-up that the CLI pays before its first
    pair: the wall of the whole process, the imports of `reconstruct`'s
    module, and the card's first context (one tensor, synchronized)."""
    code = ("import json, time\nt0 = time.perf_counter()\n"
            "import torch, reconstruction_tpu_torch.pipeline.reconstruct\n"
            "t1 = time.perf_counter()\ntorch.zeros(1, device='cuda')\n"
            "torch.cuda.synchronize()\n"
            "print(json.dumps(dict(import_s=t1 - t0, cuda_init_s=time.perf_counter() - t1)))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the start-up probe failed: {proc.stderr[-2000:]}")
    return dict(json.loads(proc.stdout.splitlines()[-1]), process_s=wall)


def phase_cli(card: str) -> dict:
    """The CLI on the reference's on-disk format at the full bench
    configuration: the 8 views of `phase_reconstruct` written as PNG with
    an OpenCV-YAML config (camID int32 rows, PyrmNum 4 from 160x240) and
    calibration; `load_run_config` gives back the written arrays bit for
    bit; `python3 -m reconstruction_tpu_torch config.yml` in a subprocess
    writes the PLY that an in-process `reconstruct` of the same config
    writes, byte for byte.  The subprocess's wall is split by its log's
    time stamps and its `Timer` report, beside the parts measured alone."""
    from reconstruction_tpu_torch.config import preset
    from reconstruction_tpu_torch.io.images import imwrite
    from reconstruction_tpu_torch.io.ply import write_ply
    from reconstruction_tpu_torch.io.opencv_yaml import save_opencv_yaml
    from reconstruction_tpu_torch.pipeline.reconstruct import load_run_config, reconstruct
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse

    root = os.path.abspath(os.path.join(SCRATCH, "cli"))
    os.makedirs(root, exist_ok=True)
    size = preset("myself").finest_size
    (cams, imgs, masks), render_s = timed(lambda: bench_scene(8, 42.0, size))
    t0 = time.perf_counter()
    for i in range(8):
        imwrite(os.path.join(root, f"view{i}.png"), imgs[i])
        imwrite(os.path.join(root, f"mask{i}.png"), masks[i])
    write_calib(root, cams)
    path = os.path.join(root, "config.yml")
    cli_ply, own_ply = os.path.join(root, "cli.ply"), os.path.join(root, "inprocess.ply")
    save_opencv_yaml(path, {
        "filepath": root, "outfilename": cli_ply, "isoutput": 0,
        "camera_calib_name": "calib_camera.yml", "PyrmNum": 4,
        "LowestLevelWidth": size[0] // 8, "LowestLevelHeight": size[1] // 8,
        "imagelist": [f"view{i}.png" for i in range(8)],
        "masklist": [f"mask{i}.png" for i in range(8)],
        "camID": np.asarray(BENCH_PAIRS, np.int32)})
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, pairs = load_run_config(path)
    load_s = time.perf_counter() - t0
    if not (cfg.cam_pairs == BENCH_PAIRS and cfg.pyramid_levels == 4
            and cfg.finest_size == size and cfg.outfilename == cli_ply):
        raise AssertionError(f"load_run_config read another config: {cfg}")
    for (a, b), p in zip(BENCH_PAIRS, pairs):
        for got, want in ((p.image0, imgs[a]), (p.image1, imgs[b]), (p.mask0, masks[a]),
                          (p.mask1, masks[b]), (p.K0, np.asarray(cams[a].K, np.float64)),
                          (p.Rt0, np.asarray(cams[a].Rt, np.float64)),
                          (p.K1, np.asarray(cams[b].K, np.float64)),
                          (p.Rt1, np.asarray(cams[b].Rt, np.float64))):
            if not (got.dtype == want.dtype and np.array_equal(got, want)):
                raise AssertionError("load_run_config does not give back the written arrays")
    log(f"cli scene: 8 views {size[0]}x{size[1]} rendered in {render_s:.2f} s, written "
        f"as PNG and OpenCV YAML in {write_s:.2f} s, read back bit for bit by "
        f"load_run_config in {load_s:.2f} s")

    t_launch, t0 = time.time(), time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "reconstruction_tpu_torch", path],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    sub_s = time.perf_counter() - t0
    log(f"python3 -m reconstruction_tpu_torch config.yml: exit {proc.returncode} in "
        f"{sub_s:.2f} s wall ({card}); its report:\n"
        + "\n".join("  " + line for line in proc.stdout.splitlines()))
    if proc.returncode != 0 or "total time:" not in proc.stdout \
            or "poisson" not in proc.stdout:
        raise AssertionError(f"the CLI failed: {proc.stderr[-3000:]}")
    report = dict(line.rsplit(None, 1) for line in proc.stdout.splitlines()
                  if line.endswith("s") and not line.startswith("total time"))
    wall = dict(subprocess_s=sub_s, first_pair_s=log_seconds(proc.stderr, t_launch, "pair 1/"),
                wrote_s=log_seconds(proc.stderr, t_launch, "INFO wrote "),
                spans_s=float(report["total"][:-1]),
                main_s=float(proc.stdout.split("total time:")[1].split()[0]))
    wall["between_spans_s"] = wall["wrote_s"] - wall["first_pair_s"] - wall["spans_s"]
    wall["after_write_s"] = sub_s - wall["wrote_s"]
    wall.update(startup_seconds())

    rec, own_s, launches = counted(lambda: reconstruct(cfg, pairs, output_path=own_ply,
                                                       device="cuda"))
    with open(cli_ply, "rb") as f:
        cli_bytes = f.read()
    with open(own_ply, "rb") as f:
        own_bytes = f.read()
    same_bytes = cli_bytes == own_bytes
    _, wall["write_ply_s"] = timed(lambda: write_ply(
        os.path.join(root, "again.ply"), rec.vertices, colors=rec.colors, faces=rec.faces,
        color_order="bgr"))
    wall["load_run_config_s"] = load_s
    log("cli wall, split (seconds after launch from its log's stamps; the parts alone "
        f"in brackets): first pair's log line at {wall['first_pair_s']:.2f} [a fresh "
        f"process importing torch and the package {wall['process_s'] - wall['cuda_init_s']:.2f}"
        f", of it the imports {wall['import_s']:.2f}; the card's first context "
        f"{wall['cuda_init_s']:.2f}; load_run_config {load_s:.2f}]; Timer spans "
        f"{wall['spans_s']:.2f}; between and after the spans up to the PLY's log line "
        f"{wall['between_spans_s']:.2f} [write_ply {wall['write_ply_s']:.2f}]; report and "
        f"exit {wall['after_write_s']:.2f}; main's own total {wall['main_s']:.2f} of "
        f"{sub_s:.2f} ({card})")
    rmse = point_to_surface_rmse(np.asarray(rec.vertices))
    spans = {k: round(v, 4) for k, v in rec.timer.spans.items()}
    log(f"cli vs in-process reconstruct: PLY bytes equal={same_bytes} "
        f"({len(cli_bytes)} and {len(own_bytes)} bytes); mesh {len(rec.vertices)} "
        f"vertices / {len(rec.faces)} faces, "
        f"interior RMSE {rmse:.6f} (recorded: the myself preset's mls_radius 2.5 is "
        f"not the bench's), in-process {own_s:.2f} s wall, K1/K3/K2/K6/K7 launches "
        f"{_launch_line(launches)} ({card}); stage seconds {spans}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the CLI's reconstruct")
    if not (same_bytes and np.isfinite(rec.vertices).all() and len(rec.faces) > 0):
        raise AssertionError("the CLI's PLY differs from the in-process reconstruct's")
    return dict(render_s=render_s, write_s=write_s, load_s=load_s, subprocess_s=sub_s,
                cli_wall=wall,
                inprocess_s=own_s, same_bytes=same_bytes,
                verts=int(len(rec.vertices)), faces=int(len(rec.faces)), rmse=rmse,
                launches=launches, spans=spans, cli_stdout=proc.stdout)


def vcycle_inputs(R: int, dev):
    """The multigrid's right-hand side (two opposite point charges) and a
    nonuniform screen at R^3 (tests/test_parallel.py:216-252 at scale)."""
    import torch
    rng = np.random.default_rng(11)
    f = np.zeros((R, R, R), np.float32)
    f[R // 4, R // 4, R // 4] = 1.0
    f[3 * R // 4, 5 * R // 8, R // 2] = -1.0
    screen = (0.1 * rng.uniform(size=(R, R, R))).astype(np.float32)
    return torch.from_numpy(f).to(dev), torch.from_numpy(screen).to(dev)


def dense_vcycle(f, screen, levels: int, cycles: int):
    import torch
    from reconstruction_tpu_torch.surface.poisson import _vcycle
    x = torch.zeros_like(f)
    for _ in range(cycles):
        x = _vcycle(x, f, screen, levels, 2, 2)
    return x


PARALLEL_RANKS = 4
VCYCLE = dict(R=256, levels=3, cycles=8)
SPLAT_R = 256
# One GN step at the ba_schur size: the default damping leaves the scale
# gauge undamped, so the step along it is rounding noise (phase_parallel);
# at 100 it is damped and the step is the same under any summation order.
BA_DAMPINGS = (1e-3, 100.0)


def _ba_judge(prob, Rt_true, single, sharded) -> dict:
    """tests/test_parallel.py:72-108's criteria for a sharded GN step
    (poses, points, cost) against the single-device one: the assembled
    cost within rtol 1e-5, both post-step costs below 0.01x of it and
    within 5x of each other, and the points equal within 5e-3 after the
    scale about camera 0's center."""
    import importlib
    import torch
    tb = importlib.import_module("reconstruction_tpu_torch.ba.bundle_adjust")
    (p1, x1, c1), (p2, x2, c2) = single, sharded
    dev = prob.points0.device
    as_t = lambda a: torch.as_tensor(a, device=dev)
    after1 = float(tb.ba_cost(prob, as_t(p1), as_t(x1), 16))
    after2 = float(tb.ba_cost(prob, as_t(p2), as_t(x2), 16))
    R0, t0 = Rt_true[0][:, :3], Rt_true[0][:, 3]
    C0 = -R0.T @ t0
    a, b = np.asarray(x2, np.float64) - C0, np.asarray(x1, np.float64) - C0
    s = float((a * b).sum() / max(float((a * a).sum()), 1e-12))
    err = float(np.abs(C0 + s * a - np.asarray(x1)).max())
    c1, c2 = float(c1), float(c2)
    return dict(cost=c2, ref_cost=c1, cost_ok=abs(c2 - c1) <= 1e-5 * abs(c1),
                after=after2, ref_after=after1, scale=s, aligned_err=err,
                ok=(abs(c2 - c1) <= 1e-5 * abs(c1) and after1 < 0.01 * c1
                    and after2 < 0.01 * c2 and after1 / after2 < 5.0
                    and after2 / after1 < 5.0 and abs(s - 1.0) < 0.05 and err <= 5e-3))


def splat_terms(clouds, box, dev, zeros: bool = False):
    """The valid points of the pairs' clouds as `distributed_splat` takes
    them, each normal pointing to its pair's camera: (grid coordinates,
    weights, values (normal, 1)).  ``zeros``: every point, the invalid
    ones with weight 0."""
    import torch
    gp, w, vals = [], [], []
    for c, cam in clouds:
        keep = c.valid.to(dev)
        if zeros:
            w.append(keep.float())
            keep = torch.ones_like(keep)
        xyz = c.xyz.to(dev)
        cam = torch.as_tensor(np.asarray(cam, np.float32), device=dev)
        nrm = cam - xyz
        nrm = nrm / nrm.norm(dim=1, keepdim=True).clamp_min(1e-12)
        gp.append((xyz[keep] - torch.as_tensor(box["origin"], device=dev))
                  / torch.as_tensor(box["spacing"], device=dev))
        if not zeros:
            w.append(torch.ones(int(keep.sum()), device=dev))
        vals.append(torch.cat([nrm[keep], torch.ones_like(w[-1])[:, None]], 1))
    return torch.cat(gp), torch.cat(w), torch.cat(vals)


def splat_bound(gp, w, vals, R: int, extra: int):
    """Per voxel and channel, 2 * gamma_(n + extra) * sum |term|: the most
    two float32 sums of the same n terms (the voxel's trilinear splat
    terms, `surface/poisson._splat3`) can differ, whatever their orders
    and trees (gamma_k = k u / (1 - k u), u = 2^-24); ``extra`` terms for
    the partial sums a sharded run adds."""
    import torch
    from reconstruction_tpu_torch.surface.poisson import _splat3
    absum = _splat3(torch.zeros((R, R, R, vals.shape[1]), device=gp.device), gp, w.abs(),
                    vals.abs())
    i0 = torch.floor(gp)
    f = gp - i0
    i0 = i0.long()
    count = torch.zeros(R ** 3, dtype=torch.int64, device=gp.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ii = (i0 + torch.tensor([dx, dy, dz], device=gp.device)).clamp(0, R - 1)
                wq = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                      * (f[:, 2] if dz else 1 - f[:, 2])) * w
                flat = (ii[:, 0] * R + ii[:, 1]) * R + ii[:, 2]
                count += torch.bincount(flat[wq != 0], minlength=R ** 3)
    ku = (count.reshape(R, R, R, 1).double() + extra) * 2.0 ** -24
    return (2.0 * ku / (1.0 - ku) * absum.double()).float()


class CommClock:
    """Host seconds inside the `torch.distributed` calls that `parallel/mesh`
    makes, the card synchronized before and after each.  The layer counts
    its collectives' calls and bytes (`COMM`) and never synchronizes, so
    while this is entered the smoke wraps those four functions in timed
    ones and puts them back on leaving; what the calls do is unchanged."""

    NAMES = ("all_reduce", "all_gather", "broadcast_object_list", "all_gather_object")

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        import torch
        import torch.distributed as dist
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def synced(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    self.seconds += time.perf_counter() - t0
            return call

        for n, fn in self.saved.items():
            setattr(dist, n, synced(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self.saved.items():
            setattr(dist, n, fn)
        return False


def parallel_rank(cfg, views, masks_u8, cams_K, cams_Rt, refine_in, splat_box) -> dict:
    """One of four gloo ranks on cuda:0 (`phase_parallel` (b)): a probe of
    the layer's collectives on CUDA tensors, then `match_pairs_sharded`
    over the bench's 4 pairs (one a rank), `refine_tiled` on 4 tiles,
    `ba_step_sharded` on 4 point blocks at the ba_schur size,
    `distributed_splat` of each rank's pair cloud at grid 256 and
    `poisson_vcycle_sharded` on 4 z blocks at 256^3.  Returns digests of
    what every rank holds, rank 0's arrays for the tolerance checks, and
    the rank's wall, collective seconds and peak device memory."""
    import torch
    import torch.distributed as dist
    from reconstruction_tpu_torch.bench import ba_problem
    from reconstruction_tpu_torch.ops import ba_coupling as K4
    from reconstruction_tpu_torch.parallel.distributed_ba import ba_step_sharded
    from reconstruction_tpu_torch.parallel.dryrun import dryrun
    from reconstruction_tpu_torch.parallel.fusion import distributed_splat
    from reconstruction_tpu_torch.parallel.mesh import COMM, all_reduce_sum, axis_rank, make_mesh
    from reconstruction_tpu_torch.parallel.poisson_sharded import poisson_vcycle_sharded
    from reconstruction_tpu_torch.parallel.production import match_pairs_sharded
    from reconstruction_tpu_torch.parallel.sharded import refine_tiled
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
    from reconstruction_tpu_torch.stereo.margins import Margins
    from reconstruction_tpu_torch.surface.poisson import _splat3
    from reconstruction_tpu_torch.utils.timing import Timer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = dict(rank=rank, device=str(dev), backend=dist.get_backend())

    # The layer's four collectives on CUDA tensors (and host objects).
    probe = {}
    x = torch.full((4,), float(rank + 1), device=dev)
    for name, op in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(
                dist.get_world_size())], x)),
            ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
            ("all_gather_object", lambda: dist.all_gather_object(
                [None] * dist.get_world_size(), {"rank": rank}))):
        try:
            op()
            torch.cuda.synchronize()
            probe[name] = "ok"
        except Exception as e:  # noqa: BLE001 - reported, then the run fails
            probe[name] = f"{type(e).__name__}: {e}"[:300]
    out["probe"] = probe
    if any(v != "ok" for v in probe.values()):
        return out

    pmesh = make_mesh(frame=1, pair=PARALLEL_RANKS, tile=1, device="cuda")
    tmesh = make_mesh(frame=1, pair=1, tile=PARALLEL_RANKS, device="cuda")
    views = [v.astype(np.float32) for v in views]
    masks = [m.astype(np.float32) for m in masks_u8]
    pairs = [PairInput(image0=views[a], image1=views[b], mask0=masks[a], mask1=masks[b],
                       K0=cams_K[a], Rt0=cams_Rt[a], K1=cams_K[b], Rt1=cams_Rt[b])
             for a, b in cfg.cam_pairs]
    steps, launches, comm, seconds = {}, {}, {}, {}

    def step(name, fn):
        K4.ba_coupling.launches = 0
        COMM.reset()
        with CommClock() as clock:
            res, seconds[name], n = counted(fn)
        launches[name] = dict(n, ba_coupling=K4.ba_coupling.launches)
        comm[name] = dict(COMM.as_dict(), seconds=clock.seconds)
        return res

    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    split = Timer(dev)
    rs = step("match_pairs_sharded", lambda: match_pairs_sharded(cfg, pairs, pmesh, timer=split))
    out["pairs"] = [pair_digests(r) for r in rs]
    out["pairs_split_s"] = dict(split.spans)

    disp = torch.from_numpy(refine_in["disp"]).to(dev)
    L = torch.from_numpy(refine_in["L"].astype(np.float32)).to(dev)
    R = torch.from_numpy(refine_in["R"].astype(np.float32)).to(dev)
    m = Margins(*[torch.tensor(v, dtype=torch.int32, device=dev) for v in refine_in["m"]])
    got = step("refine_tiled", lambda: refine_tiled(
        tmesh, disp, L, R, m, refine_in["iterations"], refine_in["ws"],
        s_cap=refine_in["s_cap"], band=refine_in["band"]))
    out["refine"] = digest(got)

    prob, _, _ = ba_problem(device=dev)
    out["ba"] = {}
    for damping in BA_DAMPINGS:
        poses, points, cost = step(f"ba_step_sharded@{damping:g}", lambda: ba_step_sharded(
            pmesh, prob, torch.zeros((16, 6), device=dev), prob.points0, 16, damping=damping))
        out["ba"][damping] = dict(digest=digest(points), cost=float(cost))
        if rank == 0:
            out["ba"][damping].update(poses=poses.cpu().numpy(), points=points.cpu().numpy())

    mine = rs[axis_rank(pmesh, "pair")]
    xyz = mine.cloud.xyz.to(dev)
    cam = torch.as_tensor(np.asarray(mine.rectification.T_final, np.float32), device=dev)
    nrm = cam - xyz
    nrm = nrm / nrm.norm(dim=1, keepdim=True).clamp_min(1e-12)
    origin = torch.as_tensor(splat_box["origin"], device=dev)
    spacing = torch.as_tensor(splat_box["spacing"], device=dev)
    V, D = step("distributed_splat", lambda: distributed_splat(
        pmesh, xyz, nrm, mine.cloud.valid.to(dev), origin, spacing, splat_box["R"]))
    out["splat"] = dict(digest=digest(torch.cat([V, D[..., None]], -1)))
    if rank == 0:
        out["splat"].update(V=V.cpu().numpy(), D=D.cpu().numpy())
    # Uncounted: this rank's splat with its points of weight 0 left in
    # (`distributed_splat` leaves them out; they add exact zeros), against
    # the splat of its weighted points alone, and the four ranks' sum of it.
    Rs = splat_box["R"]
    wz = mine.cloud.valid.to(dev).float()
    keep = wz != 0
    gpz = (xyz - origin) / spacing
    valsz = torch.cat([nrm, torch.ones_like(wz)[:, None]], 1)
    alone = _splat3(torch.zeros((Rs,) * 3 + (4,), device=dev), gpz[keep], wz[keep], valsz[keep])
    zeros = _splat3(torch.zeros((Rs,) * 3 + (4,), device=dev), gpz, wz, valsz)
    out["splat_zeros"] = dict(points=int(keep.sum()), zero_points=int((~keep).sum()),
                              local_equal=bool(torch.equal(alone, zeros)),
                              local_max_diff=float((alone - zeros).abs().max()))
    del alone
    all_reduce_sum(zeros, pmesh.get_group("pair"))
    if rank == 0:
        out["splat_zeros"]["grid"] = zeros.cpu().numpy()
    del zeros

    f, screen = vcycle_inputs(VCYCLE["R"], dev)
    chi = step("poisson_vcycle_sharded", lambda: poisson_vcycle_sharded(
        tmesh, f, screen, levels=VCYCLE["levels"], cycles=VCYCLE["cycles"]))
    out["vcycle"] = dict(digest=digest(chi))
    if rank == 0:
        out["vcycle"]["chi"] = chi.cpu().numpy()
    out["dryrun"] = step("dryrun", lambda: dryrun("cuda"))

    out.update(wall_s=time.perf_counter() - t_all, seconds=seconds, launches=launches,
               comm=comm, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


def phase_parallel(card: str, seq=None, scene=None) -> dict:
    """The multi-device layer (`parallel/`) on the card, at the bench
    configuration (``scene`` and ``seq``: `phase_reconstruct`'s views and
    its sequential run of them; made here when the phase runs alone).
    (a) One rank over NCCL in this process: `reconstruct(mesh=...)` equal
        to the sequential run (vertices, faces, colors), `ba_step_sharded`
        at 16 cams / 65,536 points / 8 obs equal to `ba_step`,
        `refine_tiled` at 1280x1920 with 120 sweeps equal to
        `disparity_refine(recenter_every=0)`, `poisson_vcycle_sharded` at
        256^3 (levels 3, cycles 8) equal to the dense `_vcycle`, all bit
        for bit.
    (b) Four gloo ranks on cuda:0 (`parallel_rank`): the pairs bit-equal to
        the sequential `match_pair`s, with K1/K3/K2 launched on every rank;
        the tile refine bit-equal; BA within the JAX package's criteria
        with K4 on every rank; the splat within 1e-4 and the multigrid
        within 1e-6 of their single-device versions.
    (c) `python3 -m reconstruction_tpu_torch config.yml --sharded` on
        `phase_cli`'s scene: its PLY equals the unsharded CLI's byte for
        byte."""
    import importlib
    import torch
    import torch.distributed as dist
    import chip_smoke
    from reconstruction_tpu_torch.bench import ba_problem
    from reconstruction_tpu_torch.parallel.distributed_ba import ba_step_sharded
    from reconstruction_tpu_torch.parallel.dryrun import dryrun
    from reconstruction_tpu_torch.parallel.launch import run_local
    from reconstruction_tpu_torch.parallel.mesh import COMM, make_mesh
    from reconstruction_tpu_torch.parallel.multihost import initialize_distributed
    from reconstruction_tpu_torch.parallel.poisson_sharded import poisson_vcycle_sharded
    from reconstruction_tpu_torch.parallel.sharded import refine_tiled
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput, reconstruct
    from reconstruction_tpu_torch.stereo.refine import disparity_refine
    from reconstruction_tpu_torch.surface.poisson import _splat3
    tb = importlib.import_module("reconstruction_tpu_torch.ba.bundle_adjust")

    dev = torch.device("cuda")
    cfg = bench_config()
    cams, imgs, masks = scene or bench_scene(8, 42.0, cfg.finest_size)
    pairs = [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                       K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                       K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
             for a, b in cfg.cam_pairs]
    if seq is None:
        seq = reconstruct(cfg, pairs, device="cuda")
    res0 = seq.pair_results[0]
    refine_in = dict(disp=res0.disparity.cpu().numpy(), L=res0.rect_images[0].cpu().numpy(),
                     R=res0.rect_images[1].cpu().numpy(),
                     m=[int(v) for v in res0.margins0], ws=cfg.stereo.refine_ws,
                     iterations=cfg.refine_iterations(cfg.pyramid_levels - 1),
                     s_cap=128, band=64)
    out = {}

    # (a) one rank over NCCL
    initialize_distributed(device="cuda")
    try:
        mesh = make_mesh(frame=1, pair=1, tile=1, device="cuda")
        log(f"parallel (a): one rank, backend {dist.get_backend()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
        COMM.reset()
        torch.cuda.reset_peak_memory_stats()
        rec, wall, launches = counted(lambda: reconstruct(cfg, pairs, mesh=mesh, device="cuda"))
        same = (np.array_equal(rec.vertices, seq.vertices)
                and np.array_equal(rec.faces, seq.faces)
                and np.array_equal(rec.colors, seq.colors))
        split = next(r for r in rec.stats.records if r["stage"] == "stereo_sharded")
        a = dict(reconstruct=dict(wall_s=wall, equal=same, launches=launches,
                                  spans={k: round(v, 4) for k, v in rec.timer.spans.items()},
                                  split=split, comm=COMM.as_dict(),
                                  peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30))
        log(f"parallel (a) reconstruct(mesh=...): {wall:.2f} s wall ({card}); equal to the "
            f"sequential run (vertices, faces, colors)={same}; spans {a['reconstruct']['spans']}; "
            f"local/gather {split}; collectives {COMM.as_dict()}; launches {launches}; peak "
            f"{a['reconstruct']['peak_mem_gb']:.2f} GiB")
        if not (same and "stereo_sharded" in rec.timer.spans
                and all(n > 0 for n in launches.values())):
            raise AssertionError("reconstruct(mesh=...) on one rank differs from reconstruct")
        del rec

        prob, Rt_true, pts_true = ba_problem(device=dev)
        zeros = torch.zeros((16, 6), device=dev)
        p1, x1, c1 = tb.ba_step(prob, zeros, prob.points0, 16)
        (p2, x2, c2), ba_s = timed(lambda: ba_step_sharded(mesh, prob, zeros, prob.points0, 16))
        ba_eq = torch.equal(p1, p2) and torch.equal(x1, x2) and torch.equal(c1, c2)

        disp = torch.from_numpy(refine_in["disp"]).to(dev)
        L, R = (torch.from_numpy(refine_in[k].astype(np.float32)).to(dev) for k in ("L", "R"))
        m = res0.margins0
        it = refine_in["iterations"]
        ref_refine, ref_s = timed(lambda: disparity_refine(
            disp, L, R, m, it, refine_in["ws"], s_cap=128, band=64, recenter_every=0))
        got, tiled_s = timed(lambda: refine_tiled(mesh, disp, L, R, m, it, refine_in["ws"],
                                                   s_cap=128, band=64))
        refine_eq = torch.equal(got, ref_refine)

        f, screen = vcycle_inputs(VCYCLE["R"], dev)
        chi_ref, dense_s = timed(lambda: dense_vcycle(f, screen, VCYCLE["levels"],
                                                       VCYCLE["cycles"]))
        chi, vc_s = timed(lambda: poisson_vcycle_sharded(
            mesh, f, screen, levels=VCYCLE["levels"], cycles=VCYCLE["cycles"]))
        vc_eq = torch.equal(chi, chi_ref)
        a.update(ba=dict(equal=ba_eq, cost=float(c1), sharded_s=ba_s),
                 refine=dict(equal=refine_eq, sweeps=it, tiled_s=tiled_s, unsharded_s=ref_s),
                 vcycle=dict(equal=vc_eq, sharded_s=vc_s, dense_s=dense_s))
        log(f"parallel (a) one NCCL rank, bit for bit: ba_step_sharded == ba_step {ba_eq} "
            f"({ba_s * 1e3:.1f} ms); refine_tiled == disparity_refine(recenter_every=0) at "
            f"{L.shape[0]}x{L.shape[1]}, {it} sweeps {refine_eq} ({tiled_s * 1e3:.1f} against "
            f"{ref_s * 1e3:.1f} ms); poisson_vcycle_sharded == _vcycle at {VCYCLE} {vc_eq} "
            f"({vc_s:.3f} against {dense_s:.3f} s) ({card})")
        if not (ba_eq and refine_eq and vc_eq):
            raise AssertionError("a sharded function on one rank differs from its "
                                 "single-device counterpart")
        dry, dry_s = timed(lambda: dryrun("cuda"))
        log(f"parallel (a) dryrun over one rank in {dry_s:.2f} s: {dry}")
        a["dryrun"] = dict(dry, seconds=dry_s)
        ba_single = {d: tuple(v.cpu().numpy() if torch.is_tensor(v) and v.dim() else float(v)
                              for v in tb.ba_step(prob, zeros, prob.points0, 16, damping=d))
                     for d in BA_DAMPINGS}
        # The same single-device step over the points in other orders (a
        # pure reassociation of its sums), at the default damping.
        ba_perm = []
        for seed in range(1, 5):
            perm = torch.randperm(prob.points0.shape[0],
                                  generator=torch.Generator().manual_seed(seed)).to(dev)
            pprob = tb.BAProblem(prob.K, prob.Rt0, *[t[perm] for t in prob[2:]])
            pp, xp, cp = tb.ba_step(pprob, zeros, pprob.points0, 16)
            xs = torch.empty_like(xp)
            xs[perm] = xp
            ba_perm.append(_ba_judge(prob, Rt_true, ba_single[BA_DAMPINGS[0]],
                                     (pp.cpu().numpy(), xs.cpu().numpy(), float(cp))))
        out["a"] = a
    finally:
        dist.destroy_process_group()

    # (b) four gloo ranks on cuda:0
    clouds = [r.cloud for r in seq.pair_results]
    allv = torch.cat([c.valid for c in clouds])
    allx = torch.cat([c.xyz for c in clouds])
    lo = allx[allv].amin(0) - 0.05
    hi = allx[allv].amax(0) + 0.05
    box = dict(origin=lo.cpu().numpy(),
               spacing=np.float32(float((hi - lo).max()) / (SPLAT_R - 1)), R=SPLAT_R)
    views_u8 = [im.astype(np.uint8) for im in imgs]
    masks_u8 = [mk.astype(np.uint8) for mk in masks]
    if not all(np.array_equal(u.astype(np.float32), v) for u, v in zip(views_u8 + masks_u8,
                                                                      imgs + masks)):
        raise AssertionError("the bench views do not round-trip through uint8")
    (ranks, world_s) = timed(lambda: run_local(
        chip_smoke.parallel_rank, PARALLEL_RANKS, "cuda", cfg, views_u8, masks_u8,
        [np.asarray(c.K) for c in cams], [np.asarray(c.Rt) for c in cams], refine_in, box,
        backend="gloo", timeout=900))
    for r in ranks:
        log(f"parallel (b) rank {r['rank']} on {r['device']} ({r['backend']}): probe "
            f"{r['probe']}")
    if any(v != "ok" for r in ranks for v in r["probe"].values()):
        raise AssertionError("a collective refused CUDA tensors on gloo")
    want = [pair_digests(r) for r in seq.pair_results]
    pairs_eq = all(r["pairs"] == want for r in ranks)
    refine_eq = all(r["refine"] == digest(ref_refine) for r in ranks)
    same_ba = all(len({r["ba"][d]["digest"] for r in ranks}) == 1 for d in BA_DAMPINGS)
    same_splat = len({r["splat"]["digest"] for r in ranks}) == 1
    same_chi = len({r["vcycle"]["digest"] for r in ranks}) == 1
    r0 = ranks[0]

    # BA: the JAX package's criteria (tests/test_parallel.py:72-108) at
    # both dampings; at the default one only the assembled cost is held
    # (the step along the free scale gauge is rounding noise there: the
    # single-device step over permuted points, `ba_perm`, shows it).
    ba = {d: _ba_judge(prob, Rt_true, ba_single[d],
                       (r0["ba"][d]["poses"], r0["ba"][d]["points"], r0["ba"][d]["cost"]))
          for d in BA_DAMPINGS}
    ba_ok = ba[BA_DAMPINGS[0]]["cost_ok"] and ba[BA_DAMPINGS[1]]["ok"]

    # Splat: the single-device splat of the four pairs' clouds, and the
    # float32 bound on two orders of the same sums.
    gp, w, vals = splat_terms([(r.cloud, r.rectification.T_final) for r in seq.pair_results],
                              box, dev)
    grid, splat_s = timed(lambda: _splat3(torch.zeros((SPLAT_R,) * 3 + (4,), device=dev),
                                           gp, w, vals))
    bnd = splat_bound(gp, w, vals, SPLAT_R, PARALLEL_RANKS)
    got = torch.cat([torch.from_numpy(r0["splat"]["V"]), torch.from_numpy(r0["splat"]["D"])[..., None]],
                    -1).to(dev)
    diff = (got - grid).abs()
    splat = dict(max_err=float(diff.max()), max_abs=float(grid.abs().max()),
                 max_err_over_bound=float((diff / bnd.clamp_min(1e-30)).max()),
                 within_bound=bool((diff <= bnd).all()), jax_atol_1e4=bool(diff.max() <= 1e-4),
                 points=int(len(w)), single_device_s=splat_s)
    # Not gated: the same comparison for the four ranks' splat with their
    # points of weight 0 left in, and the one-device splat of all the
    # pairs' points, weight 0 included, against that of the weighted ones.
    zs = [r["splat_zeros"] for r in ranks]
    gz = torch.from_numpy(r0["splat_zeros"].pop("grid")).to(dev)
    dz = (gz - grid).abs()
    gp0, w0, vals0 = splat_terms([(r.cloud, r.rectification.T_final)
                                  for r in seq.pair_results], box, dev, zeros=True)
    one = _splat3(torch.zeros((SPLAT_R,) * 3 + (4,), device=dev), gp0, w0, vals0)
    splat["zeros_kept"] = dict(
        per_rank=[{k: v for k, v in z.items() if k != "grid"} for z in zs],
        four_rank_max_err=float(dz.max()),
        four_rank_max_err_over_bound=float((dz / bnd.clamp_min(1e-30)).max()),
        one_device_equal=bool(torch.equal(one, grid)),
        one_device_max_diff=float((one - grid).abs().max()), one_device_points=int(len(w0)))
    del gz, dz, gp0, w0, vals0, one
    splat_err = splat["max_err"]
    del grid, bnd, got, diff
    chi_err = float(np.abs(r0["vcycle"]["chi"] - chi_ref.cpu().numpy()).max())
    per_rank = [dict(rank=r["rank"], wall_s=r["wall_s"], seconds=r["seconds"], comm=r["comm"],
                     launches=r["launches"], peak_mem_gb=r["peak_mem_gb"],
                     pairs_split_s=r["pairs_split_s"]) for r in ranks]
    for r in per_rank:
        log(f"parallel (b) rank {r['rank']}: wall {r['wall_s']:.2f} s, by step "
            f"{ {k: round(v, 3) for k, v in r['seconds'].items()} }, match_pairs_sharded "
            f"local/gather {r['pairs_split_s']}, collectives "
            f"{ {k: (v['calls'], round(v['seconds'], 3), v['bytes']) for k, v in r['comm'].items()} }"
            f", peak {r['peak_mem_gb']:.2f} GiB, launches {r['launches']} ({card})")
    dry = [r["dryrun"] for r in ranks]
    dry_ok = (all(d == dry[0] for d in dry) and dry[0]["mesh"] == dict(pair=2, tile=2)
              and dry[0]["production_verts"] > 0 and dry[0]["chi_finite"])
    log(f"parallel (b) dryrun over the four ranks (pair 2 x tile 2, then 4 z tiles): every "
        f"rank the same summary {all(d == dry[0] for d in dry)}: {dry[0]}")
    path_ok = all(r["launches"]["match_pairs_sharded"][k] > 0 for r in per_rank
                  for k in ("ncc_sweep", "cost_volume", "refine_sweeps_fused"))
    k4_ok = all(r["launches"][f"ba_step_sharded@{d:g}"]["ba_coupling"] > 0 for r in per_rank
                for d in BA_DAMPINGS)
    refine_k2 = all(r["launches"]["refine_tiled"]["refine_sweeps_fused"] > 0
                    and r["launches"]["refine_tiled"]["cost_volume"] > 0 for r in per_rank)
    fmt = lambda j: (f"cost {j['cost']:.7g} against {j['ref_cost']:.7g}, after {j['after']:.5g} "
                     f"against {j['ref_after']:.5g}, scale {j['scale']:.4f}, aligned point "
                     f"error {j['aligned_err']:.3g}, JAX criteria {j['ok']}")
    log(f"parallel (b) BA one GN step at 16 cams / 65,536 points / 8 obs, pair 4 against "
        f"ba_step: damping {BA_DAMPINGS[0]:g}: {fmt(ba[BA_DAMPINGS[0]])}; the single-device "
        f"step over the points in 4 other orders: after "
        f"{[round(j['after'], 1) for j in ba_perm]}, JAX criteria {[j['ok'] for j in ba_perm]}; "
        f"damping {BA_DAMPINGS[1]:g}: {fmt(ba[BA_DAMPINGS[1]])}")
    log(f"parallel (b) splat of {splat['points']} points at {SPLAT_R}^3 (one device, one "
        f"process: {splat_s:.3f} s): max |err| "
        f"{splat['max_err']:.3g} at values up to {splat['max_abs']:.4g}, at most "
        f"{splat['max_err_over_bound']:.3g} of the float32 reassociation bound, within it "
        f"{splat['within_bound']}; within the JAX test's atol 1e-4 {splat['jax_atol_1e4']}")
    zk = splat["zeros_kept"]
    log(f"parallel (b) splat with the points of weight 0 left in (not gated): per rank, "
        f"its own splat equal to that of its weighted points alone "
        f"{[z['local_equal'] for z in zk['per_rank']]} (max |diff| "
        f"{[z['local_max_diff'] for z in zk['per_rank']]}; weighted/zero points "
        f"{[(z['points'], z['zero_points']) for z in zk['per_rank']]}); the four ranks' sum "
        f"against the one-device splat: max |err| {zk['four_rank_max_err']:.3g}, "
        f"{zk['four_rank_max_err_over_bound']:.3g} of the bound; the one-device splat of all "
        f"{zk['one_device_points']} points equal to that of the weighted ones "
        f"{zk['one_device_equal']} (max |diff| {zk['one_device_max_diff']:.3g})")
    log(f"parallel (b) four gloo ranks on one card, {world_s:.1f} s for the world: pairs "
        f"bit-equal to match_pair on every rank {pairs_eq}; refine_tiled (tile 4) bit-equal "
        f"{refine_eq}; BA {ba_ok}; multigrid max |err| {chi_err:.3g} (<= 1e-6); every rank "
        f"the same BA/splat/chi {same_ba}/{same_splat}/{same_chi}; K1/K3/K2 on every rank "
        f"{path_ok}, K3/K2 in every tile {refine_k2}, K4 on every rank {k4_ok}")
    if not (pairs_eq and refine_eq and ba_ok and splat["jax_atol_1e4"] and dry_ok
            and splat["within_bound"] and chi_err <= 1e-6
            and same_ba and same_splat and same_chi and path_ok and k4_ok and refine_k2):
        raise AssertionError("the four-rank sharded run is outside its criteria")
    out["b"] = dict(world_s=world_s, pairs_equal=pairs_eq, refine_equal=refine_eq,
                    ba={f"{d:g}": v for d, v in ba.items()}, ba_permuted_single=ba_perm,
                    splat=splat, chi_err=chi_err, per_rank=per_rank, probe=ranks[0]["probe"],
                    dryrun=dry[0])

    # (c) the CLI with --sharded against the unsharded CLI's PLY
    root = os.path.abspath(os.path.join(SCRATCH, "cli"))
    cli_ply = os.path.join(root, "cli.ply")
    if not os.path.exists(cli_ply):
        phase_cli(card)
    from reconstruction_tpu_torch.io.opencv_yaml import load_opencv_yaml, save_opencv_yaml
    conf = load_opencv_yaml(os.path.join(root, "config.yml"))
    conf["outfilename"] = os.path.join(root, "sharded.ply")
    conf["camID"] = np.asarray(conf["camID"], np.int32)
    path = os.path.join(root, "config_sharded.yml")
    save_opencv_yaml(path, conf)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "reconstruction_tpu_torch", path, "--sharded"],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0 or "stereo_sharded" not in proc.stdout:
        raise AssertionError(f"the --sharded CLI failed: {proc.stderr[-3000:]}")
    with open(cli_ply, "rb") as fa, open(conf["outfilename"], "rb") as fb:
        cli_same = fa.read() == fb.read()
    log(f"parallel (c) python3 -m reconstruction_tpu_torch config.yml --sharded: exit 0 in "
        f"{sub_s:.2f} s ({card}); PLY bytes equal to the unsharded CLI's={cli_same}; its "
        f"report:\n" + "\n".join("  " + line for line in proc.stdout.splitlines()))
    if not cli_same:
        raise AssertionError("the --sharded CLI's PLY differs from the unsharded one")
    out["c"] = dict(subprocess_s=sub_s, same_bytes=cli_same, stdout=proc.stdout)
    return out


# The video's rig angle error, degrees, with closures and of the chain
# alone: above the largest this configuration gives on the card (1.478 and
# 0.806; the runs are deterministic), well under the 4.5 of no estimate.
VIDEO_ANGLE_LIMITS = (2.0, 1.0)


def phase_video(card: str) -> dict:
    """`reconstruct_video` at ROADMAP A9's size: 4 frames of 6 cameras in 3
    pairs at 1280x1920 (the bench configuration's preset), the rig orbiting
    1.5 degrees a frame, loop closures every 3 frames.  Then the pose chain
    without closures, and `_estimate_relative_pose` card against CPU on
    two 320x240 frames."""
    import torch
    from reconstruction_tpu_torch.pipeline import reconstruct as recon_mod
    from reconstruction_tpu_torch.pipeline import video
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse, render_view
    from reconstruction_tpu_torch.tools.demo_video import orbit_rig, pose_error_deg

    cfg = bench_config().replace(cam_pairs=((0, 1), (2, 3), (4, 5)))
    size = cfg.finest_size
    frames, render_s = {}, []

    def loader(i):
        if i not in frames:
            cams = orbit_rig(i, size, 6, 30.0)
            (views, s) = timed(lambda: [render_view(c, size, device="cuda") for c in cams])
            render_s.append(s)
            imgs, masks = quantized([v[0] for v in views], [v[1] for v in views])
            frames[i] = [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a],
                                   mask1=masks[b], K0=np.asarray(cams[a].K),
                                   Rt0=np.asarray(cams[a].Rt), K1=np.asarray(cams[b].K),
                                   Rt1=np.asarray(cams[b].Rt)) for a, b in cfg.cam_pairs]
        return frames[i]

    # The driver's default per-frame reconstruction, timed frame by frame.
    real, frame_s = recon_mod.reconstruct, []

    def timed_reconstruct(*a, **kw):
        out, s = timed(lambda: real(*a, **kw))
        frame_s.append(s)
        return out

    recon_mod.reconstruct = timed_reconstruct
    try:
        results, wall, launches = counted(lambda: video.reconstruct_video(
            cfg, loader, 4, depth_hint=8.0, loop_closure_stride=3, device="cuda"))
    finally:
        recon_mod.reconstruct = real

    class NoMesh:
        vertices = np.zeros((0, 3), np.float32)
        faces = np.zeros((0, 3), np.int32)

    chain = video.reconstruct_video(cfg, loader, 4, reconstruct_frame=lambda c, p: NoMesh(),
                                    depth_hint=8.0, device="cuda")
    err = [pose_error_deg(r.rig_pose, f) for f, r in enumerate(results)]
    err_chain = [pose_error_deg(r.rig_pose, f) for f, r in enumerate(chain)]
    rmse = [point_to_surface_rmse(np.asarray(r.mesh_vertices)) for r in results]
    verts = [int(len(r.mesh_vertices)) for r in results]
    log(f"video: 4 frames x 6 views {size[0]}x{size[1]}, {wall:.2f} s wall (render "
        f"{sum(render_s):.2f} s of it), per-frame reconstruct seconds "
        f"{[round(s, 3) for s in frame_s]} ({card}); K1/K3/K2/K6/K7 launches "
        f"{_launch_line(launches)}")
    log(f"video: mesh vertices {verts}, RMSE {[round(v, 6) for v in rmse]}; rig angle "
        f"error (degrees) with closures {[round(e, 4) for e in err]}, chain without "
        f"closures {[round(e, 4) for e in err_chain]} (gates {VIDEO_ANGLE_LIMITS}; no "
        "estimate: 4.5 at frame 3)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by reconstruct_video")
    if not (all(np.isfinite(r.mesh_vertices).all() and len(r.mesh_faces) > 0
                for r in results) and max(rmse) <= RMSE_LIMIT
            and max(err) <= VIDEO_ANGLE_LIMITS[0] and max(err_chain) <= VIDEO_ANGLE_LIMITS[1]):
        raise AssertionError("reconstruct_video outside its gates")

    # The pose estimate on two 320x240 frames, card against CPU.
    small = (320, 240)
    gray = []
    for f in (0, 1):
        cam = orbit_rig(f, small, 2, 24.0)[0]
        gray.append((render_view(cam, small)[0].mean(-1), cam))
    K, Rt = np.asarray(gray[0][1].K), np.asarray(gray[0][1].Rt)
    matches, real_match = {}, video.match_descriptors

    def keep_matches(*a, **kw):
        m = real_match(*a, **kw)
        matches[m.device.type] = m.cpu().numpy()
        return m

    video.match_descriptors = keep_matches
    try:
        T_gpu = video._estimate_relative_pose(gray[0][0], gray[1][0], K, Rt, 8.0, device="cuda")
        T_cpu = video._estimate_relative_pose(gray[0][0], gray[1][0], K, Rt, 8.0, device="cpu")
    finally:
        video.match_descriptors = real_match
    same = bool(np.array_equal(matches["cuda"], matches["cpu"]))
    dT = float(np.abs(T_gpu - T_cpu).max())
    log(f"relative pose 320x240, card vs CPU: matches equal={same} "
        f"({int((matches['cpu'] >= 0).sum())} matches), max |dT| {dT:.3g}")
    if not (same and dT <= 1e-4):
        raise AssertionError("the relative pose differs between card and CPU")
    torch.cuda.synchronize()
    return dict(wall_s=wall, render_s=render_s, frame_s=frame_s, launches=launches,
                verts=verts, rmse=rmse, angle_err=err, angle_err_chain=err_chain,
                small_matches_equal=same, small_dT=dT)


def phase_satellites(card: str) -> dict:
    """The CLI's other modes: `segment_frame` on a 1280x1920 frame and card
    against CPU at 240x320; `depth_to_points` at Kinect v2's 512x424 card
    against CPU; `run_batch` over a take of 10 cameras at 1280x1920 and two
    expressions; `cut_image_dir` on two cameras' frames."""
    import torch
    from reconstruction_tpu_torch.io.images import imwrite
    from reconstruction_tpu_torch.io.opencv_yaml import load_opencv_yaml
    from reconstruction_tpu_torch.io.ply import read_ply
    from reconstruction_tpu_torch.pipeline import batch, kinect, segmentation as seg

    out = {}
    rng = np.random.default_rng(5)

    def frame(H, W):
        """tests/test_pipeline_satellites.py's 64x80 frame, scaled to H x W."""
        bg = rng.uniform(80, 120, (H, W, 3)).astype(np.float32)
        img = bg.copy()
        ys, xs = H / 64, W / 80
        y0, y1, x0, x1 = int(20 * ys), int(44 * ys), int(30 * xs), int(54 * xs)
        img[y0:y1, x0:x1] = rng.uniform(180, 250, (y1 - y0, x1 - x0, 3))
        inside = (slice(int(26 * ys), int(38 * ys)), slice(int(36 * xs), int(48 * xs)))
        return img, bg, inside, (slice(None), slice(0, int(20 * xs)))

    img, bg, inside, outside = frame(1920, 1280)
    seg.segment_frame(img[:64, :80], bg[:64, :80], device="cuda")   # first CUDA use
    seg.flood_fill.readbacks = 0
    mask, s = timed(lambda: seg.segment_frame(img, bg, device="cuda"))
    fg_in, fg_out = float((mask[inside] > 0).mean()), float((mask[outside] > 0).mean())
    out["segment_full"] = dict(seconds=s, readbacks=seg.flood_fill.readbacks,
                               inside=fg_in, outside=fg_out)
    log(f"segment_frame 1280x1920 on the card: {s:.3f} s, {seg.flood_fill.readbacks} "
        f"flood_fill read-backs (checks every {seg.CHECK_EVERY} steps), foreground "
        f"{fg_in:.4f} inside, {fg_out:.4f} on the left strip ({card})")
    if not (fg_in > 0.8 and fg_out < 0.1):
        raise AssertionError("segment_frame misses the foreground at 1280x1920")

    img, bg, _, _ = frame(240, 320)
    m_gpu = seg.segment_frame(img, bg, device="cuda")
    m_cpu = seg.segment_frame(img, bg, device="cpu")
    same = bool(np.array_equal(m_gpu, m_cpu))
    out["segment_small_equal"] = same
    log(f"segment_frame 240x320 card vs CPU: equal={same}, foreground "
        f"{float((m_cpu > 0).mean()):.4f}")
    if not same:
        raise AssertionError("segment_frame differs between card and CPU")

    H, W = 424, 512
    depth = rng.integers(500, 4500, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0
    bgd = np.clip(depth + rng.integers(-300, 1500, (H, W)), 0, 8000).astype(np.float32)
    intr = np.float32([365.3, 365.1, 256.7, 212.2])
    bbox = np.float32([10, 500, 5, 420])
    res = {}
    for dev in ("cuda", "cpu"):
        pts, ok = kinect.depth_to_points(*(torch.as_tensor(a, device=dev)
                                           for a in (depth, bgd, intr, bbox)))
        res[dev] = (pts.cpu().numpy(), ok.cpu().numpy())
    ok_same = bool(np.array_equal(res["cuda"][1], res["cpu"][1]))
    a, b = res["cuda"][0], res["cpu"][0]
    ulps = int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())
    out["kinect"] = dict(valid_equal=ok_same, max_ulps=ulps, points=int(res["cpu"][1].sum()))
    log(f"depth_to_points 512x424 card vs CPU: validity equal={ok_same}, "
        f"{int(res['cpu'][1].sum())} points, largest difference {ulps} ulp")
    if not (ok_same and ulps <= 1):
        raise AssertionError("depth_to_points differs between card and CPU")

    # run_batch over one take: 10 cameras, both expressions, JPEG images and
    # masks under the reference's names.
    root = os.path.abspath(os.path.join(SCRATCH, "batch"))
    take, outdir = os.path.join(root, "take"), os.path.join(root, "out")
    os.makedirs(os.path.join(take, "mask"), exist_ok=True)
    size = bench_config().finest_size
    (cams, imgs, masks), render_s = timed(lambda: bench_scene(10, 54.0, size))
    t0 = time.perf_counter()
    for e in range(batch.EXPRESSION_NUM):
        for j in range(batch.CAMERA_NUM):
            name = f"{e + 1:04d}_Cam{j}.jpg"
            imwrite(os.path.join(take, name), imgs[j])
            imwrite(os.path.join(take, "mask", name), masks[j])
    write_calib(take, cams)
    with open(os.path.join(root, "path.txt"), "w") as f:
        f.write(f"{take} {outdir}\n")
    write_s = time.perf_counter() - t0
    for e in (1, 2):
        if os.path.exists(os.path.join(outdir, f"{e}.ply")):
            os.remove(os.path.join(outdir, f"{e}.ply"))
    _, batch_s, launches = counted(lambda: batch.run_batch(os.path.join(root, "path.txt"),
                                                           device="cuda"))
    meshes, configs_equal = [], True
    for e in range(batch.EXPRESSION_NUM):
        meshes.append(len(read_ply(os.path.join(outdir, f"{e + 1}.ply")).xyz))
        got = load_opencv_yaml(os.path.join(outdir, f"config_{e + 1}.yml"))
        want = batch.generate_take_config(take, outdir, e)
        configs_equal &= (
            got["filepath"] == want.filepath and got["outfilename"] == want.outfilename
            and bool(got["isoutput"]) == want.isoutput
            and got["camera_calib_name"] == want.camera_calib_name
            and got["PyrmNum"] == want.pyramid_levels
            and (got["LowestLevelWidth"], got["LowestLevelHeight"]) == want.lowest_level_size
            and tuple(got["imagelist"]) == want.imagelist
            and tuple(got["masklist"]) == want.masklist
            and tuple(tuple(int(v) for v in r) for r in got["camID"]) == want.cam_pairs)
    out["batch"] = dict(render_s=render_s, write_s=write_s, seconds=batch_s,
                        launches=launches, verts=meshes, configs_equal=configs_equal)
    log(f"run_batch: 1 take x 2 expressions, 10 views {size[0]}x{size[1]} (JPEG, "
        f"written in {write_s:.2f} s): {batch_s:.2f} s wall ({card}), meshes {meshes} vertices, "
        f"config_1/2.yml equal to generate_take_config={configs_equal}, K1/K3/K2/K6/K7 "
        f"launches {_launch_line(launches)}")
    if not (configs_equal and min(meshes) > 0 and min(launches.values()) > 0):
        raise AssertionError("run_batch outside its gates")

    # cut_image_dir: two cameras, two frames each (the second one's views
    # as the first's second frame, so the background model is their mean).
    cut = os.path.join(root, "cut")
    os.makedirs(cut, exist_ok=True)
    for j in (0, 1):
        for e in (1, 2):
            imwrite(os.path.join(cut, f"{e:04d}_Cam{j}.jpg"), imgs[j + 2 * (e - 1)])
    seg.flood_fill.readbacks = 0
    _, cut_s = timed(lambda: seg.cut_image_dir(cut, device="cuda"))
    n = len(os.listdir(os.path.join(cut, "mask")))
    out["cut_image_dir"] = dict(seconds=cut_s, masks=n, readbacks=seg.flood_fill.readbacks)
    log(f"cut_image_dir: 2 cameras x 2 frames {size[0]}x{size[1]}, {n} masks in "
        f"{cut_s:.2f} s, {seg.flood_fill.readbacks} flood_fill read-backs ({card})")
    if n != 4:
        raise AssertionError("cut_image_dir did not write its 4 masks")
    return out


def dome_preset_config():
    """`preset("dome32")` itself (16 pairs, 5 levels from 240x135 to
    3840x2160, refine 30 + 30*level, SOR k 100, a 256^3 grid), with the
    bench's scene-unit mls_radius 0.02 (`bench.py:99-126`; the preset's
    2.5 is in millimetres)."""
    import dataclasses
    from reconstruction_tpu_torch.config import preset
    base = preset("dome32")
    return base.replace(cloud=dataclasses.replace(base.cloud, mls_radius=0.02))


def log_stages(label: str, stages: dict, card: str) -> None:
    """The largest stages of `tools/pair_stages.pair_stage_seconds`, and the ordering and
    bound-propagation seconds summed over the levels."""
    from reconstruction_tpu_torch.tools.pair_stages import stage_totals
    secs = stages["seconds"]
    total = stages["totals"] = stage_totals(secs)
    log(f"{label}, seconds by stage (the card synchronized around each; wall "
        f"{stages['wall_s']:.3f} s, {card}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in list(secs.items())[:24]))
    log(f"{label}: ordering_constraint {total['ordering_constraint']:.4f} s and "
        f"propagate_bounds {total['propagate_bounds']:.4f} s over all levels ({card})")


def profile_level(run, level: int, label: str, card: str) -> dict:
    """`profile_run` over pyramid level ``level`` of one match_pair ``run``
    (its `match_one_level` call, wrapped here for the run)."""
    from reconstruction_tpu_torch.stereo import pipeline as sp
    real, out = sp.match_one_level, {}

    def one_level(*a, **kw):
        if a[5] != level:
            return real(*a, **kw)
        box = {}
        out["profile"] = profile_run(lambda: box.setdefault("state", real(*a, **kw)),
                                     label, card)
        return box["state"]

    sp.match_one_level = one_level
    try:
        run()
    finally:
        sp.match_one_level = real
    return out["profile"]


def keep_refine_call(run, shape):
    """``run()`` with the pair path's `disparity_refine` wrapped so that
    its first call on an (H, W) = ``shape`` disparity (the finest level's
    first direction) is kept: returns (``run()``, (args, kwargs, output))."""
    from reconstruction_tpu_torch.stereo import pipeline
    real, kept = pipeline.disparity_refine, []

    def keep(d, *args, **kwargs):
        out = real(d, *args, **kwargs)
        if not kept and tuple(d.shape) == shape:
            kept.append(((d,) + args, kwargs, out))
        return out

    pipeline.disparity_refine = keep
    try:
        res = run()
    finally:
        pipeline.disparity_refine = real
    if not kept:
        raise AssertionError(f"no disparity_refine call on a {shape} disparity")
    return res, kept[0]


def plain_refine_sweeps(d, cv, base, inner, iterations: int, ws: float, every: int):
    """`ops/refine.refine_sweeps` with the plain sweeps in place of K2."""
    from reconstruction_tpu_torch.ops import refine as K2
    chunk = every if every > 0 else iterations
    done = 0
    while done < iterations:
        j0, jref = K2.window_anchors(d, base)
        n = min(chunk, iterations - done)
        d = K2.refine_sweeps_fused_plain(d, cv, j0, jref, inner, ws, n)
        done += n
    return d


def refine_call_against_plain(call, label: str) -> dict:
    """K3 and K2 on one kept `disparity_refine` call (`keep_refine_call`)
    against their plain versions, in the call's cv_dtype: the volume bit-
    equal to `cost_volume_plain`'s, and the refined disparity after all
    the call's sweeps (window re-extractions included) bit-equal to the
    plain sweeps' and to what the call returned on the path.  Returns, by
    kernel name ("_bf16" for the bfloat16 instances), max_abs_err and the
    plain version's seconds."""
    import inspect

    import torch
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.margins import inner_box
    from reconstruction_tpu_torch.stereo.refine import (
        _band_ranges, disparity_refine, resolve_recenter, volume_args, volume_dtype)
    args, kwargs, path_out = call
    bound = inspect.signature(disparity_refine).bind(*args, **kwargs)
    bound.apply_defaults()
    a = bound.arguments
    disp = a["disp"].float()
    H, W = disp.shape
    band = min(a["band"], H)
    base_b, lo_b, hi_b = _band_ranges(disp, a["s_cap"], band, a["drift"])
    cargs = volume_args(a["imgL"], a["imgR"], base_b, lo_b, hi_b, a["s_cap"], band)
    dt = volume_dtype(a["cv_dtype"])
    sfx = "_bf16" if dt == torch.bfloat16 else ""
    cv = K13.cost_volume(*cargs, dtype=dt)
    cvp, plain_v = timed(lambda: K13.cost_volume_plain(*cargs, dtype=dt))
    equal_v = torch.equal(cv, cvp) and cv.dtype == dt
    err_v = 0.0 if equal_v else float((cv.float() - cvp.float()).abs().max())
    del cvp
    base = base_b.repeat_interleave(band)[:H]
    inner = inner_box(a["m"], H, W, inset=1)
    every = resolve_recenter(a["iterations"], a["recenter_every"])
    dk = K2.refine_sweeps(disp, cv, base, inner, a["iterations"], a["ws"], every)
    dp, plain_r = timed(lambda: plain_refine_sweeps(disp.contiguous(), cv, base,
                                                     inner.contiguous(), a["iterations"],
                                                     a["ws"], every))
    equal_r = torch.equal(dk, dp)
    err_r = float((dk - dp).abs().max())
    same_path = torch.equal(dk, path_out)
    log(f"{label}: K3{sfx} {H}x{a['s_cap']}x{W} volume ({cv.numel()} cells, "
        f"shifts {int(lo_b.min())}..{int(hi_b.max())}) bit-equal to its plain version="
        f"{equal_v} (plain {plain_v:.2f} s); K2{sfx} {a['iterations']} sweeps (window "
        f"every {every or a['iterations']}) bit-equal to the plain sweeps={equal_r} "
        f"(max_abs_err {err_r}, plain {plain_r:.2f} s), equal to the path's output="
        f"{same_path}")
    if not (equal_v and equal_r and same_path):
        raise AssertionError(f"{label}: K3{sfx} or K2{sfx} differs from its plain version")
    return {"cost_volume" + sfx: dict(max_abs_err=err_v, plain_s=plain_v, cells=cv.numel()),
            "refine_sweeps_fused" + sfx: dict(max_abs_err=err_r, plain_s=plain_r,
                                              sweeps=a["iterations"])}


def without_sync(fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): raises if it
    makes PyTorch synchronize the host with the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def constraint_checks(kept, label: str, card: str, reps: int) -> dict:
    """K6 and K7 on the pass calls `keep_constraint_calls` kept, each
    direction: each called once under `without_sync`, K6 bit-equal to
    `ordering_plain` everywhere, K7 bit-equal to `propagate_bounds_plain`
    at every mask-valid source pixel (its contract; the entries elsewhere
    that differ are counted), both equal to what the path computed.  The
    work that sets their time: K6's greedy steps a row (the points it
    deletes) and the points that cross any (those the loop visits), K7's
    layout (`ops/constraints.k7_layout`: the segments a column and rows a
    segment, the columns of a lane's run of a row).  With ``reps``, each
    kernel's device time by direction (torch.profiler; K7's two launches
    summed, and each alone) beside its byte bound (each input byte read
    once, each output byte written once), its whole call (CUDA events) and
    its plain version's time.  Returns {"ordering": ...,
    "propagate_bounds": ...} with max_abs_err over both directions."""
    import torch
    from reconstruction_tpu_torch.config import NOMATCH
    from reconstruction_tpu_torch.ops import constraints as K67
    from reconstruction_tpu_torch.stereo.margins import inner_box
    out = {"ordering": dict(max_abs_err=0.0, library_ms=None, calls=[]),
           "propagate_bounds": dict(max_abs_err=0.0, library_ms=None, calls=[])}
    for i, ((d, m), path) in enumerate(kept["ordering_constraint"]):
        H, W = d.shape
        k = without_sync(lambda: K67.ordering(d, m))
        p, plain_s = timed(lambda: K67.ordering_plain(d, m))
        equal, same_path = torch.equal(k, p), torch.equal(k, path)
        err = float((k - p).abs().max())
        steps = (k != d).sum(1)
        valid = (d != NOMATCH) & inner_box(m, H, W)
        crossing = int((K67._crossings(d + torch.arange(W, device=d.device), valid)
                        > 0).sum())
        row = dict(direction=i, H=H, W=W, equal=equal, same_path=same_path,
                   max_abs_err=err, plain_s=plain_s, points=int(valid.sum()),
                   crossing_points=crossing,
                   steps_max=int(steps.max()), steps_mean=float(steps.float().mean()),
                   steps_total=int(steps.sum()))
        log(f"K6 ordering, {label}, direction {i} ({H}x{W}): bit-equal to ordering_plain="
            f"{equal}, equal to the path's output={same_path}, no host sync; greedy steps "
            f"a row max {row['steps_max']}, mean {row['steps_mean']:.2f}, total "
            f"{row['steps_total']} of {row['points']} points, {crossing} of which cross "
            f"any (plain {plain_s:.3f} s)")
        if not (equal and same_path):
            raise AssertionError(f"K6 ({label}, direction {i}) differs from its plain version")
        out["ordering"]["calls"].append(row)
        out["ordering"]["max_abs_err"] = max(out["ordering"]["max_abs_err"], err)
    for i, ((d, v, ms, mt, *rest), path) in enumerate(kept["propagate_bounds"]):
        H, W = d.shape
        BL, BR = without_sync(lambda: K67.propagate_bounds(d, v, ms, mt, *rest))
        (BLp, BRp), plain_s = timed(lambda: K67.propagate_bounds_plain(d, v, ms, mt, *rest))
        mask = v & inner_box(ms, H, W)
        equal = torch.equal(BL[mask], BLp[mask]) and torch.equal(BR[mask], BRp[mask])
        outside = int(((BL != BLp) | (BR != BRp))[~mask].sum())
        same_path = torch.equal(BL, path[0]) and torch.equal(BR, path[1])
        err = max(float((BL - BLp)[mask].abs().max()), float((BR - BRp)[mask].abs().max()))
        lay = K67.k7_layout(H, W)
        row = dict(direction=i, H=H, W=W, equal_mask_valid=equal, mask_valid=int(mask.sum()),
                   differ_outside=outside, same_path=same_path, max_abs_err=err,
                   plain_s=plain_s, layout=lay)
        log(f"K7 propagate_bounds, {label}, direction {i} ({H}x{W}): bit-equal to "
            f"propagate_bounds_plain at the {row['mask_valid']} mask-valid source pixels="
            f"{equal}, entries elsewhere that differ {outside}, equal to the path's output="
            f"{same_path}, no host sync; {lay['segments']} segments a column of "
            f"{lay['segment_rows']} rows ({lay['column_blocks']} blocks of "
            f"{lay['columns_a_block']} columns), runs of {lay['run']} columns a lane "
            f"({lay['row_blocks']} blocks of {lay['rows_a_block']} rows) "
            f"(plain {plain_s:.3f} s)")
        if not (equal and same_path):
            raise AssertionError(f"K7 ({label}, direction {i}) differs from its plain version")
        out["propagate_bounds"]["calls"].append(row)
        out["propagate_bounds"]["max_abs_err"] = max(out["propagate_bounds"]["max_abs_err"],
                                                     err)
    if not reps:
        return out
    for i, ((d, m), _) in enumerate(kept["ordering_constraint"]):
        fn = lambda: K67.ordering(d, m)
        row = out["ordering"]["calls"][i]
        row.update(ms=kernel_ms(fn, "ordering_constraint_kernel", reps),
                   call_ms=cuda_ms(fn, reps), **bound(d.numel() * 8 + 16, 0.0))
        if i == 0:
            H, W = d.shape
            out["ordering"].update(
                ms=row["ms"], call_ms=row["call_ms"],
                plain_ms=cuda_ms(lambda: K67.ordering_plain(d, m), 1),
                steps_max=row["steps_max"], **bound(H * W * 8 + 16, 0.0))
    for i, ((d, v, ms, mt, *rest), _) in enumerate(kept["propagate_bounds"]):
        fn = lambda: K67.propagate_bounds(d, v, ms, mt, *rest)
        row = out["propagate_bounds"]["calls"][i]
        row.update(ms=kernel_ms(fn, "propagate_bounds_", reps, per_call=2),
                   columns_ms=kernel_ms(fn, "propagate_bounds_columns", reps),
                   rows_ms=kernel_ms(fn, "propagate_bounds_rows", reps),
                   call_ms=cuda_ms(fn, reps), **bound(d.numel() * 13 + 24, 0.0))
        if i == 0:
            H, W = d.shape
            out["propagate_bounds"].update(
                ms=row["ms"], call_ms=row["call_ms"],
                plain_ms=cuda_ms(lambda: K67.propagate_bounds_plain(d, v, ms, mt, *rest), 2),
                **bound(H * W * 13 + 24, 0.0))
    for name in ("ordering", "propagate_bounds"):
        calls = out[name]["calls"]
        log(f"{name} {label}: kernel ms by direction "
            f"{[round(c['ms'], 4) for c in calls]} beside the byte bound "
            f"{[round(c['bound_ms'], 4) for c in calls]}, whole call "
            f"{[round(c['call_ms'], 4) for c in calls]}"
            + (f", column pass {[round(c['columns_ms'], 4) for c in calls]}, row pass "
               f"{[round(c['rows_ms'], 4) for c in calls]}" if name == "propagate_bounds"
               else "") + f" ({card})")
        report(f"{'K6' if name == 'ordering' else 'K7'} {name} {label}, direction 0",
               out[name], card)
    return out


def phase_constraints(card: str) -> dict:
    """K6 and K7 at the slice's finest level: one `myself` match_pair
    (1280x1920, the slice phase's scene), its finest level's ordering and
    bound-propagation calls kept and held against the plain versions,
    then timed (`constraint_checks`)."""
    from reconstruction_tpu_torch.config import preset
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.tools.pair_stages import scene_args
    size = preset("myself").finest_size
    args = scene_args("myself")
    _, kept = keep_constraint_calls(lambda: match_pair(*args, device="cuda"),
                                    (size[1], size[0]))
    return constraint_checks(kept, f"myself finest level {size[1]}x{size[0]}", card, reps=10)


def phase_dome(card: str) -> dict:
    """The 32-camera dome at its own size (`preset("dome32")`: 16 pairs,
    3840x2160, 5 levels, refine 30 + 30*level; `dome_preset_config`)
    through the production entry `reconstruct(mesh=...)` on one NCCL rank,
    by the dome tool's functions (`reconstruction_tpu_torch/tools/
    demo_dome.py`): wall by stage, K1/K3/K2/K6/K7 launches, peak device memory,
    cloud points, vertices and point-to-surface RMSE, held to the JAX
    tool's gates (finite vertices, more than 10,000, RMSE < 0.2).  Then
    pair (0, 1) through match_pair in float32 and with the bfloat16 cost
    window (wall, per-level ms, the pair's own peak memory, launches, and
    |d_f32 - d_bf16| over the finest pixels valid in both), the float32
    pair's seconds by stage, and a profile of its finest level.  K3 and
    K2 of each of the two runs are held against their plain versions on
    the inputs the run gave them at the finest level (3840x2160, the
    volume 2160x128x3840)."""
    import dataclasses
    import gc

    import torch
    from reconstruction_tpu_torch.config import NOMATCH
    from reconstruction_tpu_torch.parallel.mesh import COMM
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.tools import demo_dome
    from reconstruction_tpu_torch.tools.pair_stages import pair_stage_seconds

    cfg = dome_preset_config()
    torch.cuda.empty_cache()
    (cams, pairs), render_s = timed(lambda: demo_dome.dome_pairs(cfg, "cuda"))
    log(f"dome: {2 * cfg.num_pairs} views {cfg.finest_size[0]}x{cfg.finest_size[1]} "
        f"rendered in {render_s:.2f} s; {cfg.num_pairs} pairs, {cfg.pyramid_levels} "
        f"levels, refine {[cfg.refine_iterations(v) for v in range(cfg.pyramid_levels)]}")
    torch.cuda.reset_peak_memory_stats()
    COMM.reset()
    (rec, wall), _, launches = counted(lambda: demo_dome.reconstruct_sharded(cfg, pairs, "cuda"))
    summ = demo_dome.summary(cfg, rec, wall, 1, "cuda")
    ok = demo_dome.passes(rec)
    spans = {k: round(v, 4) for k, v in rec.timer.spans.items()}
    out = dict(summary=summ, spans=spans, launches=launches, render_s=render_s,
               stats=rec.stats.records, comm=COMM.as_dict(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    log(f"dome reconstruct(mesh=...), one NCCL rank: {wall:.2f} s wall ({card}); "
        f"stage seconds {spans}; K1/K3/K2/K6/K7 launches {_launch_line(launches)}; collectives "
        f"{out['comm']}; peak device "
        f"memory {out['peak_mem_gb']:.2f} GiB; fused cloud {summ['cloud_points']} points, "
        f"mesh {summ['verts']} vertices / {summ['faces']} faces, RMSE "
        f"{summ['surface_rmse']}; stats {rec.stats.records}")
    log(json.dumps(summ))
    if not (ok and all(launches.values())):
        raise AssertionError("the dome's mesh fails the JAX tool's gates (finite vertices, "
                             "more than 10,000, RMSE < 0.2) or a kernel was not launched")
    del rec
    gc.collect()
    torch.cuda.empty_cache()

    # Pair (0, 1) alone: float32, then the bfloat16 cost window.
    pin = pairs[0]
    args = (pin.image0, pin.image1, pin.mask0, pin.mask1, pin.K0, pin.Rt0, pin.K1, pin.Rt1)
    ab, checks = {}, {}
    finest = (cfg.finest_size[1], cfg.finest_size[0])
    for dt in ("float32", "bfloat16"):
        c = cfg.replace(stereo=dataclasses.replace(cfg.stereo, refine_cv_dtype=dt))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        run_pair = lambda: keep_refine_call(
            lambda: counted(lambda: match_pair(c, *args, device="cuda"),
                            bf16=dt == "bfloat16"), finest)
        if dt == "float32":   # K6's and K7's finest-level calls kept too
            ((res, s, n), call), kept = keep_constraint_calls(run_pair, finest)
        else:
            (res, s, n), call = run_pair()
        ab[dt] = dict(wall_s=s, launches=n, level_ms=res.level_ms,
                      peak_gb=(torch.cuda.max_memory_allocated() - held) / 2**30,
                      cloud=cloud_metrics(res.cloud), disparity=res.disparity,
                      drift=res.refine_drift.cpu().numpy().round(4).tolist())
        log(f"dome pair (0, 1) with a {dt} cost volume: {s:.2f} s wall, per-level ms "
            f"{[round(v, 1) for v in res.level_ms or ()]}, its own peak device memory "
            f"{ab[dt]['peak_gb']:.3f} GiB, K1/K3/K2/K6/K7 launches {_launch_line(n)}, refine "
            f"drift p99 {ab[dt]['drift']}, cloud {ab[dt]['cloud']} ({card})")
        if not all(n.values()):
            raise AssertionError(f"the dome pair ({dt}) did not launch every kernel")
        del res
        checks.update(refine_call_against_plain(
            call, f"dome pair (0, 1) {dt}, finest level, first direction"))
        del call
        if dt == "float32":
            checks.update(constraint_checks(
                kept, f"dome pair (0, 1) finest level {finest[0]}x{finest[1]}", card,
                reps=5))
            del kept
        gc.collect()
        torch.cuda.empty_cache()
    d32, d16 = ab["float32"].pop("disparity"), ab["bfloat16"].pop("disparity")
    both = (d32 != NOMATCH) & (d16 != NOMATCH)
    diff = (d32 - d16).abs()[both].cpu().numpy()
    dev = dict(valid_both=int(both.sum()),
               valid_one=int(((d32 != NOMATCH) ^ (d16 != NOMATCH)).sum()),
               equal_share=float((diff == 0).mean()),
               **{f"p{q}": float(np.percentile(diff, q)) for q in (50, 90, 99)},
               max=float(diff.max()))
    log(f"dome pair (0, 1) bfloat16 against float32 at the finest level: |d_f32 - d_bf16| "
        f"over {dev['valid_both']} pixels valid in both: p50 {dev['p50']:.4g}, p90 "
        f"{dev['p90']:.4g}, p99 {dev['p99']:.4g}, max {dev['max']:.4g}, equal "
        f"{dev['equal_share']:.4f}; valid in one only {dev['valid_one']}; peak memory "
        f"{ab['float32']['peak_gb']:.3f} against {ab['bfloat16']['peak_gb']:.3f} GiB")
    del d32, d16, both

    run = lambda: match_pair(cfg, *args, device="cuda")
    stages = pair_stage_seconds(run)
    log_stages("dome pair (0, 1) float32", stages, card)
    prof = profile_level(run, cfg.pyramid_levels - 1,
                         "the dome pair's finest level (3840x2160, float32)", card)
    return dict(out, pair_ab=ab, kernel_checks=checks, deviation=dev, pair_stages=stages,
                finest_profile=prof)


# The keys of the bench's line (the JAX package's `bench.py` line plus
# "card") and of its parts, and of `demo_video`'s line.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "chip", "card", "matching_s",
              "total_s", "cold_total_s", "stages_s", "mesh", "host", "all_runs_s",
              "stereo_only", "kernels", "phase_attempts"}
BENCH_MESH_KEYS = {"verts", "faces", "cloud_points", "surface_rmse"}
BENCH_HOST_KEYS = {"rss_mb", "load1", "cpu_over_wall"}
BENCH_CELLS = ("ncc_sweep", "ncc_sweep_mxu", "refine", "ba_schur")
BENCH_CELL_KEYS = {"seconds", "gflops_per_s", "flops_util", "hbm_gbps", "hbm_util", "bound"}
VIDEO_KEYS = {"frames", "views", "size", "wall_s", "per_frame_s", "pose_err_deg_final",
              "pose_err_deg_max", "mesh_rmse_median", "verts_median", "card"}


def run_module(name: str, args: list, timeout: float) -> tuple:
    """(last stdout line as JSON, wall seconds) of ``python -m`` the port's
    module ``name`` in a fresh process at the checkout's root; its stderr
    goes to SCRATCH/<last part of name>.err.  Raises on a non-zero exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", name] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=here)
    wall = time.perf_counter() - t0
    os.makedirs(SCRATCH, exist_ok=True)
    with open(os.path.join(SCRATCH, name.rsplit(".", 1)[-1] + ".err"), "w") as f:
        f.write(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {name} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}\n{proc.stdout[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def bench_reference_verts() -> int:
    """The mesh's vertex count of one `reconstruct` at the bench
    configuration, as `phase_reconstruct` runs it (for the bench phase
    run alone)."""
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput, reconstruct
    cfg = bench_config()
    cams, imgs, masks = bench_scene(8, 42.0, cfg.finest_size)
    pairs = [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                       K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                       K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
             for a, b in cfg.cam_pairs]
    return int(len(reconstruct(cfg, pairs, device="cuda").vertices))


def sweep_cell_parts() -> dict:
    """Milliseconds a call of the bench's `ncc_sweep` cell's parts at its
    inputs (`bench.chained_seconds`: CUDA events around 10 calls): both
    images centered and their window moments (`sweep_moments`), and K1's
    wrapper alone on them (the kernel and its flag's read-back)."""
    import torch
    from reconstruction_tpu_torch import bench
    from reconstruction_tpu_torch.core.pyramid import quantize_u8
    from reconstruction_tpu_torch.ops.ncc_sweep import ncc_sweep
    from reconstruction_tpu_torch.stereo.matching import _centered, sweep_moments
    H, W = 1920, 1280
    imgL, imgR, mask = bench.synth_pair(H, W, np.random.default_rng(7))
    Lq, Rq = (quantize_u8(torch.as_tensor(a, device="cuda")) for a in (imgL, imgR))
    valid = torch.as_tensor(mask > 127, device="cuda")
    lo, hi = bench.sweep_bounds(H, W, 64)

    def moments(_):
        L, R = _centered(Lq), _centered(Rq)
        return L, R, sweep_moments(L, R, 2)

    L, R, mom = moments(None)
    return dict(
        moments_ms=bench.chained_seconds(moments, None, 10, "cuda") * 1e3,
        wrapper_ms=bench.chained_seconds(
            lambda _: ncc_sweep(L, R, *mom, valid, valid, lo, hi, 2), None, 10, "cuda") * 1e3)


def phase_bench(card: str, ref_verts=None) -> dict:
    """The port's headline bench, `python -m reconstruction_tpu_torch.bench`,
    at its defaults (kernel cells, stereo-only, a cold then two timed full
    `reconstruct`s) in a fresh process, and `demo_video` at its defaults
    (16 frames of 4 views at 320x240).  The bench's line must hold every
    key, a value equal to its views per second (the full phase's 2 * 4
    pairs / total_s, rounded as the line rounds) and above 0, every kernel
    cell's flops_util and hbm_util <= 1, the mesh inside
    `phase_reconstruct`'s gates with its vertex count (``ref_verts``, or
    one `reconstruct` here); the video's line its keys and the JAX tool's
    gates (the tool's exit code: finite vertices, median RMSE < 0.1)."""
    line, wall = run_module("reconstruction_tpu_torch.bench", [], 600)
    log(f"bench: python -m reconstruction_tpu_torch.bench in {wall:.1f} s ({card}): "
        f"{json.dumps(line)}")
    missing = BENCH_KEYS - set(line)
    missing |= {f"mesh.{k}" for k in BENCH_MESH_KEYS - set(line.get("mesh", {}))}
    missing |= {f"host.{k}" for k in BENCH_HOST_KEYS - set(line.get("host", {}))}
    cells = line.get("kernels", {})
    missing |= {f"kernels.{c}.{k}" for c in BENCH_CELLS
                for k in BENCH_CELL_KEYS - set(cells.get(c, {}))}
    if missing:
        raise AssertionError(f"the bench's line lacks {sorted(missing)}")
    vps = 2 * len(BENCH_PAIRS) / line["total_s"]
    over = {c: (cells[c]["flops_util"], cells[c]["hbm_util"]) for c in BENCH_CELLS
            if max(cells[c]["flops_util"], cells[c]["hbm_util"]) > 1.0}
    if ref_verts is None:
        ref_verts = bench_reference_verts()
    mesh = line["mesh"]
    ratio = mesh["verts"] / REF_MESH_VERTS
    log(f"bench gates: value {line['value']} == views/s {vps:.4f} (from total_s "
        f"{line['total_s']}) > 0; kernel cells with a utilization above 1: {over}; RMSE "
        f"{mesh['surface_rmse']} <= {RMSE_LIMIT}; vertices {mesh['verts']} ({ratio:.3f}x of "
        f"{REF_MESH_VERTS}, within 0.8-1.25) == phase_reconstruct's {ref_verts}")
    if not (line["value"] > 0 and abs(line["value"] - vps) <= 1e-4 + 1e-3 * vps
            and not over and mesh["surface_rmse"] <= RMSE_LIMIT
            and 0.8 <= ratio <= 1.25 and mesh["verts"] == ref_verts):
        raise AssertionError("the bench's line outside its gates")
    parts = sweep_cell_parts()
    log(f"bench ncc_sweep cell, ms a call ({card}): the cell "
        f"{cells['ncc_sweep']['seconds'] * 1e3:.4f}; centering and both images' moments "
        f"{parts['moments_ms']:.4f}, K1's wrapper {parts['wrapper_ms']:.4f}")

    video, video_wall = run_module("reconstruction_tpu_torch.tools.demo_video",
                                   ["--json", os.path.join(SCRATCH, "demo_video.json")],
                                   600)
    log(f"demo_video: 16 frames x 4 views at 320x240 in {video_wall:.1f} s ({card}): "
        f"{json.dumps(video)}; pose error final {video['pose_err_deg_final']} and max "
        f"{video['pose_err_deg_max']} degrees")
    if VIDEO_KEYS - set(video) or not video["mesh_rmse_median"] < 0.1:
        raise AssertionError(f"demo_video's line lacks {sorted(VIDEO_KEYS - set(video))} "
                             f"or fails its RMSE gate")
    return dict(line=line, wall_s=wall, ref_verts=ref_verts, sweep_cell_parts=parts,
                video=video, video_wall_s=video_wall)


# The scaling harness's keys: the JAX tool's (`tools/bench_scaling.py`) and the port's.
SCALING_KEYS = {"axis", "devices", "pairs", "finest", "levels", "wall_s", "views_per_sec",
                "cpu_s_per_pair", "wall_eff_vs_host_bound", "cpu_eff", "backend", "cards",
                "card", "launches_per_pair", "launches_from", "kernel_ms_per_pair",
                "dev_eff", "wall_eff_vs_card_bound", "comm_bytes", "digest"}
SCALING_BASE, SCALING_LEVELS, SCALING_COUNTS = (240, 160), 4, (1, 2, 4)


def phase_scaling(card: str) -> dict:
    """The scaling harness, `python -m reconstruction_tpu_torch.tools.bench_scaling`,
    in a fresh process at the `myself` finest size 1920x1280 (--base 240 160
    --levels 4), counts 1, 2 and 4 on the pair axis (gloo ranks sharing the
    card), 2 timed repeats.  Fails unless every line has every key, the
    launches per pair are equal across counts (K1, K3 and K2 each launched),
    each pair's digest is the same at every count and equal to a chain of
    `match_one_level` calls on the same pairs in this process; in that
    chain K1 on each of pair 0's calls, and K3 and K2 on its finest level's
    first refine (what rank 0 runs), are bit-equal to their plain versions."""
    import torch
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.stereo import matching
    from reconstruction_tpu_torch.tools import bench_scaling as bs
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.abspath(os.path.join(SCRATCH, "scaling.json"))
    args = ["--base", *map(str, SCALING_BASE), "--levels", str(SCALING_LEVELS),
            "--counts", *map(str, SCALING_COUNTS), "--repeats", "2", "--json", path]
    _, wall = run_module("reconstruction_tpu_torch.tools.bench_scaling", args, 600)
    with open(path) as f:
        lines = json.load(f)
    log(f"scaling: python -m reconstruction_tpu_torch.tools.bench_scaling "
        f"{' '.join(args[:-2])} in {wall:.1f} s ({card})")
    for r in lines:
        log(f"  {json.dumps(r)}")
        log(f"  count {r['devices']} ({r['backend']}, {r['cards']} card): wall "
            f"{r['wall_s']:.4f} s, {r['cpu_s_per_pair']:.4f} CPU s a pair, kernels "
            f"{r['kernel_ms_per_pair']} ms a pair; dev_eff {r['dev_eff']}, cpu_eff "
            f"{r['cpu_eff']:.4f}, wall_eff_vs_card_bound {r['wall_eff_vs_card_bound']}, "
            f"wall_eff_vs_host_bound {r['wall_eff_vs_host_bound']:.4f}, comm_bytes "
            f"{r['comm_bytes']}")
    missing = {r["devices"]: sorted(SCALING_KEYS - set(r)) for r in lines
               if SCALING_KEYS - set(r)}
    if missing or [r["devices"] for r in lines] != list(SCALING_COUNTS):
        raise AssertionError(f"the harness's lines lack keys {missing} or counts "
                             f"(got {[r['devices'] for r in lines]})")
    launches = lines[0]["launches_per_pair"]
    if (any(r["launches_per_pair"] != launches or r["launches_from"] != "kernels"
            for r in lines) or min(launches.values()) <= 0):
        raise AssertionError(f"launches per pair differ across counts or miss a kernel: "
                             f"{[r['launches_per_pair'] for r in lines]}")

    # The same pairs as a chain in this process; K1 held against its plain
    # version on pair 0's calls, K3 and K2 on its finest level's first refine.
    per_pair, sweeps = int(launches["ncc_sweep"]), []
    real = matching.ncc_sweep

    def checked(*a):
        out = real(*a)
        if len(sweeps) < per_pair:
            plain = K13.ncc_sweep_plain(*a)
            sweeps.append(0.0 if all(torch.equal(x, y) for x, y in zip(out, plain))
                          else float((out[0] - plain[0]).abs().max()))
        return out

    W0, H0 = SCALING_BASE
    finest = (H0 << (SCALING_LEVELS - 1), W0 << (SCALING_LEVELS - 1))
    matching.ncc_sweep = checked
    try:
        ref, call = keep_refine_call(lambda: bs.reference_digests(
            max(SCALING_COUNTS), SCALING_LEVELS, SCALING_BASE, "cuda"), finest)
    finally:
        matching.ncc_sweep = real
    checks = refine_call_against_plain(call, "scaling pair 0, finest level")
    log(f"scaling: K1 on pair 0's {len(sweeps)} calls bit-equal to its plain version: "
        f"{sum(e == 0.0 for e in sweeps)} of {per_pair} (max_abs_err {max(sweeps)})")
    prefix = {r["devices"]: r["digest"] == ref[:r["pairs"]] for r in lines}
    log(f"scaling: each count's pair digests equal to the in-process chain's {ref}: {prefix}")
    if len(sweeps) != per_pair or max(sweeps) != 0.0 or not all(prefix.values()):
        raise AssertionError("the scaling path's digests or K1 differ")
    return dict(lines=lines, wall_s=wall, chain_digest=ref, k1_max_abs_err=max(sweeps),
                kernel_checks=checks)


def main() -> int:
    import torch

    # Alone in a directory the script has stopped already, at its import of
    # the package.
    from reconstruction_tpu_torch.ops import _build
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from reconstruction_tpu_torch.utils.profiling import card_line
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reconstruction_tpu_torch.utils.profiling import check_event_reader
    log(f"profiler: the raw event reader agrees with prof.events() on "
        f"{check_event_reader()} device events (torch {torch.__version__})")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    # Named phases alone (for a quick look; no kernels line, no result).
    only = {"kernels": lambda: phase_kernels(card), "slice": lambda: phase_slice(card),
            "small": phase_small_reference, "mxu": lambda: phase_mxu_path(card),
            "ba": lambda: phase_ba(card), "front": lambda: phase_front_end(card),
            "reconstruct": lambda: phase_reconstruct(card), "cli": lambda: phase_cli(card),
            "video": lambda: phase_video(card),
            "satellites": lambda: phase_satellites(card),
            "parallel": lambda: phase_parallel(card), "dome": lambda: phase_dome(card),
            "bench": lambda: phase_bench(card), "scaling": lambda: phase_scaling(card)}
    if sys.argv[1:]:
        for name in sys.argv[1:]:
            only[name]()
        return 0

    kern = phase_kernels(card)
    sl = phase_slice(card)
    small = phase_small_reference()
    mxu = phase_mxu_path(card)
    ba = phase_ba(card)
    front = phase_front_end(card)
    recon = phase_reconstruct(card)
    cli = phase_cli(card)
    par = phase_parallel(card, seq=recon.pop("rec"), scene=recon.pop("scene"))
    vid = phase_video(card)
    sat = phase_satellites(card)
    bench = phase_bench(card, ref_verts=recon["runs"][0]["verts"])
    scaling = phase_scaling(card)
    dome = phase_dome(card)

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
        dict(name="cost_volume_bf16", route="cuda", source=src + "ncc_sweep.cu",
             replaces="reconstruction_tpu/ops/refine_pallas.py:225"),
        dict(name="refine_sweeps_fused_bf16", route="cuda", source=src + "refine.cu",
             replaces="reconstruction_tpu/ops/refine_pallas.py:225"),
        dict(name="ordering", route="cuda", source=src + "constraints.cu",
             replaces="reconstruction_tpu/stereo/constraints.py:78"),
        dict(name="propagate_bounds", route="cuda", source=src + "constraints.cu",
             replaces="reconstruction_tpu/stereo/constraints.py:334"),
    ]
    # Launches on each kernel's main path: the myself pair (K1, K3, K2, K6, K7), BA
    # (K4), the tensor-core sweep's entry point (K5), and the dome's pair
    # (0, 1) with the bfloat16 cost window (K3's and K2's bfloat16 instances).
    bf16_pair = dome["pair_ab"]["bfloat16"]["launches"]
    path_launches = dict(sl["launches"], ba_coupling=ba["launches"],
                         ncc_sweep_mxu=mxu["launches"],
                         cost_volume_bf16=bf16_pair["cost_volume_bf16"],
                         refine_sweeps_fused_bf16=bf16_pair["refine_sweeps_fused_bf16"])
    for row in rows:
        row["launches"] = path_launches[row["name"]]
        row.update({k: kern[row["name"]][k]
                    for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")})
        # K3, K2, K6 and K7 were also held against their plain versions at the
        # dome's finest level (K3 and K2 on the pair whose bfloat16 launches
        # the line reports).
        if row["name"] in dome["kernel_checks"]:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     dome["kernel_checks"][row["name"]]["max_abs_err"])
        # The wrapper's whole call where it reads a check back from the card.
        if "call_ms" in kern[row["name"]]:
            row["call_ms"] = kern[row["name"]]["call_ms"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=rows, kernel_times=kern, slice=sl,
                       small=small, mxu_path=mxu, ba=ba, front_end=front,
                       reconstruct=recon, cli=cli, parallel=par, video=vid,
                       satellites=sat, bench=bench, scaling=scaling, dome=dome,
                       build_log=_build.build_log), f, indent=1, default=str)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
