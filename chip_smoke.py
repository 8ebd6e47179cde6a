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
  2. nvcc build of reconstruction_tpu_torch/csrc/*.cu (into
     reconstruction_tpu_torch/_build/)
  3. K1 sweep, K3 cost volume, K2 refine, K5 tensor-core sweep vs their
     plain versions at H=1920, W=1280, C=3 (K5 also vs K1), K4 coupling
     vs its plain version at E=18, O=8, M=65,536, C=16; timed with CUDA
     events
  4. match_pair on a rendered 1280x1920 two-view scene, preset "myself",
     with the kernels' launch counts, per-level times and cloud metrics,
     and the same path on a small scene against the plain CPU path
  5. ncc_sweep_match_mxu at the 64-shift 1920x1280 cell, equal to
     ncc_sweep_match (K1) on the same inputs
  6. bundle_adjust at 16 cameras, 65,536 points, 8 observations per
     point: cost drop, aligned point error, determinism, ms per ba_step
  7. Harris, colour descriptors, tracks and structure-only BA on three
     rendered 1280x1920 views (surface error), and at 160x120 card vs CPU
  8. the last line: {"ok": true, "device": {...}}

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
    errs, cases = [], [(lo, hi), (lo2.contiguous(), hi2.contiguous())]
    for i, (a, b) in enumerate(cases):
        args = margs + (valid, valid, a, b, r)
        sk, tk = K13.ncc_sweep(*args)
        sp, tp = K13.ncc_sweep_plain(*args)
        torch.cuda.synchronize()
        equal = torch.equal(sk, sp) and torch.equal(tk, tp)
        err = max(float((sk - sp).abs().max()), float((tk - tp).abs().max()))
        log(f"K1 ncc_sweep case {i}: bit-equal={equal} max_abs_err={err} "
            f"matched={int((tk >= 0).sum())}")
        if not equal:
            raise AssertionError(f"K1 case {i} differs from its plain version")
        errs.append(err)
    args = margs + (valid, valid, lo, hi, r)
    ms = cuda_ms(lambda: K13.ncc_sweep(*args), 10)
    plain_ms = cuda_ms(lambda: K13.ncc_sweep_plain(*args), 2)
    log(f"K1 ncc_sweep 64 shifts {H}x{W}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms ({card})")
    results["ncc_sweep"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

    # K3: the banded cost volume, s_cap 128, band 64, around d ~ 40.
    d = torch.where(valid, 40.0 + torch.randint(-3, 4, (H, W), generator=gen,
                                                device=dev).float(),
                    torch.tensor(float(NOMATCH), device=dev))
    s_cap, band = 128, 64
    base_b, lo_b, hi_b = _band_ranges(d, s_cap, band, 16)
    m1 = ncc_moments(L, 1)
    m1R = ncc_moments(R, 1)
    cargs = (L, R, (m1.n * m1.mean).contiguous(), m1.inv_norm, m1R.mean,
             m1R.inv_norm, base_b, lo_b, hi_b, s_cap, band)
    cvk = K13.cost_volume(*cargs)
    cvp = K13.cost_volume_plain(*cargs)
    torch.cuda.synchronize()
    equal = torch.equal(cvk, cvp)
    err = float((cvk - cvp).abs().max())
    log(f"K3 cost_volume: bit-equal={equal} max_abs_err={err}")
    if not equal:
        raise AssertionError("K3 differs from its plain version")
    del cvp
    ms = cuda_ms(lambda: K13.cost_volume(*cargs), 5)
    plain_ms = cuda_ms(lambda: K13.cost_volume_plain(*cargs), 1)
    log(f"K3 cost_volume s_cap {s_cap} band {band} {H}x{W}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms ({card})")
    results["cost_volume"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K2: 30 sweeps from the volume above, one re-extraction (auto).
    m = find_margin(valid, r)
    inner = inner_box(m, H, W, inset=1).contiguous()
    rowbase = base_b.repeat_interleave(band)[:H].contiguous()
    rc = resolve_recenter(30, -1)

    def sweeps(step):
        dd = d.contiguous()
        done = 0
        while done < 30:
            j0, jref = K2.window_anchors(dd, rowbase)
            n = min(rc, 30 - done)
            for _ in range(n):
                dd = step(dd, cvk, j0, jref, inner, 0.03)
            done += n
        return dd

    dk = sweeps(K2.refine_sweep)
    dp = sweeps(K2.refine_sweep_plain)
    torch.cuda.synchronize()
    equal = torch.equal(dk, dp)
    err = float((dk - dp).abs().max())
    close = float(torch.isclose(dk, dp, atol=1e-4, rtol=0).float().mean())
    same_nm = torch.equal(dk == NOMATCH, dp == NOMATCH)
    log(f"K2 refine 30 sweeps: bit-equal={equal} max_abs_err={err} "
        f"within1e-4={close} same_NOMATCH={same_nm} "
        f"moved={float(((dk != d) & valid).float().mean()):.4f}")
    if not (equal or (close >= 0.999 and same_nm)):
        raise AssertionError("K2 outside the refine tolerance of its plain version")
    j0, jref = K2.window_anchors(d, rowbase)
    ms = cuda_ms(lambda: K2.refine_sweep(d, cvk, j0, jref, inner, 0.03), 30)
    plain_ms = cuda_ms(lambda: K2.refine_sweep_plain(d, cvk, j0, jref, inner,
                                                     0.03), 5)
    log(f"K2 refine one sweep {H}x{W}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms ({card})")
    results["refine_sweep"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K5: the tensor-core sweep on K1's 64-shift case, against its plain
    # version and against K1 (one 128-shift chunk; the bounds gate the rest).
    args = margs + (valid, valid, lo, hi, r)
    s5, t5 = K5.ncc_sweep_mxu(*args)
    sp, tp = K5.ncc_sweep_mxu_plain(*args)
    s1, t1 = K13.ncc_sweep(*args)
    torch.cuda.synchronize()
    equal = torch.equal(s5, sp) and torch.equal(t5, tp)
    equal_k1 = torch.equal(s5, s1) and torch.equal(t5, t1)
    err = max(float((s5 - sp).abs().max()), float((t5 - tp).abs().max()))
    log(f"K5 ncc_sweep_mxu: bit-equal to plain={equal} to K1={equal_k1} "
        f"max_abs_err={err}")
    if not (equal and equal_k1):
        raise AssertionError("K5 differs from its plain version or from K1")
    ms = cuda_ms(lambda: K5.ncc_sweep_mxu(*args), 10)
    ms_k1 = cuda_ms(lambda: K13.ncc_sweep(*args), 10)
    plain_ms = cuda_ms(lambda: K5.ncc_sweep_mxu_plain(*args), 2)
    log(f"K5 ncc_sweep_mxu 64 shifts {H}x{W}: kernel {ms:.3f} ms, K1 "
        f"{ms_k1:.3f} ms, plain {plain_ms:.3f} ms ({card})")
    results["ncc_sweep_mxu"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    k1_ms=ms_k1)

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
    ms = cuda_ms(lambda: K4.ba_coupling(He, cam, C), 20)
    plain_ms = cuda_ms(lambda: K4.ba_coupling_plain(He, cam, C), 5)
    gbs = (He.numel() * 4 + cam.numel() * 4 + Wk.numel() * 4) / (ms * 1e6)
    log(f"K4 ba_coupling E={E} O={O} M={M} C={C}: kernel {ms:.4f} ms "
        f"({gbs:.0f} GB/s), plain {plain_ms:.4f} ms ({card})")
    results["ba_coupling"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


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
                ("refine_sweep", K2.refine_sweep))
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
    return dict(launches=launches, wall_s=[wall, wall2],
                level_ms=[res.level_ms, res2.level_ms], matched_frac=frac,
                cloud=metrics, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


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
    ref = ncc_sweep_match(imgL, imgR, valid, valid, lo, hi, 2)
    same = (torch.equal(res.disparity, ref.disparity)
            and torch.equal(res.score, ref.score))
    true_d = float((res.disparity == 40).float().mean())   # imgL(x) = imgR(x + 40)
    log(f"ncc_sweep_match_mxu {H}x{W}: equal to ncc_sweep_match={same}, "
        f"launches={launches}, fraction at the true disparity {true_d:.4f}")
    if not (same and true_d > 0.9):
        raise AssertionError("the tensor-core sweep's entry point disagrees")
    return dict(launches=launches, equal_k1=same, true_disparity_frac=true_d)


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
                step_ms=step_ms, step_plain_ms=step_plain_ms)


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
        dict(name="refine_sweep", route="cuda", source=src + "refine.cu",
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
                    for k in ("max_abs_err", "ms", "plain_ms")})
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
