"""Headline benchmark of the port: views fused per second on one card, end
to end, with the kernel cells' rooflines; the port's counterpart of the
JAX package's `bench.py`, which prints the same JSON line.

Workload: the reference's "myself" rig shape (4 camera pairs {0,1},
{2,3}, {4,5}, {7,6}, 4 levels, base 160x240 -> finest 1280x1920) through
the whole `reconstruct` the reference times as "total time": per pair
rectify -> pyramid match (30+30*level refine sweeps) -> triangulate ->
SOR -> normals, then MLS -> Poisson (256^3) -> marching -> mesh cleanup
-> texture.  One view fused is one camera image carried from pixels to
the textured mesh (a pair fuses 2).  The scene is the synthetic
calibrated 8-camera rig around an analytic height field
(`utils/synthetic`), rendered once on the device and cached under
`.bench_cache/`; its known geometry gives the mesh's point-to-surface
RMSE.

    python -m reconstruction_tpu_torch.bench

Three phases, each in this process, one after the other:
  kernels  the four kernel cells at the bench's shapes (`measure_kernels`),
           each a function's seconds a call (CUDA events around chained
           calls) through the cost models of `utils/profiling`;
  stereo   `match_one_level` over the pyramid of a synthetic rectified
           pair, best of RECON_BENCH_REPS (default 3) warm passes;
  full     a cold `reconstruct`, then RECON_BENCH_REPS (default 2) timed
           runs, the best of them reported.
It prints ONE JSON line (`merge_and_print`): bench.py's keys plus "card",
the card's name and power limit.  A phase that raises is reported on
stderr; the line is still printed, and the exit code is 1.

Environment:
  RECON_BENCH_MODE=full|stereo   stereo: the stereo phase alone
  RECON_BENCH_PHASE=kernels|stereo|full   one phase alone
  RECON_BENCH_KERNELS=0          skip the kernels phase
  RECON_BENCH_PAIRS=N            the full phase's pair count (default 4)
  RECON_BENCH_REPS=N             timed repetitions (0: the cold run only)
  RECON_BENCH_REFINE_SCALE=x     the stereo phase's refine sweeps scaled
  RECON_REFINE_IMPL=...          the stereo phase's refine_impl
  RECON_BENCH_BASE=WxH, RECON_BENCH_LEVELS=N, RECON_BENCH_GRID=N,
  RECON_REFINE_CV_DTYPE=float32|bfloat16   the configuration (`bench_config`)
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from reconstruction_tpu_torch.config import NOMATCH, ReconstructionConfig, preset
from reconstruction_tpu_torch.utils.profiling import (
    card_line, ncc_sweep_cost, refine_cost, resolve_chip, schur_cost)

REFERENCE_VIEWS_PER_SEC = 0.017  # the reference's CPU matching model (BENCH_NOTES.md)
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".bench_cache")
PHASES = ("kernels", "stereo", "full")


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback
    to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card and found no CUDA device; "
                           "pass device='cpu' to run it on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------

def build_rig(image_size, num_cameras=8, span_deg=42.0, tag="myself", device="cuda"):
    """The calibrated rig and its views at the working resolution, rendered
    on ``device`` and stored as the JAX bench stores them (8-bit images,
    0/255 masks), cached under `CACHE`.  Returns (cameras as {"K", "Rt"},
    images, masks), host arrays."""
    dev = _device(device)
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"torch_rig_{tag}_{image_size[0]}x{image_size[1]}_"
                               f"{num_cameras}_{dev.type}.npz")
    if not os.path.exists(path):
        from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene
        _log(f"rendering {num_cameras} views at {image_size} on {dev.type} "
             f"(cached after the first run)")
        cams, imgs, masks = make_stereo_scene(
            image_size=image_size, span_deg=span_deg, num_cameras=num_cameras,
            device=dev)
        out = {"n": num_cameras}
        for i, (c, img, msk) in enumerate(zip(cams, imgs, masks)):
            out[f"K{i}"] = np.asarray(c.K, np.float64)
            out[f"Rt{i}"] = np.asarray(c.Rt, np.float64)
            out[f"img{i}"] = np.clip(img, 0, 255).astype(np.uint8)
            out[f"mask{i}"] = (msk > 127).astype(np.uint8) * np.uint8(255)
        np.savez_compressed(path, **out)
    with np.load(path) as z:
        n = int(z["n"])
        return ([{"K": z[f"K{i}"], "Rt": z[f"Rt{i}"]} for i in range(n)],
                [z[f"img{i}"] for i in range(n)],
                [z[f"mask{i}"] for i in range(n)])


def bench_config(npairs) -> ReconstructionConfig:
    """The myself preset's first ``npairs`` pairs, mls_radius 0.02 (the
    synthetic scene's world units), cut by RECON_BENCH_BASE ("40x60"),
    RECON_BENCH_LEVELS and RECON_BENCH_GRID, with RECON_REFINE_CV_DTYPE's
    cost-volume type."""
    cfg = preset("myself")
    kw = {}
    if "RECON_BENCH_BASE" in os.environ:
        w, h = os.environ["RECON_BENCH_BASE"].split("x")
        kw["lowest_level_size"] = (int(w), int(h))
    if "RECON_BENCH_LEVELS" in os.environ:
        kw["pyramid_levels"] = int(os.environ["RECON_BENCH_LEVELS"])
    surface = cfg.surface
    if "RECON_BENCH_GRID" in os.environ:
        surface = dataclasses.replace(
            surface, grid_resolution=int(os.environ["RECON_BENCH_GRID"]))
    stereo = cfg.stereo
    if "RECON_REFINE_CV_DTYPE" in os.environ:
        stereo = dataclasses.replace(
            stereo, refine_cv_dtype=os.environ["RECON_REFINE_CV_DTYPE"])
    return cfg.replace(
        cam_pairs=cfg.cam_pairs[:npairs],
        cloud=dataclasses.replace(cfg.cloud, mls_radius=0.02),
        stereo=stereo,
        surface=surface,
        **kw)


def make_pairs(cfg, cams, imgs, masks):
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
    return [PairInput(image0=imgs[a].astype(np.float32),
                      image1=imgs[b].astype(np.float32),
                      mask0=masks[a].astype(np.float32),
                      mask1=masks[b].astype(np.float32),
                      K0=cams[a]["K"], Rt0=cams[a]["Rt"],
                      K1=cams[b]["K"], Rt1=cams[b]["Rt"])
            for (a, b) in cfg.cam_pairs]


def synth_pair(H, W, rng):
    """Synthetic rectified pair with a smooth disparity field (the stereo
    phase's and the kernel cells' inputs): images (H, W, 3) float32, mask
    (H, W) 0/255."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tex = rng.uniform(0, 255, (H, W + 256, 3)).astype(np.float32)
    for ax in (0, 1):
        for _ in range(2):
            tex = 0.5 * tex + 0.25 * (np.roll(tex, 1, ax) + np.roll(tex, -1, ax))
    disp = 40.0 + 25.0 * np.sin(2 * np.pi * xx / W) * np.cos(2 * np.pi * yy / H)
    imgL = tex[:, :W]
    xs = (xx + disp).astype(np.int32) % (W + 256)
    imgR = tex[yy, xs]
    mask = np.zeros((H, W), np.float32)
    mask[8:-8, 8:-8] = 255.0
    return imgL, imgR, mask


def ba_problem(num_cameras: int = 16, num_points: int = 1 << 16, obs: int = 8,
               seed: int = 0, device="cuda"):
    """The ba_schur size on a 16-camera arc (span 30 degrees): points in
    [-1, 1]^3, each seen by ``obs`` distinct cameras, noiseless projections,
    base poses perturbed by 0.01 (camera 0, the gauge anchor, exact), points
    by 0.05 (tests/test_ba.py:16-54 at scale).  Returns (BAProblem on
    ``device``, Rt_true, pts_true).

    The JAX bench's problem (`bench.py:346-358`) puts every camera at one
    pose with random pixels, so each point's block is rank 2 plus the 1e-6
    Tikhonov term and its float32 inverse is rounding noise: `ba_step`'s
    reduced system comes out singular or not finite."""
    from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem
    from reconstruction_tpu_torch.core.camera import synthetic_rig
    from reconstruction_tpu_torch.core.rectify import rodrigues_mat

    rng = np.random.default_rng(seed)
    cams = synthetic_rig(num_cameras, span_deg=30.0)
    K = np.stack([np.asarray(c.K, np.float64) for c in cams])
    Rt_true = np.stack([np.asarray(c.Rt, np.float64) for c in cams])
    pts = rng.uniform(-1, 1, size=(num_points, 3))
    cam = np.sort(np.argsort(rng.random((num_points, num_cameras)), axis=1)[:, :obs],
                  axis=1).astype(np.int32)
    xc = np.einsum("moij,mj->moi", Rt_true[cam][..., :3], pts) + Rt_true[cam][..., 3]
    uvw = np.einsum("moij,moj->moi", K[cam], xc)
    uv = uvw[..., :2] / uvw[..., 2:3]
    Rt0 = Rt_true.copy()
    for ci in range(1, num_cameras):
        dR = rodrigues_mat(rng.normal(scale=0.01, size=3))
        Rt0[ci, :, :3] = dR @ Rt_true[ci, :, :3]
        Rt0[ci, :, 3] = dR @ Rt_true[ci, :, 3] + rng.normal(scale=0.01, size=3)
    pts0 = pts + rng.normal(scale=0.05, size=pts.shape)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    prob = BAProblem(K=t(K), Rt0=t(Rt0), points0=t(pts0), obs_uv=t(uv),
                     obs_cam=t(cam, torch.int32),
                     obs_ok=torch.ones((num_points, obs), dtype=torch.bool,
                                       device=device))
    return prob, Rt_true, pts


# ---------------------------------------------------------------------------
# kernel cells
# ---------------------------------------------------------------------------

def chained_seconds(step, state, n: int, device) -> float:
    """Seconds a call of ``state = step(state)``: one warm call, then n
    chained calls between two CUDA events (the host clock on the CPU)."""
    dev = torch.device(device)
    state = step(state)
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        return (time.perf_counter() - t0) / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(state)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def sweep_bounds(H: int, W: int, num_shifts: int, device="cuda"):
    """The kernel cells' absolute target-column bounds: [x, x + num_shifts
    - 1], clipped at the last column, so each pixel spans at most
    ``num_shifts`` shifts, all of s in [0, num_shifts - 1]."""
    x = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    lo = x.expand(H, W).contiguous()
    hi = torch.clamp(lo + (num_shifts - 1), max=W - 1).contiguous()
    return lo, hi


def measure_kernels(chip: str = "h100", device="cuda", H: int = 1920, W: int = 1280,
                    num_shifts: int = 64, refine_iterations: int = 30,
                    ba_cameras: int = 16, ba_points: int = 1 << 16, ba_obs: int = 8,
                    reps: int = 10) -> dict:
    """The four kernel cells (`bench.py:244-378`), each a function's seconds
    a call with its cost model's utilization:

      ncc_sweep      `ncc_sweep_match` at ``num_shifts`` shifts, r 2 (K1);
      ncc_sweep_mxu  `ncc_sweep_match_mxu` on the same inputs (K5);
      refine         `disparity_refine`, 30 sweeps, ws 0.03, from disparity
                     40 (K3, then K2), each call fed the last one's output;
      ba_schur       `ba_step` at 16 cameras, 65,536 points, 8 observations
                     (K4 through `ba_blocks`) on `ba_problem`, chained over
                     its output.

    The images are `synth_pair`'s rounded to the uint8 grid, which the
    sweep kernels take (every caller in the pipeline rounds them so)."""
    from reconstruction_tpu_torch.ba.bundle_adjust import ba_step
    from reconstruction_tpu_torch.core.pyramid import quantize_u8
    from reconstruction_tpu_torch.ops.ncc_sweep_mxu import ncc_sweep_match_mxu
    from reconstruction_tpu_torch.stereo.margins import find_margin
    from reconstruction_tpu_torch.stereo.matching import ncc_sweep_match
    from reconstruction_tpu_torch.stereo.refine import disparity_refine

    dev = _device(device)
    imgL, imgR, mask = synth_pair(H, W, np.random.default_rng(7))
    L = quantize_u8(torch.as_tensor(imgL, device=dev))
    R = quantize_u8(torch.as_tensor(imgR, device=dev))
    valid = torch.as_tensor(mask > 127, device=dev)
    m = find_margin(valid, 2)
    lo, hi = sweep_bounds(H, W, num_shifts, dev)
    out = {}

    def cell(name, seconds, cost):
        out[name] = dict(seconds=seconds, **cost.utilization(seconds, chip))
        _log(f"kernel cell {name}: {seconds * 1e3:.4f} ms a call, {out[name]}")

    sweep = ncc_sweep_cost(H, W, 3, 2, num_shifts)
    cell("ncc_sweep", chained_seconds(
        lambda _: ncc_sweep_match(L, R, valid, valid, lo, hi, 2).disparity,
        None, reps, dev), sweep)
    cell("ncc_sweep_mxu", chained_seconds(
        lambda _: ncc_sweep_match_mxu(L, R, valid, valid, lo, hi, 2).disparity,
        None, reps, dev), sweep)

    disp0 = torch.where(valid, 40.0, float(NOMATCH)).float()
    cell("refine", chained_seconds(
        lambda d: disparity_refine(d, L, R, m, refine_iterations, 0.03),
        disp0, max(reps // 2, 1), dev),
        refine_cost(H, W, refine_iterations, 128, build_shifts=40))

    C, M, O = ba_cameras, ba_points, ba_obs
    prob = ba_problem(C, M, O, device=dev)[0]
    poses0 = torch.zeros((C, 6), dtype=torch.float32, device=dev)
    cell("ba_schur", chained_seconds(
        lambda s: ba_step(prob, s[0], s[1], C)[:2],
        (poses0, prob.points0), max(reps // 2, 1), dev), schur_cost(M, O, C))
    return out


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def aggregate_stages(spans):
    """Collapse pairN/* spans; keep global stage names."""
    agg = {}
    for k, v in spans.items():
        key = k.split("/", 1)[1] if k.startswith("pair") else k
        agg[key] = agg.get(key, 0.0) + v
    return {k: round(v, 3) for k, v in agg.items()}


def host_stats(cpu_s: float, wall_s: float) -> dict:
    """The process's resident memory, the host's 1-minute load and CPU
    seconds over wall seconds: they tell contention from outside the
    process apart from a slower run."""
    rss = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                rss = float(line.split()[1]) / 1024.0
    return {"rss_mb": round(rss), "load1": round(os.getloadavg()[0], 2),
            "cpu_over_wall": round(cpu_s / max(wall_s, 1e-9), 2)}


def run_full(npairs: int, reps: int, device="cuda") -> dict:
    """A cold `reconstruct` at `bench_config(npairs)`, then ``reps`` timed
    runs; the best of them reported (the cold one when ``reps`` is 0,
    marked "warming")."""
    from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse

    dev = _device(device)
    cfg = bench_config(npairs)
    W, H = cfg.finest_size
    cams, imgs, masks = build_rig((W, H), device=dev)
    pairs = make_pairs(cfg, cams, imgs, masks)

    runs = []
    for r in range(reps + 1):
        _sync(dev)
        t0, c0 = time.perf_counter(), time.process_time()
        rec = reconstruct(cfg, pairs, device=dev)
        _sync(dev)
        total = time.perf_counter() - t0
        hstats = host_stats(time.process_time() - c0, total)
        mesh = {"verts": int(len(rec.vertices)), "faces": int(len(rec.faces)),
                "cloud_points": int(len(rec.cloud_xyz)),
                "surface_rmse": round(point_to_surface_rmse(rec.vertices), 5)}
        spans = dict(rec.timer.spans)
        runs.append((total, spans, mesh, hstats))
        _log(f"{'cold' if r == 0 else f'run {r}'}: {total:.3f} s  "
             f"stages={aggregate_stages(spans)} host={hstats} mesh={mesh}")
        del rec
        gc.collect()
    timed = runs[1:] or runs
    total, spans, mesh, hstats = min(timed, key=lambda run: run[0])
    out = {"matching_s": round(sum(v for k, v in spans.items()
                                   if k.endswith("/stereo")), 3),
           "total_s": round(total, 3),
           "cold_total_s": round(runs[0][0], 3),
           "stages_s": aggregate_stages(spans),
           "mesh": mesh,
           "host": hstats,
           "all_runs_s": [round(t, 1) for t, *_ in runs],
           "views_per_s": 2.0 * npairs / total}
    if reps == 0:
        out["warming"] = True
    return out


def run_stereo_only(reps: int, device="cuda") -> dict:
    """`match_one_level` over the pyramid of `synth_pair` at the finest
    size of `bench_config(1)`: one cold pass, then the best of ``reps``
    (the cold one when ``reps`` is 0, marked "warming")."""
    from reconstruction_tpu_torch.core.pyramid import build_pyramid, quantize_u8
    from reconstruction_tpu_torch.stereo.pipeline import match_one_level

    dev = _device(device)
    cfg = bench_config(1)
    W, H = cfg.finest_size
    imgL, imgR, mask = synth_pair(H, W, np.random.default_rng(0))
    levels = cfg.pyramid_levels
    pyrL = build_pyramid(torch.as_tensor(imgL, device=dev), levels)
    pyrR = build_pyramid(torch.as_tensor(imgR, device=dev), levels)
    pyrM = [quantize_u8(m) for m in build_pyramid(torch.as_tensor(mask, device=dev),
                                                  levels)]
    refine_scale = float(os.environ.get("RECON_BENCH_REFINE_SCALE", "1"))
    refine_impl = os.environ.get("RECON_REFINE_IMPL", "auto")

    def one_level(state, level):
        return match_one_level(
            quantize_u8(pyrL[level]), quantize_u8(pyrR[level]),
            pyrM[level], pyrM[level], state, level,
            radius=cfg.stereo.block_radius,
            offset=cfg.stereo.disparity_offset,
            ws=cfg.stereo.refine_ws,
            refine_iters=max(1, int(cfg.refine_iterations(level) * refine_scale)),
            refine_impl=refine_impl)

    state, cold = None, []
    for level in range(levels):
        _sync(dev)
        t0 = time.perf_counter()
        state = one_level(state, level)
        _sync(dev)
        cold.append(time.perf_counter() - t0)
        _log(f"level {level} cold: {cold[-1]:.3f} s")
    per_pair = sum(cold)
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        state = None
        for level in range(levels):
            state = one_level(state, level)
        _sync(dev)
        per_pair = min(per_pair, time.perf_counter() - t0)
    _log(f"stereo: {per_pair:.3f} s a pair")
    out = {"matching_s": round(per_pair, 3), "total_s": round(per_pair, 3),
           "stages_s": {"stereo": round(per_pair, 3)},
           "mesh": {}, "views_per_s": 2.0 / per_pair}
    if reps == 0:
        out["warming"] = True
    return out


# ---------------------------------------------------------------------------
# phases and the line
# ---------------------------------------------------------------------------

def run_phase(phase: str, device="cuda", kernel_kw=None) -> dict:
    """One phase's result, with "chip", the device's name.  ``kernel_kw``:
    `measure_kernels`'s shapes (the bench's own by default)."""
    dev = _device(device)
    chip, kind = resolve_chip(dev)
    _log(f"device: {kind} (peaks table: {chip}), phase={phase}")
    if phase == "kernels":
        res = {"kernels": measure_kernels(chip, dev, **(kernel_kw or {}))}
    elif phase == "stereo":
        res = run_stereo_only(int(os.environ.get("RECON_BENCH_REPS", "3")), dev)
    elif phase == "full":
        res = run_full(int(os.environ.get("RECON_BENCH_PAIRS", "4")),
                       int(os.environ.get("RECON_BENCH_REPS", "2")), dev)
    else:
        raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
    res["chip"] = kind
    return res


def phases_to_run() -> list:
    """The phases that the environment selects, in order."""
    if "RECON_BENCH_PHASE" in os.environ:
        phase = os.environ["RECON_BENCH_PHASE"]
        if phase not in PHASES:
            raise ValueError(f"RECON_BENCH_PHASE={phase!r}; one of {PHASES}")
        return [phase]
    mode = os.environ.get("RECON_BENCH_MODE", "full")
    if mode not in ("full", "stereo"):
        raise ValueError(f"RECON_BENCH_MODE={mode!r}; one of full, stereo")
    phases = ["stereo"] if mode == "stereo" else list(PHASES)
    if os.environ.get("RECON_BENCH_KERNELS", "1") == "0" and "kernels" in phases:
        phases.remove("kernels")
    return phases


def merge_and_print(results, attempts, card=None):
    """Print the line: the full phase's values where it ran, else the
    stereo phase's (with "full_error" when the full phase was tried and
    failed), the stereo phase's beside the full one's, the kernel cells,
    the attempts by phase, and the card."""
    full = results.get("full", {})
    stereo = results.get("stereo", {})
    kernels = results.get("kernels", {}).get("kernels", {})
    base = full or stereo
    vps = base.get("views_per_s", 0.0)
    out = {
        "metric": "views_fused_per_sec_per_chip",
        "value": round(vps, 4),
        "unit": "views/s",
        "vs_baseline": round(vps / REFERENCE_VIEWS_PER_SEC, 2),
        "chip": base.get("chip") or results.get("kernels", {}).get("chip"),
    }
    for k in ("matching_s", "total_s", "cold_total_s", "stages_s", "mesh",
              "host", "all_runs_s", "warming"):
        if k in base:
            out[k] = base[k]
    if stereo and full:
        out["stereo_only"] = {k: stereo[k] for k in
                              ("matching_s", "views_per_s") if k in stereo}
    if not full and "full" in attempts:
        out["full_error"] = (f"full phase failed "
                             f"({attempts['full']} attempts); value is the "
                             f"stereo-only (matching) protocol")
    out["kernels"] = kernels
    out["phase_attempts"] = attempts
    out["card"] = card
    print(json.dumps(out), flush=True)


def main(*, device="cuda", kernel_kw=None) -> int:
    """Run the selected phases and print the line; 1 if a phase raised."""
    dev = _device(device)
    results, attempts = {}, {}
    for phase in phases_to_run():
        attempts[phase] = 1
        try:
            results[phase] = run_phase(phase, dev, kernel_kw)
        except Exception:  # reported, and the exit code says so
            _log(f"phase {phase} failed:\n{traceback.format_exc()}")
    merge_and_print(results, attempts, card_line(dev))
    return 0 if len(results) == len(attempts) else 1


if __name__ == "__main__":
    sys.exit(main())
