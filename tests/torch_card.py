"""Shared set-up of the card tests (tests/test_torch_card.py,
tests/test_torch_kernels.py, the card ranks of tests/torch_parallel_work.py).
Imports torch and the port only: the card's machine has no jax."""

from __future__ import annotations

import hashlib
import os

import numpy as np

# The JAX package's full bench on the bench configuration
# (BENCH_r05.json "mesh"), and 1.2x its surface RMSE of 0.00755.
REF_MESH_VERTS = 282_709
RMSE_LIMIT = 0.0091
BENCH_PAIRS = ((0, 1), (2, 3), (4, 5), (7, 6))


def digest(a) -> str:
    """sha256 of a tensor's or an array's dtype, shape and bytes (equal
    digests: equal arrays, bit for bit)."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()


def pair_digests(res) -> dict:
    """Digests of what a PairResult carries downstream."""
    return dict(disparity=digest(res.disparity), xyz=digest(res.cloud.xyz),
                colors=digest(res.cloud.colors), valid=digest(res.cloud.valid),
                rect0=digest(res.rect_images[0]), rect1=digest(res.rect_images[1]),
                mask0=digest(res.rect_masks[0]), mask1=digest(res.rect_masks[1]),
                em0=digest(res.rect_masks_eroded[0]), drift=digest(res.refine_drift),
                margins0=[int(v) for v in res.margins0])


def counted(fn, bf16: bool = False):
    """(``fn()``, launches by kernel): the pair path's kernel counts (K8's,
    K9's, K1's, K3's and K2's by C entry, K6's, K7's and K10-K12's) set to 0 just
    before the call and read just after, K3 and K2 in the volume type of
    the path (float32, or bfloat16 with ``bf16``, named with a "_bf16"
    suffix).  Raises if ``fn`` launched K3 or K2 in the other type."""
    import torch
    from reconstruction_tpu_torch.ops import constraints as K67
    from reconstruction_tpu_torch.ops import ncc_sweep as K13
    from reconstruction_tpu_torch.ops import pyramid as K9
    from reconstruction_tpu_torch.ops import rectify_map as K8
    from reconstruction_tpu_torch.ops import refine as K2
    dt = torch.bfloat16 if bf16 else torch.float32
    keyed = {"cost_volume": (K13.cost_volume, K13.VOLUME_ENTRIES[dt]),
             "refine_sweeps_fused": (K2.refine_sweeps_fused, K2.SWEEP_ENTRIES[dt])}
    for w in (K8.rectify_map, K9.pyr_down, K13.ncc_sweep, K67.ordering, K67.propagate_bounds,
              K67.smoothness, K67.uniqueness, K67.median):
        w.launches = 0
    for w, _ in keyed.values():
        w.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    other = {e: n for w, entry in keyed.values() for e, n in w.launches.items() if e != entry}
    if other:
        raise AssertionError(f"the {dt} path launched kernels of the other volume type: "
                             f"{other}")
    sfx = "_bf16" if bf16 else ""
    return out, dict(rectify_map=K8.rectify_map.launches, pyr_down=K9.pyr_down.launches,
                     ncc_sweep=K13.ncc_sweep.launches,
                     **{name + sfx: w.launches[entry] for name, (w, entry) in keyed.items()},
                     ordering=K67.ordering.launches,
                     propagate_bounds=K67.propagate_bounds.launches,
                     smoothness=K67.smoothness.launches, uniqueness=K67.uniqueness.launches,
                     median=K67.median.launches)


def bench_config():
    """The bench configuration at its 4 pairs (the JAX package's
    `bench.py:99-125`): the myself preset, mls_radius 0.02, a 256^3 grid."""
    from reconstruction_tpu_torch.bench import bench_config as config
    return config(len(BENCH_PAIRS))


def quantized(imgs, masks):
    """Views as the bench stores them: 8-bit images, masks at 0/255."""
    return ([np.clip(im, 0, 255).astype(np.uint8).astype(np.float32) for im in imgs],
            [np.where(m > 127, 255.0, 0.0).astype(np.float32) for m in masks])


def bench_scene(num_cameras: int, span_deg: float, size):
    """Cameras, 8-bit views and 0/255 masks, rendered on the card."""
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene
    cams, imgs, masks = make_stereo_scene(image_size=size, span_deg=span_deg,
                                          num_cameras=num_cameras, device="cuda")
    return (cams,) + quantized(imgs, masks)


def pair_inputs(cam_pairs, Ks, Rts, imgs, masks) -> list:
    """`PairInput`s of ``cam_pairs`` over the views."""
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
    return [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                      K0=np.asarray(Ks[a]), Rt0=np.asarray(Rts[a]),
                      K1=np.asarray(Ks[b]), Rt1=np.asarray(Rts[b]))
            for a, b in cam_pairs]


def write_calib(root: str, cams) -> None:
    """The scene's cameras as the reference's `calib_camera.yml`."""
    from reconstruction_tpu_torch.io.opencv_yaml import save_opencv_yaml
    calib = {}
    for i, c in enumerate(cams):
        calib[f"intrinsic-{i}"] = np.asarray(c.K, np.float64)
        calib[f"extrinsic-{i}"] = np.asarray(c.Rt, np.float64)
    save_opencv_yaml(os.path.join(root, "calib_camera.yml"), calib)


def cloud_metrics(cloud) -> dict:
    """tests/test_stereo_e2e.py's criteria on the compacted cloud."""
    from reconstruction_tpu_torch.utils.synthetic import surface_fn
    pts = cloud.compact().xyz
    sel = (np.abs(pts[:, 0]) < 1.6) & (np.abs(pts[:, 1]) < 1.6)
    dz = np.abs(pts[sel][:, 2] - surface_fn(pts[sel][:, 0], pts[sel][:, 1]))
    return dict(points=int(len(pts)), outlier_frac=float((dz > 0.15).mean()),
                inlier_rmse=float(np.sqrt((dz[dz <= 0.15] ** 2).mean())))


def dome_preset_config():
    """`preset("dome32")` itself with the bench's scene-unit mls_radius 0.02
    (the preset's 2.5 is in millimetres)."""
    import dataclasses
    from reconstruction_tpu_torch.config import preset
    base = preset("dome32")
    return base.replace(cloud=dataclasses.replace(base.cloud, mls_radius=0.02))


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


def plain_build_pyramid(img, levels: int, quantize: bool = False):
    """The plain `core/pyramid` pyramid, as the pair path built it before K9."""
    from reconstruction_tpu_torch.core import pyramid as plain
    pyr = plain.build_pyramid(img, levels)
    return [plain.quantize_u8(p) for p in pyr] if quantize else pyr


def keep_refine_call(run, shape):
    """(``run()``, (args, kwargs, output)) of the pair path's first
    `disparity_refine` call on an (H, W) = ``shape`` disparity."""
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


def check_refine_call(call) -> None:
    """K3 and K2 on a kept `disparity_refine` call, in its cv_dtype: the
    volume bit-equal to the plain one, the disparity after all its sweeps
    (re-extractions included) to the plain sweeps' and to the path's."""
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
    cv = K13.cost_volume(*cargs, dtype=dt)
    assert cv.dtype == dt and torch.equal(cv, K13.cost_volume_plain(*cargs, dtype=dt)), \
        f"K3 ({dt}) differs from its plain version"
    base = base_b.repeat_interleave(band)[:H]
    inner = inner_box(a["m"], H, W, inset=1)
    every = resolve_recenter(a["iterations"], a["recenter_every"])
    dk = K2.refine_sweeps(disp, cv, base, inner, a["iterations"], a["ws"], every)
    dp, done = disp.contiguous(), 0
    inner = inner.contiguous()
    chunk = every if every > 0 else a["iterations"]
    while done < a["iterations"]:
        n = min(chunk, a["iterations"] - done)
        j0, jref = K2.window_anchors(dp, base)
        dp = K2.refine_sweeps_fused_plain(dp, cv, j0, jref, inner, a["ws"], n)
        done += n
    assert torch.equal(dk, dp), f"K2 ({dt}) differs from its plain sweeps"
    assert torch.equal(dk, path_out), f"K2 ({dt}) differs from the path's output"


def _bits_equal(a, b) -> bool:
    """Equal float32 bits (-0.0 and 0.0 differ)."""
    import torch
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_constraint_calls(kept) -> None:
    """K6, K7 and K10-K12 on the calls
    `tools/k67_phase_clocks.keep_constraint_calls` kept, without a host
    sync: K6 bit-equal to its plain version, K7 at every mask-valid source
    pixel (its contract), K10-K12 bit-equal to their plain versions run on
    the calls' inputs moved to the CPU; each to the path's output."""
    import torch
    from reconstruction_tpu_torch.ops import constraints as K67
    from reconstruction_tpu_torch.stereo.margins import Margins, inner_box

    def cpu(args):
        return [Margins(*[v.cpu() for v in a]) if isinstance(a, Margins)
                else a.cpu() if isinstance(a, torch.Tensor) else a for a in args]

    plain = {"smoothness_constraint": (K67.smoothness, K67.smoothness_plain),
             "uniqueness_constraint": (K67.uniqueness, K67.uniqueness_plain),
             "median_filter": (K67.median, K67.median_plain)}
    for name, (kernel, twin) in plain.items():
        for i, (args, path) in enumerate(kept[name]):
            k = without_sync(lambda: kernel(*args))
            outs = (k, path, twin(*cpu(args)))
            k, path, p = [(o,) if isinstance(o, torch.Tensor) else o for o in outs]
            for j, (a, b, c) in enumerate(zip(k, path, p)):
                assert _bits_equal(a.cpu(), c), f"{name}, call {i}, map {j}: not the plain's"
                assert _bits_equal(a, b), f"{name}, call {i}, map {j}: not the path's output"
    for i, ((d, m), path) in enumerate(kept["ordering_constraint"]):
        k = without_sync(lambda: K67.ordering(d, m))
        assert torch.equal(k, K67.ordering_plain(d, m)), f"K6, direction {i}"
        assert torch.equal(k, path), f"K6, direction {i}: not the path's output"
    for i, ((d, v, ms, mt, *rest), path) in enumerate(kept["propagate_bounds"]):
        H, W = d.shape
        BL, BR = without_sync(lambda: K67.propagate_bounds(d, v, ms, mt, *rest))
        BLp, BRp = K67.propagate_bounds_plain(d, v, ms, mt, *rest)
        mask = v & inner_box(ms, H, W)
        assert torch.equal(BL[mask], BLp[mask]) and torch.equal(BR[mask], BRp[mask]), \
            f"K7, direction {i}"
        assert torch.equal(BL, path[0]) and torch.equal(BR, path[1]), \
            f"K7, direction {i}: not the path's output"


# The parallel tests' sizes.  The default BA damping leaves the scale gauge
# undamped, so the step along it is rounding noise; at 100 it is damped and
# the step is the same under any summation order.
PARALLEL_RANKS = 4
VCYCLE = dict(R=256, levels=3, cycles=8)
SPLAT_R = 256
BA_DAMPINGS = (1e-3, 100.0)


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
