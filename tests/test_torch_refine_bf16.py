"""Port vs reference: the refine's bfloat16 cost window (the TPU kernel
B1's `cv_dtype="bfloat16"` form), bit for bit on the CPU.

The reference casts its 32-slot window of the float32 volume to bfloat16
and widens each plane in the kernel; the port stores the whole volume in
bfloat16 (K3 rounds as it writes) and widens each tap (K2).  Rounding
commutes with the window's selection, so both read the same taps: the
plain versions here are bit-equal to the Pallas kernel in interpret mode,
and to the reference's pair path at one pyramid level."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _kw, levels, pair  # noqa: F401 (fixtures)
from test_torch_refine import _scene
from torch_parity import J, T, assert_equal, margins, to_np

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.ops import refine_pallas as jrp
from reconstruction_tpu.stereo import pipeline as jp
from reconstruction_tpu.stereo import refine as jr
from reconstruction_tpu_torch.ops import ncc_sweep as K13
from reconstruction_tpu_torch.stereo import pipeline as tp
from reconstruction_tpu_torch.stereo import refine as tr


@pytest.fixture(scope="module")
def scene():
    return _scene(np.random.default_rng(21))


def _f32(a) -> np.ndarray:
    """A bfloat16 array of either package, widened to float32 (exact)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.float().numpy()
    assert a.dtype == jnp.bfloat16
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("iterations,recenter", [(24, -1), (30, 0), (60, -1)])
def test_bf16_refine_vs_pallas_kernel(scene, iterations, recenter):
    """The port's refine on a bfloat16 volume against B1 with its bfloat16
    window (interpret mode, the tiling the reference's pair path uses);
    the float32 refine differs on this scene, so the window's type shows."""
    imgL, imgR, disp, valid = scene
    mj, mt = margins(valid)
    ref = jrp.disparity_refine_pallas(
        J(disp), J(imgL), J(imgR), mj, iterations=iterations, s_cap=32,
        band=8, T=6, block=32, interpret=True, recenter_every=recenter,
        cv_dtype="bfloat16")
    got = tr.disparity_refine(T(disp), T(imgL), T(imgR), mt,
                              iterations=iterations, s_cap=32, band=8,
                              recenter_every=recenter, cv_dtype="bfloat16")
    assert_equal(ref, got, f"bf16 refine {iterations}/{recenter}")
    f32 = tr.disparity_refine(T(disp), T(imgL), T(imgR), mt,
                              iterations=iterations, s_cap=32, band=8,
                              recenter_every=recenter)
    assert not torch.equal(got, f32)
    assert ((to_np(got) != disp) & (disp != NOMATCH)).mean() > 0.3


@pytest.mark.parametrize("s_cap,band,drift", [(32, 8, 16), (128, 16, 16),
                                              (64, 48, 4)])
def test_bf16_volume_is_the_reference_volume_rounded(scene, s_cap, band, drift):
    """The bfloat16 volume (`cost_volume_plain(..., dtype=bfloat16)`, what
    K3 writes) equals the reference's float32 volume cast with
    astype(bfloat16), its last two axes swapped."""
    imgL, imgR, disp, _ = scene
    d = disp.copy()
    d[:8] += 9.0 * (d[:8] != NOMATCH)
    cv_r, base_r = jr._banded_cost_volume(J(imgL), J(imgR), J(d), s_cap, band,
                                          drift=drift)
    cv_g, base_g = tr._banded_cost_volume(T(imgL), T(imgR), T(d), s_cap, band,
                                          drift=drift, cv_dtype="bfloat16")
    assert_equal(base_r, base_g, "base")
    assert_equal(_f32(cv_r.astype(jnp.bfloat16)), _f32(cv_g.permute(0, 2, 1)),
                 "bf16 cv")
    # The plain version called directly, as chip_smoke.py holds K3 to it.
    from reconstruction_tpu_torch.stereo.matching import _centered, ncc_moments
    L, R = _centered(T(imgL)), _centered(T(imgR))
    mL, mR = ncc_moments(L, 1), ncc_moments(R, 1)
    ranges = tr._band_ranges(T(d), s_cap, min(band, d.shape[0]), drift)
    plain = K13.cost_volume_plain(L, R, mL.n * mL.mean, mL.inv_norm, mR.mean,
                                  mR.inv_norm, *ranges, s_cap,
                                  min(band, d.shape[0]), dtype=torch.bfloat16)
    assert_equal(_f32(cv_g), _f32(plain), "cost_volume_plain bf16")


def test_wrappers_refuse_other_volume_types(scene):
    from reconstruction_tpu_torch.ops import refine as K2
    imgL, imgR, disp, _ = scene
    with pytest.raises(ValueError):
        tr.disparity_refine(T(disp), T(imgL), T(imgR), margins(disp != NOMATCH)[1],
                            iterations=6, s_cap=32, band=8, cv_dtype="float16")
    cv, base = tr._banded_cost_volume(T(imgL), T(imgR), T(disp), 32, 8)
    j0, jref = K2.window_anchors(T(disp), base)
    inner = torch.ones(disp.shape, dtype=torch.bool)
    with pytest.raises(TypeError):
        K2.refine_sweeps_fused(T(disp), cv.half(), j0, jref, inner, 0.03, 6)


def test_bf16_level_vs_reference_pallas_path(levels, monkeypatch):
    """`match_one_level` with refine_cv_dtype="bfloat16" against the
    reference's pair path on its Pallas refine (interpret mode in this
    process), level 0 of the tiny scene with 30 sweeps; the port's "auto"
    and "pallas" are the same path."""
    monkeypatch.setattr(jrp, "disparity_refine_pallas", functools.partial(
        jrp.disparity_refine_pallas, interpret=True))
    kw = dict(_kw(0, 30), refine_cv_dtype="bfloat16")
    ref = jp.match_one_level(*[J(a) for a in levels[0]], None, 0,
                             refine_impl="pallas", **kw)
    for impl in ("pallas", "auto"):
        got = tp.match_one_level(*[T(a) for a in levels[0]], None, 0,
                                 refine_impl=impl, **kw)
        assert_equal(ref.disp0, got.disp0, f"disp0 ({impl})")
        assert_equal(ref.disp1, got.disp1, f"disp1 ({impl})")
        for a, b in ((ref.refine_drift0, got.refine_drift0),
                     (ref.refine_drift1, got.refine_drift1)):
            assert abs(float(a) - float(b)) <= 1e-3, (float(a), float(b))
    f32 = tp.match_one_level(*[T(a) for a in levels[0]], None, 0, **_kw(0, 30))
    assert not torch.equal(got.disp0, f32.disp0)


@pytest.mark.parametrize("impl,iterations,recenter", [
    ("xla", 30, -1),       # the reference's XLA path ignores cv_dtype
    ("auto", 20, -1),      # 20 % 6 != 0: the Pallas refine falls back
    ("pallas", 30, 10),    # a cadence off a multiple of 6: it falls back
])
def test_bf16_selection_gives_float32_where_the_reference_does(
        levels, impl, iterations, recenter):
    kw = dict(_kw(0, iterations), recenter_every=recenter)
    assert tp.refine_volume_dtype(impl, "bfloat16", iterations, recenter) == "float32"
    bf = tp.match_one_level(*[T(a) for a in levels[0]], None, 0, refine_impl=impl,
                            refine_cv_dtype="bfloat16", **kw)
    f32 = tp.match_one_level(*[T(a) for a in levels[0]], None, 0, **kw)
    assert_equal(f32.disp0, bf.disp0, "disp0")
    assert_equal(f32.disp1, bf.disp1, "disp1")


def test_refine_volume_dtype_rule():
    """bfloat16 exactly where the reference's Pallas refine streams a
    bfloat16 window."""
    rule = tp.refine_volume_dtype
    for it in (30, 60, 90, 120, 150):
        assert rule("auto", "bfloat16", it, -1) == "bfloat16"
        assert rule("pallas", "bfloat16", it, 0) == "bfloat16"
        assert rule("pallas", "bfloat16", it, 12) == "bfloat16"
        assert rule("auto", "float32", it, -1) == "float32"
        assert rule("xla", "bfloat16", it, -1) == "float32"
    assert rule("auto", "bfloat16", 12, -1) == "bfloat16"   # auto cadence 6
    assert rule("auto", "bfloat16", 6, -1) == "bfloat16"    # no re-extraction
    assert rule("auto", "bfloat16", 31, -1) == "float32"
    assert rule("auto", "bfloat16", 30, 15) == "float32"
