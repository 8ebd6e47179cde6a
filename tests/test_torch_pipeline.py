"""Port vs reference: one pyramid level and the whole pair.

The level inputs are the reference's own (its remap and pyramids of the
synthetic scene at the tiny preset), and level 1 is fed the reference's
level-0 state through `from_jax_state`.  Disparities are bit-equal at
every stage, the refine included; the drift telemetry is a percentile
that torch and jnp interpolate in different float orders (1e-3 slot).
"""

import numpy as np
import pytest

from synthetic import make_stereo_scene
from torch_parity import J, T, assert_equal, to_np

from reconstruction_tpu.config import NOMATCH, preset
from reconstruction_tpu.core.pyramid import build_pyramid, quantize_u8
from reconstruction_tpu.core.rectify import rectify_pair
from reconstruction_tpu.stereo import pipeline as jp
from reconstruction_tpu_torch import config as tconfig
from reconstruction_tpu_torch.stereo import pipeline as tp
from reconstruction_tpu_torch.utils.convert import from_jax_state

CFG = preset("tiny").replace(pyramid_levels=2, lowest_level_size=(80, 60),
                             cam_pairs=((0, 1),))
TCFG = tconfig.preset("tiny").replace(pyramid_levels=2, lowest_level_size=(80, 60))


@pytest.fixture(scope="module")
def pair():
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120), span_deg=24.0)
    args = (imgs[0], imgs[1], masks[0], masks[1],
            np.asarray(cams[0].K), np.asarray(cams[0].Rt),
            np.asarray(cams[1].K), np.asarray(cams[1].Rt))
    return args


@pytest.fixture(scope="module")
def levels(pair):
    """Per-level (img0, img1, mask0, mask1) numpy inputs, from the reference."""
    i0, i1, k0, k1, K0, Rt0, K1, Rt1 = pair
    rect = rectify_pair(K0, Rt0, K1, Rt1, (160, 120), CFG.finest_size)
    imgs, masks, *_ = jp.remap_pair_views(CFG, i0, i1, k0, k1, K0, K1, rect,
                                          CFG.finest_size, False)
    p0, p1 = (build_pyramid(im, 2) for im in imgs)
    m0, m1 = ([quantize_u8(m) for m in build_pyramid(mk, 2)] for mk in masks)
    return [tuple(np.asarray(a) for a in (quantize_u8(p0[l]), quantize_u8(p1[l]),
                                          m0[l], m1[l])) for l in range(2)]


def _kw(level, iters):
    return dict(radius=2, offset=2, ws=0.03, refine_iters=iters,
                median_iters=1, recenter_every=-1)


def _run_both(inputs, level, iters, coarse_j=None):
    ref = jp.match_one_level(*[J(a) for a in inputs], coarse_j, level,
                             **_kw(level, iters))
    coarse_t = from_jax_state(coarse_j) if coarse_j is not None else None
    got = tp.match_one_level(*[T(a) for a in inputs], coarse_t, level,
                             **_kw(level, iters))
    return ref, got


def _assert_level_equal(ref, got):
    assert_equal(ref.disp0, got.disp0, "disp0")
    assert_equal(ref.disp1, got.disp1, "disp1")
    for a, b in ((ref.refine_drift0, got.refine_drift0),
                 (ref.refine_drift1, got.refine_drift1)):
        assert abs(float(a) - float(b)) <= 1e-3, (float(a), float(b))


def test_level0_stages_before_refine_exact(levels):
    """refine_iters=0: matching, smoothness, ordering, uniqueness, bound
    propagation, rematch and median, all bit-equal."""
    ref, got = _run_both(levels[0], 0, 0)
    assert_equal(ref.disp0, got.disp0, "disp0")
    assert_equal(ref.disp1, got.disp1, "disp1")
    assert (to_np(got.disp0) != NOMATCH).sum() > 1000


def test_level0_and_level1_from_reference_state(levels):
    ref0, got0 = _run_both(levels[0], 0, 30)
    _assert_level_equal(ref0, got0)
    ref1, got1 = _run_both(levels[1], 1, 60, coarse_j=ref0)
    _assert_level_equal(ref1, got1)
    assert (to_np(got1.disp0) != NOMATCH).sum() > 5000


def test_match_pair_tiny_vs_reference(pair):
    ref = jp.match_pair(CFG, *pair)
    got = tp.match_pair(TCFG, *pair, device="cpu")
    d_ref = np.asarray(ref.disparity)         # int16-quantized in the reference
    d_got = to_np(got.disparity)
    assert d_got.dtype == np.float32
    nm = d_got == NOMATCH
    np.testing.assert_array_equal(d_ref == NOMATCH, nm)
    # The port keeps float32; the reference's link quantizer, applied to
    # the port's map, gives the reference's map back bit for bit.
    from reconstruction_tpu.stereo.pipeline import _quantize_disp
    q, dmax = _quantize_disp(J(d_got))
    q = np.asarray(q)
    deq = np.where(q == -32768, np.float32(NOMATCH),
                   q.astype(np.float32) * (float(dmax) / 32000.0))
    assert_equal(d_ref, deq, "quantized disparity")
    assert np.abs(d_ref - d_got)[~nm].max() <= 0.51 * float(dmax) / 32000.0
    v_ref = np.asarray(ref.cloud.valid)
    v_got = to_np(got.cloud.valid)
    assert_equal(v_ref, v_got, "cloud.valid")
    assert v_got.sum() > 5000
    assert_equal(ref.cloud.colors, got.cloud.colors, "cloud.colors")
    # xyz: the reference's world transform is an XLA dot (its own
    # summation order); the port writes it out per component.
    np.testing.assert_allclose(np.asarray(ref.cloud.xyz)[v_ref],
                               to_np(got.cloud.xyz)[v_got], rtol=2e-5, atol=2e-5)
    for side in (0, 1):
        assert_equal(ref.rect_images[side], got.rect_images[side], "rect image")
        assert_equal(ref.rect_masks[side], got.rect_masks[side], "rect mask")
    assert tuple(got.refine_drift.shape) == (2, 2)
    for a, b in zip(ref.margins0, got.margins0):
        assert int(a) == int(b)


def test_from_jax_state_types():
    from reconstruction_tpu.stereo.margins import Margins as JM
    m = from_jax_state(JM(*(np.int32(v) for v in (1, 2, 3, 4))))
    assert [int(v) for v in m] == [1, 2, 3, 4]
    assert m.YL.dtype == T(np.int32(0)).dtype
    st = from_jax_state(jp.LevelState(disp0=np.zeros((2, 3), np.float32),
                                      disp1=np.ones((2, 3), np.float32)))
    assert isinstance(st, tp.LevelState) and st.refine_drift0 is None
    assert_equal(np.ones((2, 3), np.float32), st.disp1)


@pytest.mark.parametrize("name", ["myself", "ETH", "tiny", "dome32"])
def test_config_presets_match_reference(name):
    """The port's configuration keeps the reference's fields and presets
    for everything the slice reads."""
    import dataclasses
    ref, got = preset(name), tconfig.preset(name)
    for part in ("stereo", "cloud", "surface"):
        assert dataclasses.asdict(getattr(got, part)) == dataclasses.asdict(
            getattr(ref, part)), part
    for key in ("pyramid_levels", "lowest_level_size", "finest_size", "cam_pairs",
                "num_pairs", "filepath", "outfilename", "isoutput",
                "camera_calib_name", "imagelist", "masklist"):
        assert getattr(got, key) == getattr(ref, key), key
    for level in range(ref.pyramid_levels):
        assert got.level_size(level) == ref.level_size(level)
        assert got.refine_iterations(level) == ref.refine_iterations(level)
    assert tconfig.NOMATCH == NOMATCH
