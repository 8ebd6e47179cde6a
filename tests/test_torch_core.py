"""Port vs reference: core device ops, margins and the synthetic scene."""

import numpy as np
import pytest
import jax.numpy as jnp

import synthetic as jsyn
from torch_parity import J, T, assert_equal, to_np

from reconstruction_tpu.core import camera as jcam
from reconstruction_tpu.core import morphology as jmorph
from reconstruction_tpu.core import pyramid as jpyr
from reconstruction_tpu.core import remap as jremap
from reconstruction_tpu.core.rectify import rectify_pair as j_rectify_pair
from reconstruction_tpu.stereo import margins as jmarg

from reconstruction_tpu_torch.core import camera as tcam
from reconstruction_tpu_torch.core import morphology as tmorph
from reconstruction_tpu_torch.core import pyramid as tpyr
from reconstruction_tpu_torch.core import remap as tremap
from reconstruction_tpu_torch.core.rectify import rectify_pair as t_rectify_pair
from reconstruction_tpu_torch.stereo import margins as tmarg
from reconstruction_tpu_torch.utils import synthetic as tsyn
from reconstruction_tpu_torch.utils.convert import from_jax_state


def test_rectify_copy_and_map_exact(rng):
    cams = jcam.synthetic_rig(2, span_deg=11.0, image_size=(160, 120))
    args = [np.asarray(a, np.float64) for c in cams for a in (c.K, c.Rt)]
    ref = j_rectify_pair(args[0], args[1], args[2], args[3], (160, 120), (80, 60))
    got = t_rectify_pair(args[0], args[1], args[2], args[3], (160, 120), (80, 60))
    for f in ("R1", "R2", "P1", "P2", "Q", "R_final", "T_final", "P1_scaled",
              "P2_scaled", "P1_world", "P2_world", "C2_world"):
        assert_equal(getattr(ref, f), getattr(got, f), f)
    assert ref.baseline_axis == got.baseline_axis
    for a, b in zip(jremap.rectify_map(args[0], ref.R1, ref.P1_scaled, (80, 60)),
                    tremap.rectify_map(args[0], got.R1, got.P1_scaled, (80, 60))):
        assert_equal(a, b, "rectify_map")
    conv = from_jax_state(ref)
    assert_equal(ref.Q, conv.Q, "from_jax_state(RectifyResult)")


@pytest.mark.parametrize("skew", [0.0, 3.7], ids=["plain_K", "skewed_K"])
@pytest.mark.parametrize("size", [(1280, 1920), (3840, 2160), (61, 47)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rectify_map_plain_bit_equal_to_jax(skew, size):
    """The port's rectify_map (explicit float64 elementwise operations,
    the order K8 repeats on the card) against the JAX package's einsum, bit
    for bit (the float32 maps' uint32 views, so NaN and inf too), both views
    of a rectified pair at the working sizes and a ragged one; one rig with
    a skewed K (K01 != 0)."""
    cams = jcam.synthetic_rig(2, span_deg=11.0, image_size=size)
    K0 = np.asarray(cams[0].K, np.float64).copy()
    K0[0, 1] = skew
    K1 = np.asarray(cams[1].K, np.float64)
    rect = t_rectify_pair(K0, np.asarray(cams[0].Rt, np.float64), K1,
                          np.asarray(cams[1].Rt, np.float64), size, size)
    for view, (K, R, P) in enumerate(((K0, rect.R1, rect.P1_scaled),
                                      (K1, rect.R2, rect.P2_scaled))):
        ref = jremap.rectify_map(K, R, P, size)
        got = tremap.rectify_map(K, R, P, size)
        for name, a, b in zip(("map_x", "map_y"), ref, got):
            assert a.shape == (size[1], size[0]) and a.dtype == b.dtype == np.float32
            assert_equal(a.view(np.uint32), b.view(np.uint32), f"view {view} {name}")


def test_rectify_map_wrapper_on_the_cpu():
    """K8's wrapper on the CPU: the plain version's arrays as tensors, no
    launch; another device than the CPU or CUDA raises."""
    from reconstruction_tpu_torch.ops import rectify_map as K8
    cams = tcam.synthetic_rig(2, span_deg=11.0, image_size=(61, 47))
    rect = t_rectify_pair(cams[0].K, cams[0].Rt, cams[1].K, cams[1].Rt,
                          (61, 47), (61, 47))
    M = tremap.rectify_inverse(rect.R1, rect.P1_scaled)
    n0 = K8.rectify_map.launches
    got = K8.rectify_map(M, cams[0].K, (61, 47), "cpu")
    ref = tremap.rectify_map(cams[0].K, rect.R1, rect.P1_scaled, (61, 47))
    for a, b in zip(ref, got):
        assert b.device.type == "cpu"
        assert_equal(a.view(np.uint32), b.numpy().view(np.uint32), "K8 wrapper, CPU")
    assert K8.rectify_map.launches == n0
    with pytest.raises(RuntimeError, match="no kernel"):
        K8.rectify_map(M, cams[0].K, (61, 47), "meta")
    with pytest.raises(ValueError):
        K8.rectify_map(M[:2], cams[0].K, (61, 47), "cpu")


@pytest.mark.parametrize("channels", [3, 1])
def test_remap_bilinear_exact(rng, channels):
    shape = (50, 60, channels) if channels > 1 else (50, 60)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    mx = rng.uniform(-3, 63, (40, 50)).astype(np.float32)
    my = rng.uniform(-3, 53, (40, 50)).astype(np.float32)
    ref = jremap.remap_bilinear(J(img), J(mx), J(my))
    got = tremap.remap_bilinear(T(img), T(mx), T(my))
    assert_equal(ref, got, "remap_bilinear")


def test_pyramid_and_quantize_exact(rng):
    img = rng.integers(0, 256, (96, 80, 3)).astype(np.float32)
    ref = jpyr.build_pyramid(J(img), 4)
    got = tpyr.build_pyramid(T(img), 4)
    for lvl, (a, b) in enumerate(zip(ref, got)):
        assert_equal(a, b, f"build_pyramid level {lvl}")
        assert_equal(jpyr.quantize_u8(a), tpyr.quantize_u8(b), f"quantize {lvl}")
    noisy = rng.uniform(-20, 280, (33, 47)).astype(np.float32)
    noisy[0, :4] = [0.5, 1.5, 2.5, 254.5]          # half-to-even ties
    assert_equal(jpyr.pyr_down(J(noisy)), tpyr.pyr_down(T(noisy)), "pyr_down 2d")
    assert_equal(jpyr.quantize_u8(J(noisy)), tpyr.quantize_u8(T(noisy)), "quantize")


@pytest.mark.parametrize("shape", [(3, 3), (5, 4), (135, 240), (33, 47, 3), (3, 5, 1),
                                   (27, 8, 3), (9, 11, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pyr_down_plain_equals_jax_at_odd_shapes(rng, shape):
    """The port's plain pyr_down (the reference K9 is held to on the card)
    against the JAX package's, bit for bit: odd and smallest sides, 2-D and
    1-, 2- and 3-channel inputs, values off the uint8 grid and negative
    (normal floats only: XLA:CPU flushes subnormals)."""
    img = rng.uniform(-300, 300, shape).astype(np.float32)
    img.flat[::7] = np.round(img.flat[::7])
    ref, got = jpyr.pyr_down(J(img)), tpyr.pyr_down(T(img))
    assert tuple(got.shape) == (-(-shape[0] // 2), -(-shape[1] // 2), *shape[2:])
    assert_equal(np.asarray(ref).view(np.uint32), to_np(got).view(np.uint32), "pyr_down")


@pytest.mark.parametrize("quantize", [False, True], ids=["levels", "quantized"])
def test_pyramid_wrapper_on_the_cpu(rng, quantize):
    """K9's wrapper on CPU tensors: the plain version's bits, no launch
    (`pyr_down`, and `build_pyramid` with and without its rounded levels);
    a side under 3 raises where the plain version raises; a device other
    than the CPU or CUDA raises."""
    import torch
    from reconstruction_tpu_torch.ops import pyramid as K9
    img = T(rng.uniform(-20, 280, (45, 38, 3)).astype(np.float32))
    n0 = K9.pyr_down.launches
    assert_equal(tpyr.pyr_down(img).numpy().view(np.uint32),
                 K9.pyr_down(img).numpy().view(np.uint32), "K9 wrapper, CPU")
    ref = tpyr.build_pyramid(img, 4)
    if quantize:
        ref = [tpyr.quantize_u8(p) for p in ref]
    got = K9.build_pyramid(img, 4, quantize=quantize)
    assert len(got) == 4
    for lvl, (a, b) in enumerate(zip(ref, got)):
        assert b.device.type == "cpu"
        assert_equal(a.numpy().view(np.uint32), b.numpy().view(np.uint32), f"level {lvl}")
    assert K9.pyr_down.launches == n0
    for bad in ((2, 9), (9, 2), (1, 1, 3), (9,)):
        x = torch.zeros(bad)
        with pytest.raises((IndexError, RuntimeError)):
            tpyr.pyr_down(x)
        with pytest.raises((IndexError, RuntimeError)):
            K9.pyr_down(x)
    with pytest.raises(RuntimeError, match="no kernel"):
        K9.pyr_down(torch.zeros((8, 8), device="meta"))


@pytest.mark.parametrize("se", [3, 4, 7, 24])
def test_erode_mask_exact(rng, se):
    mask = np.where(rng.uniform(size=(64, 72)) < 0.93, 255.0, 0.0).astype(np.float32)
    mask[:, :3] = 0.0
    mask[5, 10] = 254.0                               # below the threshold
    assert_equal(jmorph.erode_mask(J(mask), se), tmorph.erode_mask(T(mask), se),
                 f"erode se={se}")
    assert_equal(jmorph.ellipse_kernel(se, se), tmorph.ellipse_kernel(se, se))
    v = mask >= 254.5
    se_k = jmorph.ellipse_kernel(se, se)
    assert_equal(jmorph.erode_binary_np(v, se_k), tmorph.erode_binary_np(v, se_k))


def test_find_margin_and_inner_box_exact(rng):
    for p in (0.2, 0.02, 0.0):
        v = rng.uniform(size=(30, 40)) < p
        mj = jmarg.find_margin(J(v), 2)
        mt = tmarg.find_margin(T(v), 2)
        assert [int(a) for a in mj] == [int(b) for b in mt]
        for inset in (0, 1):
            assert_equal(jmarg.inner_box(mj, 30, 40, inset),
                         tmarg.inner_box(mt, 30, 40, inset), "inner_box")


def test_synthetic_rig_exact():
    for n, span in ((2, 7.0), (3, 24.0)):
        ref = jcam.synthetic_rig(n, radius=8.0, span_deg=span, focal=256.0,
                                 image_size=(160, 120))
        got = tcam.synthetic_rig(n, radius=8.0, span_deg=span, focal=256.0,
                                 image_size=(160, 120))
        for a, b in zip(ref, got):
            assert_equal(a.K, b.K, "K")
            assert_equal(a.Rt, b.Rt, "Rt")


def test_render_view_matches_reference_scene():
    """Port scene (torch float64) vs the reference test scene (numpy) at
    160x120: masks equal except where a ray grazes the patch border, and
    colours within 1e-3 of 255 (sin/cos last-bit differences only)."""
    cj, ij, mj = jsyn.make_stereo_scene(image_size=(160, 120), span_deg=7.0)
    ct, it, mt = tsyn.make_stereo_scene(image_size=(160, 120), span_deg=7.0)
    for a, b in zip(mj, mt):
        assert (a == b).mean() > 0.999
    for a, b, ma, mb in zip(ij, it, mj, mt):
        both = (ma > 0) & (mb > 0)
        assert np.abs(a - b)[both].max() < 1e-3
    pts = np.stack(np.meshgrid(np.linspace(-1, 1, 7), np.linspace(-1, 1, 5)), -1)
    assert_equal(jsyn.surface_fn(pts[..., 0], pts[..., 1]),
                 tsyn.surface_fn(pts[..., 0], pts[..., 1]), "surface_fn")
