"""Port vs reference: the banded cost volume and the subpixel refine,
both bit-equal (the refine follows the reference's compiled exp and
fused multiply-adds; without them, ULP differences flip trunc(d - 1.5)
anchors within two sweeps on a smooth scene).  The port's volume is
slot-major, (H, s_cap, W); it is compared with the reference's
(H, W, s_cap) after swapping its last two axes."""

import numpy as np
import pytest

from torch_parity import J, T, assert_equal, margins, u8_image

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.ops.refine_pallas import disparity_refine_pallas
from reconstruction_tpu.stereo import refine as jr
from reconstruction_tpu_torch.stereo import refine as tr


def _scene(rng, H=48, W=40):
    """tests/test_ops_pallas.py's refine scene, on the uint8 grid."""
    imgL = u8_image(rng, (H, W, 3))
    imgR = u8_image(rng, (H, W, 3))
    disp = rng.integers(-2, 3, (H, W)).astype(np.float32)
    valid = np.zeros((H, W), bool)
    valid[3:-3, 3:-3] = True
    disp[~valid] = NOMATCH
    disp[rng.uniform(size=(H, W)) < 0.15] = NOMATCH
    return imgL, imgR, disp, valid


@pytest.fixture(scope="module")
def scene():
    return _scene(np.random.default_rng(21))


@pytest.mark.parametrize("s_cap,band,drift", [(32, 8, 16), (128, 16, 16),
                                              (64, 48, 4)])
def test_banded_cost_volume_exact(scene, s_cap, band, drift):
    imgL, imgR, disp, _ = scene
    d = disp.copy()
    d[:8] += 9.0 * (d[:8] != NOMATCH)      # bands with different ranges
    cv_r, base_r = jr._banded_cost_volume(J(imgL), J(imgR), J(d), s_cap, band,
                                          drift=drift)
    cv_g, base_g = tr._banded_cost_volume(T(imgL), T(imgR), T(d), s_cap, band,
                                          drift=drift)
    assert_equal(base_r, base_g, "base")
    assert_equal(cv_r, cv_g.permute(0, 2, 1), "cv")


@pytest.mark.parametrize("s_cap,band", [(32, 8), (1, 16)])
def test_banded_cost_volume_clamps_slots_beyond_the_image(scene, s_cap, band):
    """Bands whose disparities lie beyond +-W: the reference's clamped
    dynamic_update_slice leaves the band's last shift in its edge slot
    (slot 0 above the image width, slot s_cap - 1 below it); bit-equal."""
    imgL, imgR, disp, _ = scene
    W = disp.shape[1]
    d = disp.copy()
    ok = d != NOMATCH
    d[:16] = np.where(ok[:16], W + 100.0, NOMATCH)
    d[16:32] = np.where(ok[16:32], -(W + 100.0), NOMATCH)
    cv_r, base_r = jr._banded_cost_volume(J(imgL), J(imgR), J(d), s_cap, band)
    cv_g, base_g = tr._banded_cost_volume(T(imgL), T(imgR), T(d), s_cap, band)
    assert_equal(base_r, base_g, "base")
    assert_equal(cv_r, cv_g.permute(0, 2, 1), "cv")
    assert (np.asarray(cv_r)[:16, :, 0] != 0.5).any()          # edge writes
    assert (np.asarray(cv_r)[16:32, :, s_cap - 1] != 0.5).any()


def test_resolve_recenter_matches():
    for it in (12, 24, 30, 60, 90, 120):
        for rc in (-1, 0, 12, 30):
            assert jr.resolve_recenter(it, rc) == tr.resolve_recenter(it, rc)


@pytest.mark.parametrize("iterations,recenter", [(12, 0), (24, -1), (30, 12),
                                                  (120, -1)])
def test_refine_vs_xla_path(scene, iterations, recenter):
    """24 sweeps with auto recentering cross the re-extraction at sweep 12."""
    imgL, imgR, disp, valid = scene
    mj, mt = margins(valid)
    ref = jr.disparity_refine(J(disp), J(imgL), J(imgR), mj,
                              iterations=iterations, s_cap=32, band=8,
                              recenter_every=recenter)
    got = tr.disparity_refine(T(disp), T(imgL), T(imgR), mt,
                              iterations=iterations, s_cap=32, band=8,
                              recenter_every=recenter)
    assert_equal(ref, got, f"refine {iterations}/{recenter}")
    moved = (np.asarray(ref) != disp) & (disp != NOMATCH)
    assert moved.mean() > 0.3


def test_refine_vs_pallas_kernel(scene):
    """Against the TPU kernel B1 (interpret mode), with auto recentering."""
    imgL, imgR, disp, valid = scene
    mj, mt = margins(valid)
    ref = disparity_refine_pallas(J(disp), J(imgL), J(imgR), mj, iterations=24,
                                  s_cap=32, band=8, T=6, block=16,
                                  interpret=True, recenter_every=-1)
    got = tr.disparity_refine(T(disp), T(imgL), T(imgR), mt, iterations=24,
                              s_cap=32, band=8, recenter_every=-1)
    assert_equal(ref, got, "refine vs pallas")


@pytest.mark.parametrize("n", [5, 12, 13])
def test_fused_sweeps_equal_single_sweeps(scene, n):
    """n single sweeps and refine_sweeps_fused (the plain version on the
    CPU), one window each, equal the reference's n sweeps without a
    re-extraction, for n below, at and off a multiple of the kernel's
    T = 6; refine_sweeps equals it across a re-extraction."""
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.margins import inner_box
    imgL, imgR, disp, valid = scene
    mj, mt = margins(valid)
    H, W = disp.shape
    cv, base = tr._banded_cost_volume(T(imgL), T(imgR), T(disp), 32, 8)
    inner = inner_box(mt, H, W, inset=1)
    d = T(disp)
    j0, jref = K2.window_anchors(d, base)
    single = d
    for _ in range(n):
        single = K2.refine_sweep(single, cv, j0, jref, inner, 0.03)
    fused = K2.refine_sweeps_fused(d, cv, j0, jref, inner, 0.03, n)
    ref = jr.disparity_refine(J(disp), J(imgL), J(imgR), mj, iterations=n,
                              s_cap=32, band=8, recenter_every=0)
    assert_equal(ref, single, f"{n} single sweeps")
    assert_equal(ref, fused, f"fused {n}")
    assert (fused.numpy() != disp).mean() > 0.3
    ref = jr.disparity_refine(J(disp), J(imgL), J(imgR), mj, iterations=2 * n,
                              s_cap=32, band=8, recenter_every=n)
    got = K2.refine_sweeps(d, cv, base, inner, 2 * n, 0.03, n)
    assert_equal(ref, got, f"refine_sweeps {2 * n}/{n}")


def test_fma32_and_exp_round_like_the_reference(rng):
    """The two rounding primitives the port copies from the reference's
    compiled code: a fused multiply-add (XLA:CPU contracts a*b+c) and
    XLA:CPU's float32 exp, over non-positive arguments (the refine's
    exp(-a^2)), including the flush of results below FLT_MIN."""
    import jax
    from reconstruction_tpu_torch.utils.fp import exp_xla, fma32
    a, b, c = (rng.standard_normal(200_000).astype(np.float32) * s
               for s in (1.0, 3.0, 1e-3))
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    assert_equal(ref, fma32(T(a), T(b), T(c)), "fma32")
    x = np.concatenate([-rng.uniform(0, 1, 200_000) ** 2 * 100,
                        -np.arange(0, 120, 0.01),
                        [-1e8, -np.inf]]).astype(np.float32)
    assert_equal(np.asarray(jax.jit(jax.numpy.exp)(x)), exp_xla(T(x)), "exp")
