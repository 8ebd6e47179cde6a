"""Port vs reference: the tensor-core NCC sweep (K5's plain version, through
the entry point `ncc_sweep_match_mxu`) against the reference's Pallas MXU
kernel in interpret mode, bit for bit; against the port's K1 sweep; and the
kernel's mma operands (one k32 step a window row) against the reference's
window sums."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import J, T, assert_equal

from reconstruction_tpu.core.pyramid import quantize_u8
from reconstruction_tpu.stereo.ncc import shifted as j_shifted
from reconstruction_tpu.ops.ncc_sweep_mxu import ncc_sweep_match_mxu as j_mxu
from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
from reconstruction_tpu_torch.stereo.matching import (_centered, ncc_sweep_match,
                                                      sweep_moments)


def _case(rng, H, W, C, lo0, wid, active=True):
    """tests/test_ops_pallas.py:181's inputs: quantized images, random
    validity and activity (none if not ``active``), per-pixel bounds
    [x + lo0.., + wid]."""
    shape = (H, W, C) if C == 3 else (H, W)
    iL = np.asarray(quantize_u8(jnp.asarray(rng.uniform(0, 255, shape).astype(np.float32))))
    iR = np.asarray(quantize_u8(jnp.asarray(rng.uniform(0, 255, shape).astype(np.float32))))
    vR = rng.uniform(size=(H, W)) > 0.1
    act = (rng.uniform(size=(H, W)) > 0.3) & active
    x = np.arange(W)[None, :]
    lo = np.clip(x + rng.integers(lo0, 1, (H, W)), 0, W - 1).astype(np.int32)
    hi = np.clip(lo + rng.integers(0, wid + 1, (H, W)), 0, W - 1).astype(np.int32)
    return iL.astype(np.float32), iR.astype(np.float32), vR, act, lo, hi


# Two of the reference's three shapes (the 17x200 one takes most of that
# test's time); one with the shift range clipped by a small pad_shift:
# bounds reach +-40, the sweep starts at -16 and runs one 128-shift chunk;
# one whose range (-100 .. +128 after the clip) takes two chunks; and one
# without an active pixel.
@pytest.mark.parametrize("H,W,C,lo0,wid,ps,active", [
    (24, 128, 3, -20, 40, 128, True), (12, 96, 1, -5, 10, 128, True),
    (10, 64, 1, -40, 80, 16, True), (6, 136, 1, -100, 200, 128, True),
    (8, 64, 1, -20, 40, 128, False)])
def test_mxu_sweep_plain_matches_pallas_interpret(H, W, C, lo0, wid, ps, active):
    iL, iR, vR, act, lo, hi = _case(np.random.default_rng(0), H, W, C, lo0, wid,
                                    active)
    ref = j_mxu(J(iL), J(iR), J(vR), J(act), J(lo), J(hi), 2, pad_shift=ps,
                interpret=True)
    n0 = K5.ncc_sweep_mxu.launches
    got = K5.ncc_sweep_match_mxu(T(iL), T(iR), T(vR), T(act), T(lo), T(hi), 2,
                                 pad_shift=ps)
    assert K5.ncc_sweep_mxu.launches == n0   # the CPU path launches nothing
    assert_equal(ref.disparity, got.disparity, "disparity")
    assert_equal(ref.score, got.score, "score")
    if not active:
        assert bool((got.score == -1).all())
    if ps >= W:   # nothing clipped: the same as the K1 sweep
        k1 = ncc_sweep_match(T(iL), T(iR), T(vR), T(act), T(lo), T(hi), 2)
        assert_equal(k1.disparity, got.disparity, "vs K1 disparity")
        assert_equal(k1.score, got.score, "vs K1 score")


def test_mxu_sweep_refuses_images_off_the_integer_grid():
    rng = np.random.default_rng(1)
    iL, iR, vR, act, lo, hi = _case(rng, 8, 16, 3, -3, 6)
    L, R = _centered(T(iL)), _centered(T(iR))
    args = sweep_moments(L, R, 2)
    bad = L.clone()
    bad[0, 0, 0] = 0.5
    with pytest.raises(ValueError):
        K5.ncc_sweep_mxu(bad, R, *args, T(vR), T(act), T(lo), T(hi), 2)
    with pytest.raises(ValueError):
        K5.ncc_sweep_mxu(L, R + 200.0, *args, T(vR), T(act), T(lo), T(hi), 2)
    score, t = K5.ncc_sweep_mxu(L, R, *args, T(vR), T(act), T(lo), T(hi), 2)
    assert score.dtype == torch.float32 and t.dtype == torch.int32


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_mma_operands_give_the_window_cross_sums(C, radius):
    """The kernel's operands (`mma_operands_plain`: int8x4 words, one k32
    step a window row, B's words past the window raw from the neighbouring
    pixels, A zero there): their integer product equals the window cross
    sums of the reference's zero-padded `shifted`, over the whole image
    (its edges too) and shifts either way."""
    rng = np.random.default_rng(10 * C + radius)
    H, W = 9, 21
    L = rng.integers(-128, 128, (H, W, C)).astype(np.int32)
    R = rng.integers(-128, 128, (H, W, C)).astype(np.int32)
    shifts = (-W + 2, 0, W - 3)

    def window_sums(Lj, Rj):   # one traced function: one compile a case
        return [sum((j_shifted(Lj, dy, dx) * j_shifted(Rj, dy, dx + s)).sum(-1)
                    for dy in range(-radius, radius + 1)
                    for dx in range(-radius, radius + 1)) for s in shifts]

    refs = jax.jit(window_sums)(J(L), J(R))
    for s, ref in zip(shifts, refs):
        A, B = K5.mma_operands_plain(T(L).float(), T(R).float(), radius, s)
        assert A.shape == B.shape == (H, W, 2 * radius + 1, 4 * K5.MMA_WORDS)
        d = 4 * (2 * radius + 1)   # bytes of a window row
        assert bool((A[..., d:] == 0).all())   # A is zero past the window
        if s == 0 and radius < 3:   # ... where B holds the neighbouring pixels
            assert bool((B[..., d:] != 0).any())
        got = K5.mma_cross_plain(T(L).float(), T(R).float(), radius, s)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy(), err_msg=f"s={s}")
