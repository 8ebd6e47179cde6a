"""Port vs reference: the tensor-core NCC sweep (K5's plain version, through
the entry point `ncc_sweep_match_mxu`) against the reference's Pallas MXU
kernel in interpret mode, bit for bit; and against the port's K1 sweep."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import J, T, assert_equal

from reconstruction_tpu.core.pyramid import quantize_u8
from reconstruction_tpu.ops.ncc_sweep_mxu import ncc_sweep_match_mxu as j_mxu
from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
from reconstruction_tpu_torch.stereo.matching import (_centered, ncc_sweep_match,
                                                      sweep_moments)


def _case(rng, H, W, C, lo0, wid):
    """tests/test_ops_pallas.py:181's inputs: quantized images, random
    validity and activity, per-pixel bounds [x + lo0.., + wid]."""
    shape = (H, W, C) if C == 3 else (H, W)
    iL = np.asarray(quantize_u8(jnp.asarray(rng.uniform(0, 255, shape).astype(np.float32))))
    iR = np.asarray(quantize_u8(jnp.asarray(rng.uniform(0, 255, shape).astype(np.float32))))
    vR = rng.uniform(size=(H, W)) > 0.1
    act = rng.uniform(size=(H, W)) > 0.3
    x = np.arange(W)[None, :]
    lo = np.clip(x + rng.integers(lo0, 1, (H, W)), 0, W - 1).astype(np.int32)
    hi = np.clip(lo + rng.integers(0, wid + 1, (H, W)), 0, W - 1).astype(np.int32)
    return iL.astype(np.float32), iR.astype(np.float32), vR, act, lo, hi


# Two of the reference's three shapes (the 17x200 one takes most of that
# test's time), and one with the shift range clipped by a small pad_shift:
# bounds reach +-40, the sweep starts at -16 and runs one 128-shift chunk.
@pytest.mark.parametrize("H,W,C,lo0,wid,ps", [(24, 128, 3, -20, 40, 128),
                                              (12, 96, 1, -5, 10, 128),
                                              (10, 64, 1, -40, 80, 16)])
def test_mxu_sweep_plain_matches_pallas_interpret(H, W, C, lo0, wid, ps):
    iL, iR, vR, act, lo, hi = _case(np.random.default_rng(0), H, W, C, lo0, wid)
    ref = j_mxu(J(iL), J(iR), J(vR), J(act), J(lo), J(hi), 2, pad_shift=ps,
                interpret=True)
    n0 = K5.ncc_sweep_mxu.launches
    got = K5.ncc_sweep_match_mxu(T(iL), T(iR), T(vR), T(act), T(lo), T(hi), 2,
                                 pad_shift=ps)
    assert K5.ncc_sweep_mxu.launches == n0   # the CPU path launches nothing
    assert_equal(ref.disparity, got.disparity, "disparity")
    assert_equal(ref.score, got.score, "score")
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
