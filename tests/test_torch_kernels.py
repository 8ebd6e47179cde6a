"""Kernels K1 (sweep), K3 (cost volume, slot-major), K2 (refine sweeps, T a
launch), K4 (BA coupling) and K5 (tensor-core sweep) against their plain
PyTorch versions on the card.  CUDA only: skipped on a machine
without a GPU (there is no interpret mode for a CUDA kernel).  On the
card (whose machine has no jax for tests/conftest.py):
python -m pytest --noconftest tests/test_torch_kernels.py -q"""

import numpy as np
import pytest
import torch

from reconstruction_tpu_torch.config import NOMATCH

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(dev, H=200, W=160, d=12, seed=3):
    from reconstruction_tpu_torch.stereo.matching import _centered, ncc_moments
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randint(0, 256, (H, W + d, 3), generator=g, device=dev).float()
    L, R = _centered(base[:, d:]), _centered(base[:, :W])
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    valid = (yy > 4) & (yy < H - 5) & (xx > 4) & (xx < W - 5)
    return L, R, valid, ncc_moments


@pytest.mark.parametrize("radius,width", [(2, 63), (1, 5), (2, 300)])
def test_k1_sweep_equals_plain(dev, radius, width):
    from reconstruction_tpu_torch.ops import ncc_sweep as K
    L, R, valid, moments = _scene(dev)
    H, W = valid.shape
    mL, mR = moments(L, radius), moments(R, radius)
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    lo = torch.clamp(x - width // 2, min=0).contiguous()
    hi = torch.clamp(x + width // 2, max=W - 1).contiguous()
    args = (L, R, (mL.n * mL.mean).contiguous(), mL.inv_norm, mR.mean,
            mR.inv_norm, valid, valid, lo, hi, radius)
    n0 = K.ncc_sweep.launches
    sk, tk = K.ncc_sweep(*args)
    sp, tp = K.ncc_sweep_plain(*args)
    assert K.ncc_sweep.launches == n0 + 1
    assert torch.equal(sk, sp) and torch.equal(tk, tp)


def test_k3_cost_volume_equals_plain(dev):
    from reconstruction_tpu_torch.ops import ncc_sweep as K
    from reconstruction_tpu_torch.stereo.refine import _band_ranges
    L, R, valid, moments = _scene(dev)
    H, W = valid.shape
    d = torch.where(valid, torch.full((H, W), 12.0, device=dev),
                    torch.tensor(float(NOMATCH), device=dev))
    base_b, lo_b, hi_b = _band_ranges(d, 64, 48, 16)
    m, mR = moments(L, 1), moments(R, 1)
    args = (L, R, (m.n * m.mean).contiguous(), m.inv_norm, mR.mean,
            mR.inv_norm, base_b, lo_b, hi_b, 64, 48)
    n0 = K.cost_volume.launches
    cvk = K.cost_volume(*args)
    assert K.cost_volume.launches == n0 + 1
    assert cvk.shape == (H, 64, W)
    assert torch.equal(cvk, K.cost_volume_plain(*args))
    with pytest.raises(ValueError):
        K.cost_volume(L + 0.5, *args[1:])


def test_k2_refine_sweeps_equal_plain(dev):
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.refine import _banded_cost_volume
    L, R, valid, _ = _scene(dev)
    H, W = valid.shape
    g = torch.Generator(device=dev).manual_seed(5)
    d = torch.where(valid, 12.0 + torch.randint(-2, 3, (H, W), generator=g,
                                                device=dev).float(),
                    torch.tensor(float(NOMATCH), device=dev))
    cv, base = _banded_cost_volume(L + 128, R + 128, d, 64, 48)
    j0, jref = K2.window_anchors(d, base)
    dk = dp = d
    for _ in range(30):
        dk = K2.refine_sweep(dk, cv, j0, jref, valid, 0.03)
        dp = K2.refine_sweep_plain(dp, cv, j0, jref, valid, 0.03)
    assert torch.equal(dk == NOMATCH, dp == NOMATCH)
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("n", [1, 5, 6, 12, 13])
def test_k2_fused_sweeps_equal_plain(dev, n):
    """n sweeps in ceil(n / T) launches equal n plain sweeps, also across a
    window re-extraction (refine_sweeps with recenter_every = n)."""
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.refine import _banded_cost_volume
    L, R, valid, _ = _scene(dev, H=300, W=260)
    H, W = valid.shape
    g = torch.Generator(device=dev).manual_seed(n)
    d = torch.where(valid, 12.0 + torch.randint(-2, 3, (H, W), generator=g,
                                                device=dev).float(),
                    torch.tensor(float(NOMATCH), device=dev))
    cv, base = _banded_cost_volume(L + 128, R + 128, d, 64, 48)
    j0, jref = K2.window_anchors(d, base)
    n0 = K2.refine_sweeps_fused.launches
    dk = K2.refine_sweeps_fused(d, cv, j0, jref, valid, 0.03, n)
    assert K2.refine_sweeps_fused.launches == n0 + -(-n // K2.SWEEPS_PER_LAUNCH)
    dp = K2.refine_sweeps_fused_plain(d, cv, j0, jref, valid, 0.03, n)
    assert torch.equal(dk, dp)
    assert bool((dk != d)[valid].float().mean() > 0.3)
    rk = K2.refine_sweeps(d, cv, base, valid, 2 * n, 0.03, n)
    rp = d
    for _ in range(2):
        ja, jb = K2.window_anchors(rp, base)
        rp = K2.refine_sweeps_fused_plain(rp, cv, ja, jb, valid, 0.03, n)
    assert torch.equal(rk, rp)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from reconstruction_tpu_torch.ops import refine as K2
    d = torch.zeros((8, 8), device=dev)
    args = (torch.zeros((8, 4, 8), device=dev),
            torch.zeros((8, 8), dtype=torch.int32, device=dev), d,
            torch.ones((8, 8), dtype=torch.bool, device=dev), 0.03)
    with pytest.raises(TypeError):
        K2.refine_sweep(d.double(), *args)
    with pytest.raises(ValueError):   # a (H, W, s_cap) volume
        K2.refine_sweeps_fused(d, args[0].permute(0, 2, 1), *args[1:], 6)


def test_k3_cost_volume_clamped_edge_slots_equal_plain(dev):
    """Bands whose range lies beyond +-W write their last shift into the
    edge slot (the reference's clamped dynamic_update_slice)."""
    from reconstruction_tpu_torch.ops import ncc_sweep as K
    from reconstruction_tpu_torch.stereo.refine import _band_ranges
    L, R, valid, moments = _scene(dev)
    H, W = valid.shape
    d = torch.where(valid, torch.full((H, W), 12.0, device=dev),
                    torch.tensor(float(NOMATCH), device=dev))
    d[:48] = torch.where(valid[:48], W + 100.0, float(NOMATCH))
    d[48:96] = torch.where(valid[48:96], -(W + 100.0), float(NOMATCH))
    m, mR = moments(L, 1), moments(R, 1)
    for s_cap in (64, 1):
        base_b, lo_b, hi_b = _band_ranges(d, s_cap, 48, 16)
        args = (L, R, (m.n * m.mean).contiguous(), m.inv_norm, mR.mean,
                mR.inv_norm, base_b, lo_b, hi_b, s_cap, 48)
        cvk = K.cost_volume(*args)
        assert torch.equal(cvk, K.cost_volume_plain(*args))
        assert bool((cvk[:48, 0] != 0.5).any())
        assert bool((cvk[48:96, s_cap - 1] != 0.5).any())


@pytest.mark.parametrize("O,M", [(8, 1000), (3, 257), (20, 64)])
def test_k4_ba_coupling_equals_plain(dev, O, M):
    from reconstruction_tpu_torch.ops import ba_coupling as K4
    g = torch.Generator(device=dev).manual_seed(O)
    E, C = 18, 16
    He = torch.randn((E, O, M), generator=g, device=dev)
    cam = torch.randint(-1, C, (O, M), generator=g, device=dev,
                        dtype=torch.int32)
    n0 = K4.ba_coupling.launches
    Wk = K4.ba_coupling(He, cam, C)
    assert K4.ba_coupling.launches == n0 + 1
    assert torch.equal(Wk, K4.ba_coupling_plain(He, cam, C))
    with pytest.raises(TypeError):
        K4.ba_coupling(He.double(), cam, C)


@pytest.mark.parametrize("C,radius,lo0,wid,ps", [(3, 2, -20, 40, 128),
                                                 (1, 2, -5, 10, 128),
                                                 (3, 1, -150, 300, 256),
                                                 (1, 2, -40, 80, 16)])
def test_k5_mxu_sweep_equals_plain_and_k1(dev, C, radius, lo0, wid, ps):
    from reconstruction_tpu_torch.ops import ncc_sweep as K1
    from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
    L, R, valid, moments = _scene(dev)
    L, R = L[..., :C].contiguous(), R[..., :C].contiguous()
    H, W = valid.shape
    g = torch.Generator(device=dev).manual_seed(C * 100 + wid)
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    lo = torch.clamp(x + torch.randint(lo0, 1, (H, W), generator=g, device=dev,
                                       dtype=torch.int32), 0, W - 1)
    hi = torch.clamp(lo + torch.randint(0, wid + 1, (H, W), generator=g,
                                        device=dev, dtype=torch.int32), 0, W - 1)
    active = valid & (torch.rand((H, W), generator=g, device=dev) > 0.3)
    mL, mR = moments(L, radius), moments(R, radius)
    args = (L, R, (mL.n * mL.mean).contiguous(), mL.inv_norm, mR.mean,
            mR.inv_norm, valid, active, lo.contiguous(), hi.contiguous(), radius)
    n0 = K5.ncc_sweep_mxu.launches
    sk, tk = K5.ncc_sweep_mxu(*args, pad_shift=ps)
    assert K5.ncc_sweep_mxu.launches == n0 + 1
    sp, tp = K5.ncc_sweep_mxu_plain(*args, pad_shift=ps)
    assert torch.equal(sk, sp) and torch.equal(tk, tp)
    s_lo = int(torch.where(active, lo - x, 1 << 20).min())
    s_hi = int(torch.where(active, hi - x, -(1 << 20)).max())
    if -ps <= s_lo <= ps - 1 and s_hi <= ps:   # nothing clipped: K1's result
        s1, t1 = K1.ncc_sweep(*args)
        assert torch.equal(sk, s1) and torch.equal(tk, t1)
    with pytest.raises(ValueError):
        K5.ncc_sweep_mxu(L + 0.5, *args[1:], pad_shift=ps)
