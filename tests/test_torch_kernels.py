"""Kernels K1 (sweep), K3 (cost volume, slot-major), K2 (refine sweeps, T a
launch), K4 (BA coupling) and K5 (tensor-core sweep) against their plain
PyTorch versions on the card.  CUDA only: skipped on a machine
without a GPU (there is no interpret mode for a CUDA kernel).  On the
card (whose machine has no jax for tests/conftest.py):
python -m pytest --noconftest tests/test_torch_kernels.py -q"""

import collections

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


def _k1_bounds(kind, H, W, valid, dev, seed=0):
    """(active, lo, hi) of one K1 case, and the modes some of its blocks
    must take ("sweep", "candidate" or both; none for no active pixel)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    y = torch.arange(H, dtype=i32, device=dev)[:, None]
    x = torch.arange(W, dtype=i32, device=dev)[None, :].expand(H, W)
    active = valid.clone()
    if kind == "shift64":                  # the bench cell: x .. x+63
        lo, hi, modes = x, x + 63, {"sweep"}
    elif kind == "negative":               # shifts -50 .. -10
        lo, hi, modes = x - 50, x - 10, {"sweep"}
    elif kind == "guided":                 # +-2 around a varying d, with holes
        d = 12 + (x // 17 + y // 11) % 5 - 2
        lo, hi = x + d - 2, x + d + 2
        hole = (torch.rand((H, W), generator=g, device=dev) < 0.01) & (y < H // 3)
        lo = torch.where(hole, x - 60, lo)
        hi = torch.where(hole, x + 60, hi)
        lo[H // 3], hi[H // 3] = 2, W - 3  # a row of holes with the whole span
        modes = {"sweep", "candidate"}
    elif kind == "rematch":                # sparse holes, wide bounds
        active &= torch.rand((H, W), generator=g, device=dev) < 0.03
        lo = x + torch.randint(-40, 1, (H, W), generator=g, device=dev, dtype=i32)
        hi = lo + torch.randint(0, 81, (H, W), generator=g, device=dev, dtype=i32)
        modes = {"candidate"}
    else:                                  # no active pixel
        active[:] = False
        lo, hi, modes = x, x + 8, set()
    return (active, lo.clamp(-5, W + 4).to(i32).contiguous(),
            hi.clamp(-5, W + 4).to(i32).contiguous(), modes)


@pytest.mark.parametrize("kind,H,W,C,radius,period", [
    ("shift64", 64, 300, 3, 2, 0), ("shift64", 40, 63, 1, 1, 0),
    ("shift64", 48, 300, 4, 3, 0), ("negative", 64, 300, 1, 2, 0),
    ("guided", 200, 300, 3, 2, 0), ("guided", 48, 1280, 3, 2, 0),
    ("guided", 64, 63, 1, 1, 0), ("rematch", 200, 300, 3, 2, 0),
    ("rematch", 48, 1280, 1, 1, 0), ("none", 64, 300, 3, 2, 0),
    ("shift64", 64, 300, 3, 2, 7), ("rematch", 200, 300, 3, 2, 7)])
def test_k1_sweep_equals_plain(dev, kind, H, W, C, radius, period):
    """K1 bit-equal to its plain sweep in both of its modes (the plan
    mirrors the kernel's per-block choice); with ``period``, R repeats
    along x, so targets ``period`` apart tie exactly and the first must
    win."""
    from reconstruction_tpu_torch.ops import ncc_sweep as K
    L, R, valid, moments = _scene(dev, H=H, W=W)
    L, R = (torch.cat([t, t[..., :C - 3]], -1) if C > 3 else t[..., :C]
            for t in (L, R))
    if period:
        R = R[:, :period].repeat(1, W // period + 1, 1)[:, :W]
    L, R = L.contiguous(), R.contiguous()
    active, lo, hi, modes = _k1_bounds(kind, H, W, valid, dev, seed=W + C)
    plan = K.sweep_plan(active, lo, hi, radius)
    taken = {m for m in ("sweep", "candidate") if plan[f"{m}_blocks"] > 0}
    assert modes <= taken and (modes or not taken), plan
    mL, mR = moments(L, radius), moments(R, radius)
    args = (L, R, (mL.n * mL.mean).contiguous(), mL.inv_norm, mR.mean,
            mR.inv_norm, valid, active, lo, hi, radius)
    n0 = K.ncc_sweep.launches
    sk, tk = K.ncc_sweep(*args)
    sp, tp = K.ncc_sweep_plain(*args)
    assert K.ncc_sweep.launches == n0 + 1
    assert torch.equal(sk, sp) and torch.equal(tk, tp)
    if modes:
        assert int((tk >= 0).sum()) > 0.5 * int(active.sum())
    else:
        assert bool((tk == -1).all() and (sk == -1).all())


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
    n0 = K.cost_volume.launches["rtt_cost_volume"]
    cvk = K.cost_volume(*args)
    assert K.cost_volume.launches["rtt_cost_volume"] == n0 + 1
    assert cvk.shape == (H, 64, W)
    assert torch.equal(cvk, K.cost_volume_plain(*args))
    with pytest.raises(ValueError):
        K.cost_volume(L + 0.5, *args[1:])
    with pytest.raises(TypeError):    # a float16 volume
        K.cost_volume(*args, dtype=torch.float16)


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
    n0 = K2.refine_sweeps_fused.launches["rtt_refine_sweeps"]
    dk = K2.refine_sweeps_fused(d, cv, j0, jref, valid, 0.03, n)
    assert (K2.refine_sweeps_fused.launches["rtt_refine_sweeps"]
            == n0 + -(-n // K2.SWEEPS_PER_LAUNCH))
    dp = K2.refine_sweeps_fused_plain(d, cv, j0, jref, valid, 0.03, n)
    assert torch.equal(dk, dp)
    assert bool((dk != d)[valid].float().mean() > 0.3)
    rk = K2.refine_sweeps(d, cv, base, valid, 2 * n, 0.03, n)
    rp = d
    for _ in range(2):
        ja, jb = K2.window_anchors(rp, base)
        rp = K2.refine_sweeps_fused_plain(rp, cv, ja, jb, valid, 0.03, n)
    assert torch.equal(rk, rp)


def test_k3_cost_volume_bf16_equals_plain(dev):
    """K3's bfloat16 instance: the float32 scores rounded at the store,
    bit-equal to the plain float32 volume cast to bfloat16, also on a row
    width off a multiple of 4 (its element stores)."""
    from reconstruction_tpu_torch.ops import ncc_sweep as K
    from reconstruction_tpu_torch.stereo.refine import _band_ranges
    for W in (160, 157):
        L, R, valid, moments = _scene(dev, W=W)
        H = valid.shape[0]
        d = torch.where(valid, torch.full((H, W), 12.0, device=dev),
                        torch.tensor(float(NOMATCH), device=dev))
        m, mR = moments(L, 1), moments(R, 1)
        args = (L, R, (m.n * m.mean).contiguous(), m.inv_norm, mR.mean,
                mR.inv_norm, *_band_ranges(d, 64, 48, 16), 64, 48)
        before = dict(K.cost_volume.launches)
        cvk = K.cost_volume(*args, dtype=torch.bfloat16)
        assert K.cost_volume.launches - collections.Counter(before) == {
            "rtt_cost_volume_bf16": 1}
        assert cvk.dtype == torch.bfloat16 and cvk.shape == (H, 64, W)
        plain = K.cost_volume_plain(*args, dtype=torch.bfloat16)
        assert torch.equal(cvk, plain)
        assert torch.equal(plain, K.cost_volume(*args).to(torch.bfloat16))


@pytest.mark.parametrize("n", [1, 6, 13])
def test_k2_fused_sweeps_bf16_equal_plain(dev, n):
    """K2's bfloat16 instance (taps widened exactly) against the plain
    sweeps on the same bfloat16 volume, also across a re-extraction."""
    from reconstruction_tpu_torch.ops import refine as K2
    from reconstruction_tpu_torch.stereo.refine import _banded_cost_volume
    L, R, valid, _ = _scene(dev, H=300, W=260)
    H, W = valid.shape
    g = torch.Generator(device=dev).manual_seed(n)
    d = torch.where(valid, 12.0 + torch.randint(-2, 3, (H, W), generator=g,
                                                device=dev).float(),
                    torch.tensor(float(NOMATCH), device=dev))
    cv, base = _banded_cost_volume(L + 128, R + 128, d, 64, 48, cv_dtype="bfloat16")
    assert cv.dtype == torch.bfloat16
    j0, jref = K2.window_anchors(d, base)
    before = dict(K2.refine_sweeps_fused.launches)
    dk = K2.refine_sweeps_fused(d, cv, j0, jref, valid, 0.03, n)
    assert K2.refine_sweeps_fused.launches - collections.Counter(before) == {
        "rtt_refine_sweeps_bf16": -(-n // K2.SWEEPS_PER_LAUNCH)}
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
    from reconstruction_tpu_torch.ops import ncc_sweep as K1
    from reconstruction_tpu_torch.ops import refine as K2
    L, R, valid, moments = _scene(dev, H=40, W=64)
    x = torch.arange(64, dtype=torch.int32, device=dev)[None, :].expand(40, 64)
    m, mR = moments(L, 2), moments(R, 2)
    args = (L, R, (m.n * m.mean).contiguous(), m.inv_norm, mR.mean,
            mR.inv_norm, valid, valid, x.contiguous(), (x + 8).contiguous(), 2)
    with pytest.raises(ValueError):   # off the integer grid
        K1.ncc_sweep(L + 0.5, *args[1:])
    with pytest.raises(ValueError):   # five channels
        L5 = torch.cat([L, L[..., :2]], -1).contiguous()
        K1.ncc_sweep(L5, torch.cat([R, R[..., :2]], -1).contiguous(), *args[2:])
    with pytest.raises(ValueError):   # a radius the kernel is not built for
        K1.ncc_sweep(*args[:-1], 4)
    d = torch.zeros((8, 8), device=dev)
    args = (torch.zeros((8, 4, 8), device=dev),
            torch.zeros((8, 8), dtype=torch.int32, device=dev), d,
            torch.ones((8, 8), dtype=torch.bool, device=dev), 0.03)
    with pytest.raises(TypeError):
        K2.refine_sweep(d.double(), *args)
    with pytest.raises(ValueError):   # a (H, W, s_cap) volume
        K2.refine_sweeps_fused(d, args[0].permute(0, 2, 1), *args[1:], 6)
    with pytest.raises(TypeError):    # a float16 volume
        K2.refine_sweeps_fused(d, args[0].half(), *args[1:], 6)


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


@pytest.mark.parametrize("kind,C,radius,lo0,wid,ps,H,W", [
    ("random", 3, 2, -20, 40, 128, 200, 160),
    ("random", 1, 2, -5, 10, 128, 200, 160),
    ("random", 3, 1, -150, 300, 256, 200, 160),
    ("random", 1, 2, -40, 80, 16, 200, 160),
    ("full", 3, 2, -128, 255, 128, 64, 300),    # two full chunks at +-128
    ("full", 1, 2, -300, 600, 512, 40, 700),    # the block's targets staged twice
    ("none", 3, 2, -20, 40, 128, 64, 300),      # no active pixel
    ("random", 3, 2, -20, 40, 128, 203, 301),   # H, W off the block's 4 x 64
    ("random", 4, 3, -30, 60, 128, 61, 150),    # r = 3, four channels
    ("fixed", 3, 2, -20, 40, 128, 64, 300)])    # a given shift range
def test_k5_mxu_sweep_equals_plain_and_k1(dev, kind, C, radius, lo0, wid, ps, H, W):
    """K5 bit-equal to its plain version, and to K1 wherever its shift range
    is not clipped; one launch counted a call; off-grid images raise."""
    from reconstruction_tpu_torch.ops import ncc_sweep as K1
    from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
    L, R, valid, moments = _scene(dev, H=H, W=W)
    L, R = (torch.cat([t, t[..., :C - 3]], -1) if C > 3 else t[..., :C]
            for t in (L, R))
    L, R = L.contiguous(), R.contiguous()
    g = torch.Generator(device=dev).manual_seed(C * 100 + wid)
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    if kind == "full":
        lo, hi = x + lo0, x + lo0 + wid
    else:
        lo = torch.clamp(x + torch.randint(lo0, 1, (H, W), generator=g, device=dev,
                                           dtype=torch.int32), 0, W - 1)
        hi = torch.clamp(lo + torch.randint(0, wid + 1, (H, W), generator=g,
                                            device=dev, dtype=torch.int32), 0, W - 1)
    active = valid & (torch.rand((H, W), generator=g, device=dev) > 0.3)
    if kind == "none":
        active[:] = False
    rng = dict(s_min=-7, s_max=33) if kind == "fixed" else {}
    mL, mR = moments(L, radius), moments(R, radius)
    args = (L, R, (mL.n * mL.mean).contiguous(), mL.inv_norm, mR.mean,
            mR.inv_norm, valid, active, lo.contiguous(), hi.contiguous(), radius)
    n0 = K5.ncc_sweep_mxu.launches
    sk, tk = K5.ncc_sweep_mxu(*args, pad_shift=ps, **rng)
    assert K5.ncc_sweep_mxu.launches == n0 + 1
    sp, tp = K5.ncc_sweep_mxu_plain(*args, pad_shift=ps, **rng)
    assert torch.equal(sk, sp) and torch.equal(tk, tp)
    if kind == "none":
        assert bool((tk == -1).all() and (sk == -1).all())
    else:
        assert int((tk >= 0).sum()) > 0.3 * int(active.sum())
    s_lo = int(torch.where(active, lo - x, 1 << 20).min())
    s_hi = int(torch.where(active, hi - x, -(1 << 20)).max())
    if not rng and -ps <= s_lo <= ps - 1 and s_hi <= ps:   # nothing clipped
        s1, t1 = K1.ncc_sweep(*args)
        assert torch.equal(sk, s1) and torch.equal(tk, t1)
    with pytest.raises(ValueError):
        K5.ncc_sweep_mxu(L + 0.5, *args[1:], pad_shift=ps)


def test_ncc_moments_card_equal_cpu(dev):
    """The card's NCC window moments equal the CPU's bit for bit (the
    inverse norm is an IEEE sqrt and divide on the card, not rsqrtf), on
    seeded images at 1280x1920x3 and on a flat patch (zero variance)."""
    from reconstruction_tpu_torch.stereo.matching import _centered, ncc_moments
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1920, 1280, 3)).astype(np.float32)
    img[100:140, 200:260] = 77.0
    for radius in (1, 2, 3):
        cpu = ncc_moments(_centered(torch.from_numpy(img)), radius)
        gpu = ncc_moments(_centered(torch.from_numpy(img).to(dev)), radius)
        assert torch.equal(cpu.mean, gpu.mean.cpu())
        assert torch.equal(cpu.inv_norm, gpu.inv_norm.cpu())
