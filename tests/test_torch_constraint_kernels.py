"""K6 (ordering) and K7 (bound propagation): the kernels' recurrences
written out in numpy, one step at a time in the order the kernels run
them, against the port's plain versions (`ops/constraints.py`) and the
JAX package on the same seeded inputs.

  * K6: a row's valid points compacted in column order, their crossing
    counts, then the greedy loop (first maximum, stop at 0), one row at a
    time: equal everywhere.
  * K7: the column pass (down, then up with the row-YL rule) one row at a
    time over all columns, and the row pass (forward, then backward with
    the absolute-column conversion) one column at a time over all rows:
    equal at every mask-valid source pixel, the contract; the entries
    elsewhere are counted and found equal too (every term that can win a
    max or min is a sum of small integers, so the order in which the
    +-1e9 sentinels are summed does not reach an output).

The `cuda` cases hold the kernels against their plain versions on the
card at the `myself` preset's finest level (H x W = 1920x1280, its
`finest_size` (1280, 1920) being width by height), at its transpose
(1280x1920, rows of 1920 columns) and at the dome's (2160x3840).  On the
card (whose machine has no jax for tests/conftest.py): python -m pytest
--noconftest tests/test_torch_constraint_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import constraints as K67
from reconstruction_tpu_torch.stereo import constraints as tc
from reconstruction_tpu_torch.stereo.margins import Margins

f32 = np.float32


# ---------------------------------------------------------------------------
# The kernels' recurrences in numpy
# ---------------------------------------------------------------------------

def k6_model(disp: np.ndarray, m) -> np.ndarray:
    """K6, one row at a time: compaction, initial counts, greedy loop."""
    H, W = disp.shape
    YL, YR, XL, XR = [int(v) for v in m]
    out = disp.copy()
    for y in range(H):
        if not YL <= y <= YR:
            continue
        xs = np.array([x for x in range(max(XL, 0), min(XR, W - 1) + 1)
                       if disp[y, x] != NOMATCH], dtype=np.int64)
        t = (disp[y, xs] + xs.astype(f32)).astype(f32)
        j = np.arange(len(xs))
        before = j[None, :] < j[:, None]
        cnt = ((before & (t[None, :] > t[:, None]))
               | (~before & (t[None, :] < t[:, None]))).sum(1)
        while len(cnt) and cnt.max() > 0:
            k = int(np.argmax(cnt))          # the first maximum
            cross = ((j < k) & (t > t[k])) | ((j > k) & (t < t[k]))
            cnt = np.where((cnt >= 0) & cross, cnt - 1, cnt)
            cnt[k] = -1                      # dead
            out[y, xs[k]] = NOMATCH
    return out


def k7_model(disp, valid, m_src, m_tgt, max_step=2):
    """K7: the column pass, then the row pass, each as its threads run it."""
    H, W = disp.shape
    YL, YR, XL, XR = [int(v) for v in m_src]
    tXL, tXR = f32(int(m_tgt[2])), f32(int(m_tgt[3]))
    yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
    mask = valid & (yy >= YL) & (yy <= YR) & (xx >= XL) & (xx <= XR)
    has_d = mask & (disp != NOMATCH)
    ref = np.where(has_d, disp, f32(0))
    MD, LO, HI, BIG, INF = f32(max_step), f32(-10000), f32(10000), f32(1e9), f32(np.inf)
    hole = mask & ~has_d
    s_lo, s_hi = np.where(hole, -MD, -BIG), np.where(hole, MD, BIG)
    m_lo = np.where(mask, np.maximum(np.where(has_d, ref - MD, LO), LO), LO)
    m_hi = np.where(mask, np.minimum(np.where(has_d, ref + MD, HI), HI), HI)

    # Column pass: a thread per column walks down, keeping each row's
    # carry-in, then up, combining.
    dn_lo, dn_hi = np.empty((H, W), f32), np.empty((H, W), f32)
    c_lo, c_hi = np.full(W, -INF), np.full(W, INF)
    for y in range(H):
        dn_lo[y] = LO if y == 0 else c_lo
        dn_hi[y] = HI if y == 0 else c_hi
        c_lo = np.maximum(c_lo + s_lo[y], m_lo[y])
        c_hi = np.minimum(c_hi + s_hi[y], m_hi[y])
    BL, BR = np.empty((H, W), f32), np.empty((H, W), f32)
    c_lo, c_hi = np.full(W, -INF), np.full(W, INF)
    for y in reversed(range(H)):
        up_lo = np.full(W, LO) if y == H - 1 else c_lo
        up_hi = np.full(W, HI) if y == H - 1 else c_hi
        at_yl = has_d[y] & (y == YL)
        BL[y] = np.where(at_yl, np.maximum(ref[y], up_lo),
                         np.where(has_d[y], ref[y], np.maximum(dn_lo[y], up_lo)))
        BR[y] = np.where(at_yl, np.minimum(ref[y], up_hi),
                         np.where(has_d[y], ref[y], np.minimum(dn_hi[y], up_hi)))
        c_lo = np.maximum(c_lo + s_lo[y], m_lo[y])
        c_hi = np.minimum(c_hi + s_hi[y], m_hi[y])

    # Row pass: a thread per row (and chain) walks right, then left.
    c_lo, c_hi = np.full(H, -INF), np.full(H, INF)
    for x in range(W):
        left = mask[:, x - 1] if x > 0 else np.zeros(H, bool)
        c_lo = np.maximum(c_lo + np.where(left, f32(-1), -BIG), BL[:, x])
        c_hi = np.minimum(c_hi + np.where(left, MD, BIG), BR[:, x])
        BL[:, x], BR[:, x] = c_lo, c_hi
    c_lo, c_hi = np.full(H, -INF), np.full(H, INF)
    for x in reversed(range(W)):
        xf, mk = f32(x), mask[:, x]
        inc_lo = np.full(H, -BIG) if x == W - 1 else c_lo
        inc_hi = np.full(H, BIG) if x == W - 1 else c_hi
        bl, br = BL[:, x].copy(), BR[:, x].copy()
        BL[:, x] = np.maximum(np.maximum(bl, inc_lo) + xf, tXL)
        BR[:, x] = np.minimum(np.minimum(br, inc_hi) + xf, tXR)
        c_lo = np.maximum(c_lo + np.where(mk, -MD, -BIG),
                          np.where(mk, np.maximum(bl, tXL - xf) - MD, -BIG))
        c_hi = np.minimum(c_hi + np.where(mk, f32(1), BIG),
                          np.where(mk, np.minimum(br, tXR - xf) + f32(1), BIG))
    return BL, BR, mask


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _margins(YL, YR, XL, XR):
    """(JAX Margins, port Margins) given explicitly."""
    import jax.numpy as jnp

    from reconstruction_tpu.stereo.margins import Margins as JMargins
    vals = (YL, YR, XL, XR)
    return (JMargins(*[jnp.int32(v) for v in vals]),
            Margins(*[torch.tensor(v, dtype=torch.int32) for v in vals]))


def _wide(rng, H=2, W=1920):
    d = rng.integers(-8, 9, (H, W)).astype(f32)
    d[rng.uniform(size=(H, W)) < 0.2] = NOMATCH
    v = np.ones((H, W), bool)
    v[:, :3] = False
    return d, v


def _edge_rows():
    """Rows with no valid point, with every pair crossing, with tied
    maxima, and a box of one row and one column."""
    H, W = 6, 40
    d = np.full((H, W), NOMATCH, f32)
    x = np.arange(W)
    d[1, 2:38] = (40 - 2 * x[2:38]).astype(f32)     # t = 40 - x: all cross
    d[2, 4:36] = 0
    d[2, 10:36:6], d[2, 11:36:6] = 3, 0             # pairs (t 13, 11), ...: ties
    d[2, 12:36:6] = -2
    d[3, 5:35] = (np.arange(30) % 7 - 3).astype(f32)
    d[4, 2:38:2] = 5
    d[4, 3:38:2] = -5                               # alternating: many equal counts
    v = np.ones((H, W), bool)
    v[5] = False
    return d, v


CASES = ["scene0", "scene1", "scene2", "wide", "edges", "one-row box",
         "one-column box", "empty box"]


def _case(label):
    """(disp, valid, source margins, target margins) of a case; the scenes
    are `torch_parity.random_scene`'s, with the JAX package's margins."""
    if label.startswith("scene"):
        import jax.numpy as jnp
        from torch_parity import random_scene

        from reconstruction_tpu.stereo.margins import find_margin
        rng = np.random.default_rng(100 + int(label[-1]))
        _, _, vL, vR, d0 = random_scene(rng)
        return (d0, vL, [int(v) for v in find_margin(jnp.asarray(vL), 2)],
                [int(v) for v in find_margin(jnp.asarray(vR), 2)])
    if label == "wide":
        return _wide(np.random.default_rng(7)) + ([0, 1, 3, 1917], [0, 1, 2, 1915])
    d, v = _edge_rows()
    return (d, v) + {"edges": ([0, 5, 1, 38], [0, 5, 2, 37]),
                     "one-row box": ([2, 2, 4, 35], [2, 2, 0, 39]),
                     "one-column box": ([0, 5, 10, 10], [0, 5, 3, 30]),
                     "empty box": ([3, 2, 37, 2], [3, 2, 37, 2])}[label]


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", CASES)
def test_k6_recurrence_exact(label):
    """K6's row loop equals the plain version and the JAX package at every
    pixel, outside the box too (left untouched)."""
    from reconstruction_tpu.stereo import constraints as jc
    d, _, ms, _ = _case(label)
    mj, mt = _margins(*ms)
    want = K67.ordering_plain(torch.from_numpy(d.copy()), mt).numpy()
    got = k6_model(d, ms)
    ref = np.asarray(jc.ordering_constraint(d, mj, row_chunk=min(32, d.shape[0])))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, want)
    if label == "edges":      # the all-crossing row keeps only its last point
        assert (want[1, 2:38] != NOMATCH).sum() == 1 and want[1, 37] != NOMATCH


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", CASES)
def test_k7_recurrence_exact(label):
    """K7's column and row recurrences equal the plain version and the JAX
    package at every mask-valid source pixel (the contract), and, on these
    inputs, at every other entry too: 0 entries differ outside the mask."""
    from reconstruction_tpu.stereo import constraints as jc
    d, v, ms, mt_ = _case(label)
    mj0, mt0 = _margins(*ms)
    mj1, mt1 = _margins(*mt_)
    BLp, BRp = [a.numpy() for a in K67.propagate_bounds_plain(
        torch.from_numpy(d.copy()), torch.from_numpy(v.copy()), mt0, mt1)]
    BLj, BRj = [np.asarray(a) for a in jc.propagate_bounds(d, v, mj0, mj1)]
    BL, BR, mask = k7_model(d, v, ms, mt_)
    for got, want, ref in ((BL, BLp, BLj), (BR, BRp, BRj)):
        np.testing.assert_array_equal(got[mask], want[mask])
        np.testing.assert_array_equal(ref[mask], want[mask])
        assert int((got != want)[~mask].sum()) == 0


def test_k7_rows_reset_at_mask_gaps():
    """The row pass resets the horizontal chains at a gap in the mask: a
    change left of the gap moves the bounds there and none right of it."""
    d = np.full((3, 12), NOMATCH, f32)
    d[1, 1], d[1, 9] = 2, 7
    v = np.ones((3, 12), bool)
    v[:, 6] = False
    ms = [0, 2, 0, 11]
    out = []
    for d1 in (2, -3):
        d[1, 1] = d1
        BL, BR, _ = k7_model(d, v, ms, ms)
        BLp, BRp = [a.numpy() for a in K67.propagate_bounds_plain(
            torch.from_numpy(d.copy()), torch.from_numpy(v), *[_margins(*ms)[1]] * 2)]
        np.testing.assert_array_equal(BL, BLp)
        np.testing.assert_array_equal(BR, BRp)
        out.append(np.stack([BL[1], BR[1]]))
    assert (out[0][:, 2:6] != out[1][:, 2:6]).any()
    np.testing.assert_array_equal(out[0][:, 7:], out[1][:, 7:])


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """CPU tensors run the plain versions: no launch, no count."""
    from reconstruction_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("a kernel launch for CPU tensors")

    monkeypatch.setattr(_build, "launch", refuse)
    d, v, ms, mt_ = _case("scene0")
    mt0, mt1 = _margins(*ms)[1], _margins(*mt_)[1]
    n6, n7 = K67.ordering.launches, K67.propagate_bounds.launches
    D, V = torch.from_numpy(d), torch.from_numpy(v)
    assert torch.equal(tc.ordering_constraint(D, mt0), K67.ordering_plain(D, mt0))
    for a, b in zip(tc.propagate_bounds(D, V, mt0, mt1),
                    K67.propagate_bounds_plain(D, V, mt0, mt1)):
        assert torch.equal(a, b)
    assert (K67.ordering.launches, K67.propagate_bounds.launches) == (n6, n7)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_scene(dev, H, W, seed):
    """A smooth disparity ramp with noise, holes and an elliptic mask, with
    jumps that cross (the greedy loop has work on most rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(H, device=dev)[:, None].float()
    xx = torch.arange(W, device=dev)[None, :].float()
    valid = (((yy - H / 2) / (0.45 * H)) ** 2 + ((xx - W / 2) / (0.45 * W)) ** 2) < 1
    d = torch.floor(40 + 10 * torch.sin(xx / 97) + 3 * torch.rand((H, W), generator=g,
                                                                 device=dev))
    jump = torch.rand((H, W), generator=g, device=dev) < 0.01
    d = torch.where(jump, d + torch.randint(-30, 31, (H, W), generator=g, device=dev), d)
    hole = torch.rand((H, W), generator=g, device=dev) < 0.2
    d = torch.where(valid & ~hole, d, torch.full_like(d, float(NOMATCH)))
    return d.contiguous(), valid.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(1920, 1280), (1280, 1920), (2160, 3840), (5, 37)])
def test_kernels_equal_plain_on_card(dev, H, W):
    from reconstruction_tpu_torch.stereo.margins import find_margin
    d, valid = _card_scene(dev, H, W, seed=H + W)
    m = find_margin(valid, 2)
    n6, n7 = K67.ordering.launches, K67.propagate_bounds.launches
    ok = K67.ordering(d, m)
    BL, BR = K67.propagate_bounds(ok, valid, m, m)
    assert (K67.ordering.launches - n6, K67.propagate_bounds.launches - n7) == (1, 2)
    assert torch.equal(ok, K67.ordering_plain(d, m))
    BLp, BRp = K67.propagate_bounds_plain(ok, valid, m, m)
    sel = valid & tc.inner_box(m, H, W)
    assert torch.equal(BL[sel], BLp[sel]) and torch.equal(BR[sel], BRp[sel])


@pytest.mark.cuda
def test_kernels_make_no_host_sync(dev):
    from reconstruction_tpu_torch.stereo.margins import find_margin
    d, valid = _card_scene(dev, 256, 384, seed=1)
    m = find_margin(valid, 2)
    K67.ordering(d, m)                       # the build, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ok = K67.ordering(d, m)
        K67.propagate_bounds(ok, valid, m, m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_too_wide_a_row_raises(dev):
    d = torch.zeros((2, K67.MAX_WIDTH + 1), device=dev)
    m = Margins(*[torch.tensor(v, dtype=torch.int32, device=dev) for v in (0, 1, 0, 5)])
    with pytest.raises(ValueError):
        K67.ordering(d, m)
    with pytest.raises(ValueError):
        K67.propagate_bounds(d, d > 0, m, m)
