"""K1's exactness argument against the reference, on the CPU.

The card's K1 sums each window in int32 (dp4a on int8 words): in sweep
mode as separable column and row sums, in candidate mode as the direct
(2r+1)^2 window sum of each (pixel, target) pair.  Centered uint8 products
and their sums are integers below 2^24, so any order gives the same float.
Here the candidate mode's arithmetic is written out in numpy int64, passed
through the port's score epilogue (`utils.fp.fma32`, as the kernel's
`rtt_ncc_score`) with the first maximum in ascending target kept, and
held bit for bit against `reconstruction_tpu.stereo.matching.ncc_sweep_match`.
"""

import numpy as np
import pytest
import torch

from torch_parity import J, T, assert_equal, u8_image

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.stereo import matching as jm
from reconstruction_tpu_torch.stereo.matching import _centered, sweep_moments
from reconstruction_tpu_torch.utils.fp import fma32


def _guided_bounds(rng, H, W):
    """Guided-style bounds: +-2 around a disparity in [-6, 6] that varies
    along the row (negative shifts included), 10% hole pixels with ranges
    up to 31 wide, some running past the image's edges."""
    x = np.arange(W)[None, :]
    d = np.cumsum(rng.integers(-1, 2, (H, W)), axis=1).clip(-6, 6)
    lo, hi = x + d - 2, x + d + 2
    hole = rng.uniform(size=(H, W)) < 0.1
    lo = np.where(hole, x - rng.integers(0, 16, (H, W)), lo)
    hi = np.where(hole, x + rng.integers(0, 16, (H, W)), hi)
    active = rng.uniform(size=(H, W)) < 0.85
    validR = rng.uniform(size=(H, W)) < 0.9
    return validR, active, lo.astype(np.int32), hi.astype(np.int32)


def _candidate_sweep(imgL, imgR, validR, active, lo, hi, radius):
    """The candidate mode's arithmetic: per active pixel and target t in
    its clipped bounds, ascending, the int64 window sum of the channel
    products (zero padding), the float32 score, strict '>' from -1."""
    L = np.asarray(imgL, np.int64).reshape(imgL.shape[0], imgL.shape[1], -1) - 128
    R = np.asarray(imgR, np.int64).reshape(L.shape) - 128
    H, W, _ = L.shape
    r = radius
    Lp = np.pad(L, ((r, r), (r, r), (0, 0)))
    Rp = np.pad(R, ((r, r), (r, r), (0, 0)))
    ys, xs, ts = [], [], []
    for y, x in zip(*np.nonzero(active)):
        for t in range(max(lo[y, x], 0), min(hi[y, x], W - 1) + 1):
            if validR[y, t]:
                ys.append(y)
                xs.append(x)
                ts.append(t)
    ys, xs, ts = (np.asarray(v, np.int64) for v in (ys, xs, ts))
    cross = np.zeros(len(ys), np.int64)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            cross += (Lp[ys + dy, xs + dx] * Rp[ys + dy, ts + dx]).sum(-1)
    assert np.abs(cross).max() < 2 ** 24   # exact in float32, in any order
    Lc = _centered(T(np.asarray(imgL, np.float32)))
    Rc = _centered(T(np.asarray(imgR, np.float32)))
    nmuL, invL, muR, invR = sweep_moments(Lc, Rc, radius)
    yi, xi, ti = (torch.from_numpy(v) for v in (ys, xs, ts))
    sc = (fma32(-nmuL[yi, xi], muR[yi, ti], torch.from_numpy(cross).float())
          * invL[yi, xi] * invR[yi, ti]).numpy()
    best = np.full((H, W), -1.0, np.float32)
    bt = np.full((H, W), -1, np.int64)
    for k in range(len(ys)):   # pairs come per pixel in ascending t
        y, x = ys[k], xs[k]
        if sc[k] > best[y, x]:
            best[y, x], bt[y, x] = sc[k], ts[k]
    x = np.arange(W)[None, :]
    disp = np.where(bt >= 0, (bt - x).astype(np.float32), np.float32(NOMATCH))
    return disp, best


@pytest.mark.parametrize("radius,channels", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_candidate_window_sums_equal_reference(radius, channels):
    rng = np.random.default_rng(100 * radius + channels)
    H, W = 20, 40
    shape = (H, W, channels) if channels > 1 else (H, W)
    imgL, imgR = u8_image(rng, shape), u8_image(rng, shape)
    # Rows repeating every 7 columns: targets 7 apart tie exactly, and the
    # first of them must win.
    reps = (1, W // 7 + 1) + (1,) * (imgR.ndim - 2)
    imgR[: H // 2] = np.tile(imgR[: H // 2, :7], reps)[:, :W]
    validR, active, lo, hi = _guided_bounds(rng, H, W)
    ref = jm.ncc_sweep_match(J(imgL), J(imgR), J(validR), J(active), J(lo),
                             J(hi), radius)
    disp, score = _candidate_sweep(imgL, imgR, validR, active, lo, hi, radius)
    assert_equal(ref.disparity, disp, "disparity")
    assert_equal(ref.score, score, "score")
    assert (disp != NOMATCH).sum() > 0.5 * active.sum()
    assert (disp < 0).any() and (disp > 0).any()
    # Ties: pixels of the periodic rows whose own range holds a target 7
    # past their match.
    x = np.arange(W)[None, :]
    t = np.where(disp != NOMATCH, x + disp, -1).astype(np.int64)
    tie = (t >= 0) & (t + 7 <= np.minimum(hi, W - 1)) & np.roll(validR, -7, 1)
    assert tie[: H // 2].sum() > 5
