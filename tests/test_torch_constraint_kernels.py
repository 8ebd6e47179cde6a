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

The kernels' own bracketing, step by step in the order their threads run
it, is modelled beside those recurrences and held to the same references:

  * K6 (`k6_merge_model`): crossing counts by merge sort, first within
    chunks of 32 points (a warp, by shuffles), then bottom-up merges
    whose binary searches give each point its crossings in the other run;
    then the greedy loop over the points that cross anything (count > 0).
  * K7 (`k7_segment_model`): each column cut into `segments` row segments,
    each segment's down and up step functions folded, the segments'
    functions scanned by `lanes` lanes in Kogge-Stone order (the warp's
    shuffles), then replayed from their carries; each row cut into `lanes`
    runs, folded, scanned and replayed forward, the backward functions
    folded during the forward replay and replayed after their scan.  At
    the kernels' geometry (128 segments, 32 lanes) and at small ones,
    which put segment boundaries inside the small cases.

The `cuda` cases hold the kernels against their plain versions on the
card at the `myself` preset's finest level (H x W = 1920x1280, its
`finest_size` (1280, 1920) being width by height), at its transpose
(1280x1920, rows of 1920 columns), at the dome's (2160x3840), at 5x37 and
at 1917x1283 (neither a multiple of the segments).  On the card (whose
machine has no jax for tests/conftest.py): python -m pytest --noconftest
tests/test_torch_constraint_kernels.py -q -m cuda
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


def k6_merge_counts(t: np.ndarray, chunk: int = 32) -> np.ndarray:
    """Each point's crossings, #{j < i: t_j > t_i} + #{j > i: t_j < t_i},
    by K6's merge sort of (t, index) over a row's V compacted points."""
    V = len(t)
    cnt = np.zeros(V, np.int64)
    perm = np.empty(V, np.int64)
    # A warp a chunk: each lane counts the crossings inside its chunk and
    # ranks its t there (ties by index), by shuffles of the chunk's t.
    for c0 in range(0, V, chunk):
        i = np.arange(c0, min(c0 + chunk, V))
        ti, tj = t[i][:, None], t[i][None, :]
        before = i[None, :] < i[:, None]                 # [i, j]: j before i
        cnt[i] = ((before & (tj > ti)) | (~before & (tj < ti))).sum(1)
        rank = ((tj < ti) | ((tj == ti) & before)).sum(1)
        perm[c0 + rank] = i
    # Bottom-up merges: a point of the left run gains the right run's
    # points with t below its own (lower bound), one of the right run the
    # left run's points with t above its own (upper bound); the same
    # searches place each point in the merged run.
    w = chunk
    while w < V:
        new = perm.copy()
        for base in range(0, V, 2 * w):
            mid, end = base + w, min(base + 2 * w, V)
            if mid >= V:
                continue
            left, right = perm[base:mid], perm[mid:end]
            r = np.searchsorted(t[right], t[left], side="left")
            new[base + np.arange(w) + r] = left
            cnt[left] += r
            r = np.searchsorted(t[left], t[right], side="right")
            new[base + np.arange(end - mid) + r] = right
            cnt[right] += w - r
        perm = new
        w *= 2
    assert (np.diff(t[perm]) >= 0).all() and sorted(perm) == list(range(V))
    return cnt


def k6_merge_model(disp: np.ndarray, m, chunk: int = 32) -> np.ndarray:
    """K6 as the redesigned kernel runs a row: the valid points compacted
    in column order, their crossing counts by merge sort of (t, index),
    then the greedy loop over the points whose count is above 0."""
    H, W = disp.shape
    YL, YR, XL, XR = [int(v) for v in m]
    out = disp.copy()
    for y in range(max(YL, 0), min(YR, H - 1) + 1):
        xs = np.array([x for x in range(max(XL, 0), min(XR, W - 1) + 1)
                       if disp[y, x] != NOMATCH], dtype=np.int64)
        V = len(xs)
        if V == 0:
            continue
        t = (disp[y, xs] + xs.astype(f32)).astype(f32)
        cnt = k6_merge_counts(t, chunk)
        # The greedy loop over the points that cross any (count 0 stays 0).
        act = np.flatnonzero(cnt > 0)
        ta, ca, xa = t[act], cnt[act], xs[act]
        j = np.arange(len(act))
        while len(ca) and ca.max() > 0:
            k = int(np.argmax(ca))                 # the first maximum
            cross = ((j < k) & (ta > ta[k])) | ((j > k) & (ta < ta[k]))
            ca = np.where((ca >= 0) & cross, ca - 1, ca)
            ca[k] = -1
            out[y, xa[k]] = NOMATCH
    return out


# The kernels' geometry (csrc/constraints.cu: K7C_SEGS, the lanes of a
# warp, K7C_BATCH).
K7_SEGMENTS, K7_LANES, K7_BATCH = 128, 32, 4


def _compose(a, b, op):
    """The step function a, then b: c -> op(c + s, m) twice, in closed form
    (s1 + s2, op(m1 + s2, m2))."""
    return a[0] + b[0], op(a[1] + b[0], b[1])


def _lane_carries(S, M, op, ident, reverse: bool):
    """The carry into each lane (axis 0) of a warp's Kogge-Stone scan of
    the lanes' functions, as shuffles run it: in lane order, or from the
    last lane down with ``reverse``."""
    S, M = S.copy(), M.copy()
    n, off = S.shape[0], 1
    while off < n:
        S0, M0 = S.copy(), M.copy()
        if reverse:
            S[:-off], M[:-off] = _compose((S0[off:], M0[off:]), (S0[:-off], M0[:-off]), op)
        else:
            S[off:], M[off:] = _compose((S0[:-off], M0[:-off]), (S0[off:], M0[off:]), op)
        off *= 2
    cin = np.full_like(M, ident)
    if reverse:
        cin[:-1] = M[1:]
    else:
        cin[1:] = M[:-1]
    return cin


def _segment_carries(S, M, op, ident, lanes: int, reverse: bool):
    """Carries into the segments (axis 0) of a column: each lane folds its
    run of segments, the lanes scan, then each lane applies its segments'
    functions to its carry in turn (from the last segment up with
    ``reverse``)."""
    n = S.shape[0]
    per = n // lanes
    S3, M3 = S.reshape(lanes, per, *S.shape[1:]), M.reshape(lanes, per, *M.shape[1:])
    order = range(per - 1, -1, -1) if reverse else range(per)
    fs = (np.zeros_like(S3[:, 0]), np.full_like(M3[:, 0], ident))
    for j in order:
        fs = _compose(fs, (S3[:, j], M3[:, j]), op)
    c = _lane_carries(fs[0].copy(), fs[1].copy(), op, ident, reverse)
    cin = np.empty_like(M3)
    for j in order:
        cin[:, j] = c
        c = op(c + S3[:, j], M3[:, j])
    return cin.reshape(M.shape)


def k7_segment_model(disp, valid, m_src, m_tgt, max_step=2, segments=K7_SEGMENTS,
                     lanes=K7_LANES, batch=K7_BATCH):
    """K7 as the redesigned kernels run it, in their bracketing."""
    H, W = disp.shape
    YL, YR, XL, XR = [int(v) for v in m_src]
    tXL, tXR = f32(int(m_tgt[2])), f32(int(m_tgt[3]))
    yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
    mask = valid & (yy >= YL) & (yy <= YR) & (xx >= XL) & (xx <= XR)
    has_d = mask & (disp != NOMATCH)
    ref = np.where(has_d, disp, f32(0))
    MD, LO, HI, BIG, INF = f32(max_step), f32(-10000), f32(10000), f32(1e9), f32(np.inf)
    hole = mask & ~has_d
    chains = [(np.where(hole, -MD, -BIG), np.maximum(np.where(mask, np.where(
                  has_d, ref - MD, LO), LO), LO), np.maximum, -INF),
              (np.where(hole, MD, BIG), np.minimum(np.where(mask, np.where(
                  has_d, ref + MD, HI), HI), HI), np.minimum, INF)]

    # Column pass: a column in `segments` segments of L rows (rows past H
    # are skipped, which is the identity function).  Each thread folds its
    # segment's down function (appending rows) and up function (prepending
    # them) in one walk down, keeping the down fold at each batch's start;
    # the segments' carries come from the scans; the replay takes each
    # batch's down carry from its kept fold, then walks the batch down and
    # up.
    L = -(-H // segments)
    pad = segments * L - H
    vert = {}
    for s, mv, op, ident in chains:
        sp = np.concatenate([s, np.zeros((pad, W), f32)]).reshape(segments, L, W)
        mp = np.concatenate([mv, np.full((pad, W), ident, f32)]).reshape(segments, L, W)
        dn = (np.zeros((segments, W), f32), np.full((segments, W), ident, f32))
        up = (np.zeros((segments, W), f32), np.full((segments, W), ident, f32))
        kept = {}
        for r in range(L):
            if r % batch == 0:
                kept[r] = dn                     # the rows above the batch
            dn = _compose(dn, (sp[:, r], mp[:, r]), op)
            up = _compose((sp[:, r], mp[:, r]), up, op)
        cdn = _segment_carries(*dn, op, ident, lanes, reverse=False)
        cup = _segment_carries(*up, op, ident, lanes, reverse=True)
        dn_v, up_v = np.empty((segments, L, W), f32), np.empty((segments, L, W), f32)
        for r in range(L):
            if r % batch == 0:                   # the kept fold applied to the carry
                c = cdn if r == 0 else op(cdn + kept[r][0], kept[r][1])
            dn_v[:, r] = c
            c = op(c + sp[:, r], mp[:, r])
        c = cup
        for r in reversed(range(L)):
            up_v[:, r] = c
            c = op(c + sp[:, r], mp[:, r])
        dn_v, up_v = dn_v.reshape(-1, W)[:H], up_v.reshape(-1, W)[:H]
        init = LO if op is np.maximum else HI                # the initial bounds
        dn_v[0], up_v[H - 1] = init, init
        vert[op] = (dn_v, up_v)
    (dn_lo, up_lo), (dn_hi, up_hi) = vert[np.maximum], vert[np.minimum]
    at_yl = has_d & (yy == YL)
    BL = np.where(at_yl, np.maximum(ref, up_lo), np.where(has_d, ref, np.maximum(dn_lo, up_lo)))
    BR = np.where(at_yl, np.minimum(ref, up_hi), np.where(has_d, ref, np.minimum(dn_hi, up_hi)))

    # Row pass: a row in `lanes` runs of R columns, R odd (columns past W
    # are skipped).  Forward: fold, scan, replay; the replay also folds the
    # backward functions (prepending columns), whose m needs the forward
    # output; then their scan from the last lane, and the backward replay.
    R = -(-W // lanes)
    R += 1 - R % 2
    xs = np.arange(lanes * R).reshape(lanes, R)
    left = np.concatenate([np.zeros((H, 1), bool), mask[:, :-1]], 1)
    out = []
    for b, fstep, bstep, T, op, ident in ((BL, f32(-1), -MD, tXL, np.maximum, -INF),
                                          (BR, MD, f32(1), tXR, np.minimum, INF)):
        sent = -BIG if op is np.maximum else BIG
        fwd = b.copy()
        fS, fM = np.zeros((lanes, H), f32), np.full((lanes, H), ident, f32)
        for r in range(R):
            x = xs[:, r]
            ins = x < W
            xc = np.minimum(x, W - 1)
            s = np.where(left[:, xc].T, fstep, sent)
            nS, nM = _compose((fS, fM), (s, b[:, xc].T), op)
            fS, fM = np.where(ins[:, None], nS, fS), np.where(ins[:, None], nM, fM)
        c = _lane_carries(fS, fM, op, ident, reverse=False)
        bS, bM = np.zeros((lanes, H), f32), np.full((lanes, H), ident, f32)
        for r in range(R):
            x = xs[:, r]
            ins = x < W
            xc = np.minimum(x, W - 1)
            mk = mask[:, xc].T
            c = np.where(ins[:, None], op(c + np.where(left[:, xc].T, fstep, sent),
                                          b[:, xc].T), c)
            fwd[:, xc[ins]] = c[ins].T
            bs = np.where(mk, bstep, sent)
            bm = np.where(mk, op(c, T - x.astype(f32)[:, None]) + bstep, sent)
            nS, nM = _compose((bs, bm), (bS, bM), op)
            bS, bM = np.where(ins[:, None], nS, bS), np.where(ins[:, None], nM, bM)
        c = _lane_carries(bS, bM, op, ident, reverse=True)
        res = fwd.copy()
        for r in reversed(range(R)):
            x = xs[:, r]
            ins = x < W
            xc = np.minimum(x, W - 1)
            bx, mk = fwd[:, xc].T, mask[:, xc].T
            inc = np.where((x < W - 1)[:, None], c, sent)
            o = op(op(bx, inc) + x.astype(f32)[:, None], T)
            res[:, xc[ins]] = o[ins].T
            bm = np.where(mk, op(bx, T - x.astype(f32)[:, None]) + bstep, sent)
            c = np.where(ins[:, None], op(c + np.where(mk, bstep, sent), bm), c)
        out.append(res)
    return out[0], out[1], mask


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


def _odd(rng, H=301, W=101):
    """A scene whose H and W are multiples of neither the kernels' segment
    length (3 rows) nor their lane run (5 columns), nor the small
    geometries'."""
    x = np.arange(W)[None, :]
    d = np.floor(6 * np.sin(x / 13.0) + rng.integers(-2, 3, (H, W))).astype(f32)
    jump = rng.uniform(size=(H, W)) < 0.05
    d[jump] += rng.integers(-20, 21, jump.sum()).astype(f32)
    d[rng.uniform(size=(H, W)) < 0.25] = NOMATCH
    v = np.ones((H, W), bool)
    v[:, 47] = False
    v[150:153] = False
    return d, v


def _boundaries(H=301, W=101):
    """Disparities and row YL on segment boundaries (rows 102 and 105 for
    the kernels' 3-row segments, 114 and 152 for 38-row ones) and on lane
    boundaries (columns 5 and 10 for 5-column runs, 27 and 54 for 27-column
    ones), with few disparities elsewhere, so carries run far."""
    d = np.full((H, W), NOMATCH, f32)
    rng = np.random.default_rng(11)
    for y in (101, 102, 104, 105, 113, 114, 151, 152):
        for x in (4, 5, 9, 10, 26, 27, 53, 54, 60):
            d[y, x] = f32(rng.integers(-6, 7))
    d[200:203, 30:33] = 3
    v = np.ones((H, W), bool)
    v[:, 80] = False
    return d, v


def _gapless(H=301, W=101):
    """A column and a row with no mask gap: the down carry of column 50
    and the up carry of column 20 cross every segment, the forward carry
    of row 150 and the backward carry of row 200 every lane."""
    d = np.full((H, W), NOMATCH, f32)
    d[0, 50], d[H - 1, 20], d[150, 0], d[200, W - 1] = 5, 7, 3, -4
    return d, np.ones((H, W), bool)


def _ties(rng, H=40, W=300):
    """Rows whose t = d + x takes three values (many equal t, many
    crossings among them), a row of one t, and a row alternating two."""
    x = np.arange(W)[None, :]
    t = rng.choice([100.0, 150.0, 200.0], (H, W))
    t[5] = 120.0
    t[6] = np.where(np.arange(W) % 2 == 0, 130.0, 170.0)
    d = (t - x).astype(f32)
    d[rng.uniform(size=(H, W)) < 0.3] = NOMATCH
    return d, np.ones((H, W), bool)


CASES = ["scene0", "scene1", "scene2", "wide", "edges", "one-row box",
         "one-column box", "empty box", "odd", "boundaries", "gapless", "ties"]


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
    if label == "odd":
        return _odd(np.random.default_rng(5)) + ([2, 298, 1, 99], [0, 300, 3, 97])
    if label == "boundaries":
        return _boundaries() + ([102, 290, 0, 100], [0, 300, 2, 98])
    if label == "gapless":
        return _gapless() + ([0, 300, 0, 100], [0, 300, 0, 100])
    if label == "ties":
        return _ties(np.random.default_rng(3)) + ([0, 39, 0, 299], [0, 39, 0, 299])
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


@pytest.mark.parametrize("label", CASES)
def test_k6_merge_model_exact(label):
    """The redesigned K6 (merge counts, greedy loop over the crossing
    points) equals the plain version and the JAX package at every pixel,
    with the kernel's chunks of 32 and with chunks of 4 (more merges)."""
    from reconstruction_tpu.stereo import constraints as jc
    d, _, ms, _ = _case(label)
    mj, mt = _margins(*ms)
    want = K67.ordering_plain(torch.from_numpy(d.copy()), mt).numpy()
    ref = np.asarray(jc.ordering_constraint(d, mj, row_chunk=min(32, d.shape[0])))
    np.testing.assert_array_equal(ref, want)
    for chunk in (32, 4):
        np.testing.assert_array_equal(k6_merge_model(d, ms, chunk), want)


@pytest.mark.parametrize("chunk", [32, 4, 1])
def test_k6_merge_counts_equal_pairwise(chunk):
    """Crossing counts by merge sort equal the pairwise O(V^2) counts on
    rows with many equal t (ties cross nothing), V above and below a chunk
    and not a power of two."""
    d, _ = _ties(np.random.default_rng(9))
    for y, V in ((0, 211), (5, 150), (6, 97), (7, 31), (8, 33), (9, 1)):
        xs = np.flatnonzero(d[y] != NOMATCH)[:V]
        t = (d[y, xs] + xs.astype(f32)).astype(f32)
        j = np.arange(len(t))
        before = j[None, :] < j[:, None]
        want = ((before & (t[None, :] > t[:, None]))
                | (~before & (t[None, :] < t[:, None]))).sum(1)
        np.testing.assert_array_equal(k6_merge_counts(t, chunk), want)
    assert (k6_merge_counts(np.full(50, f32(3)), chunk) == 0).all()


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


@pytest.mark.parametrize("geometry", [(K7_SEGMENTS, K7_LANES, K7_BATCH), (8, 4, 4),
                                      (6, 2, 3)], ids=["kernel", "8x4", "6x2"])
@pytest.mark.parametrize("label", CASES)
def test_k7_segment_model_exact(label, geometry):
    """The redesigned K7 (segment functions folded, scanned and replayed)
    equals the plain version and the JAX package at every mask-valid source
    pixel, and 0 entries differ elsewhere, at the kernels' geometry and at
    small ones that put segment and lane boundaries inside every case."""
    from reconstruction_tpu.stereo import constraints as jc
    d, v, ms, mt_ = _case(label)
    mj0, mt0 = _margins(*ms)
    mj1, mt1 = _margins(*mt_)
    BLp, BRp = [a.numpy() for a in K67.propagate_bounds_plain(
        torch.from_numpy(d.copy()), torch.from_numpy(v.copy()), mt0, mt1)]
    BLj, BRj = [np.asarray(a) for a in jc.propagate_bounds(d, v, mj0, mj1)]
    BL, BR, mask = k7_segment_model(d, v, ms, mt_, **dict(zip(("segments", "lanes", "batch"),
                                                                geometry)))
    for got, want, ref in ((BL, BLp, BLj), (BR, BRp, BRj)):
        np.testing.assert_array_equal(got[mask], want[mask])
        np.testing.assert_array_equal(ref[mask], want[mask])
        assert int((got != want)[~mask].sum()) == 0


def test_k7_carries_cross_every_segment():
    """With no mask gap, a seed's carry crosses every segment of its
    column and every lane of its row: moving a seed at one end moves the
    bounds at the other end (down and forward, then up and backward), in
    the kernels' bracketing and in the plain version alike."""
    v = np.ones((301, 101), bool)
    box, wide = [0, 300, 0, 100], [0, 300, -5000, 5000]   # no clamp to the target
    for seeds, far in ((((0, 50), (150, 0)), ((300, 50), (150, 100))),
                       (((300, 50), (150, 100)), ((0, 50), (150, 0)))):
        outs = []
        for val in (3, 9):
            d = np.full((301, 101), NOMATCH, f32)
            for y, x in seeds:
                d[y, x] = val
            BL, BR, _ = k7_segment_model(d, v, box, wide)
            BLp, BRp = [a.numpy() for a in K67.propagate_bounds_plain(
                torch.from_numpy(d), torch.from_numpy(v), _margins(*box)[1],
                _margins(*wide)[1])]
            np.testing.assert_array_equal(BL, BLp)
            np.testing.assert_array_equal(BR, BRp)
            outs.append((BL, BR))
        for y, x in far:
            assert outs[0][0][y, x] != outs[1][0][y, x] or outs[0][1][y, x] != outs[1][1][y, x]


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


def test_phase_clock_marks_fit_the_kernels():
    """`tools/k67_phase_clocks.py` finds each of its anchors once in this
    tree's kernels, and its marks record every phase it reports."""
    from pathlib import Path

    from reconstruction_tpu_torch.tools import k67_phase_clocks as clocks
    src = (Path(K67.__file__).parent.parent / "csrc" / "constraints.cu").read_text()
    out, design = clocks.instrument(src)
    assert design == "segments"
    for kernel, names in clocks.PHASES[design].items():
        body = out[out.index(f"{kernel}_dbg + (size_t)blockIdx.x"):]
        assert all(f"mark({k});" in out for k in range(len(names))), kernel
        assert "flush(" in body
    assert out.count("rtt_k67_clocks") == 1 and out.count("rtt_k67_alone") == 1


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
@pytest.mark.parametrize("H,W", [(1920, 1280), (1280, 1920), (2160, 3840), (5, 37),
                                 (1917, 1283)])
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
def test_k7_layout_is_the_models(dev):
    """The kernels' geometry is the one `k7_segment_model` is held to."""
    for H, W in ((1920, 1280), (2160, 3840), (1917, 1283), (5, 37)):
        g = K67.k7_layout(H, W)
        run = -(-W // K7_LANES)
        assert g["segments"] == K7_SEGMENTS and g["segment_rows"] == -(-H // K7_SEGMENTS)
        assert g["run"] == run + 1 - run % 2


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
