"""K6 (ordering), K7 (bound propagation), K10 (smoothness), K11 (the
uniqueness call) and K12 (the masked median): the kernels' recurrences
written out in numpy, one step at a time in the order the kernels run
them, against the port's plain versions (`ops/constraints.py`) and, for
K6 and K7, the JAX package on the same seeded inputs.

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
  * K10 (`k10_model`): each pixel's 8 neighbours read with the box test
    of their own coordinates, links and violations counted, the kill rule.
  * K11 (`k11_model`): each pass's flags g and b by column, packed into
    words (a warp's ballot), each word's last b and last ~g, folded by
    each thread over its run of words, scanned over the threads (a warp
    scan, then the warps' totals), replayed into each word's carries, and
    each column finished inside its word; at the kernel's geometry and at
    small ones, on rows whose runs of g cross many words and threads.
  * K12 (`k12_model`): the window's six values in stacking order, NOMATCH
    as 1e9, the 12-comparator network on (value, window index), the
    middle ranks; the network alone is held to `torch.sort` and its
    gathers at every count of valid values, ties of +0.0 and -0.0 among
    them.

The `cuda` cases hold the kernels against their plain versions on the
card at the `myself` preset's finest level (H x W = 1920x1280, its
`finest_size` (1280, 1920) being width by height), at its transpose
(1280x1920, rows of 1920 columns), at the dome's (2160x3840), at 5x37 and
at 1917x1283 (neither a multiple of the segments); K10-K12 against their
plain versions on the CPU at every level shape of both rigs, at 5x37 and
on a row of MAX_WIDTH columns.  On the card (whose machine has no jax for
tests/conftest.py): python -m pytest --noconftest
tests/test_torch_constraint_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import constraints as K67
from reconstruction_tpu_torch.stereo import constraints as tc
from reconstruction_tpu_torch.stereo.margins import Margins, inner_box

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


def _box(m, H, W):
    YL, YR, XL, XR = [int(v) for v in m]
    yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
    return (yy >= YL) & (yy <= YR) & (xx >= XL) & (xx <= XR)


def k10_model(disp: np.ndarray, m) -> np.ndarray:
    """K10, a thread a pixel: each neighbour inside the image, inside the
    box at its own coordinates and not NOMATCH is a link; a link with
    |d - d_q| > 1 a violation."""
    H, W = disp.shape
    box = _box(m, H, W)
    yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
    links = np.zeros((H, W), np.int64)
    viol = np.zeros((H, W), np.int64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ny, nx = yy + dy, xx + dx
            inside = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
            nyc, nxc = np.clip(ny, 0, H - 1), np.clip(nx, 0, W - 1)
            nb = disp[nyc, nxc]
            ok = inside & box[nyc, nxc] & (nb != NOMATCH)
            links += ok
            viol += ok & (np.abs(disp - nb) > f32(1))
    kill = box & ((links == 0) | (2 * viol > links))
    return np.where(kill, f32(NOMATCH), disp)


# K11's geometry (csrc/constraints.cu: a ballot's word, a warp, K11_THREADS).
K11_WORD, K11_WARP, K11_THREADS = 32, 32, 256


def k11_threads(W: int, warp: int = K11_WARP, most: int = K11_THREADS) -> int:
    """K11's threads a block: W rounded up to a warp, at most ``most``."""
    return min(most, -(-W // warp) * warp)


def k11_flags(p: np.ndarray, q: np.ndarray, ms, mt):
    """K11's per-column flags of one pass: g (valid, no hit, east check)
    and b (g and the west check), from the source row p and target row q."""
    H, W = p.shape
    tXL, tXR = int(mt[2]), int(mt[3])
    valid = (p != NOMATCH) & _box(ms, H, W)
    x = np.arange(W)[None, :]
    bL = np.maximum(np.trunc(p + f32(0.5)).astype(np.int64) + x - 1, tXL)
    bR = np.minimum(bL + 2, tXR)
    rows = np.arange(H)[:, None]
    hit = np.zeros((H, W), bool)
    for k in range(3):
        v = q[rows, np.clip(bL + k, 0, W - 1)]
        if k == 1:
            q_mid = v
        hit |= (bL + k <= bR) & valid & (np.abs(v + p) < f32(2))
    pe = np.concatenate([p[:, 1:], np.zeros((H, 1), f32)], 1)
    pw = np.concatenate([np.zeros((H, 1), f32), p[:, :-1]], 1)
    g = valid & ~hit & (np.abs(q_mid + pe) >= f32(2))
    return g, g & (np.abs(q_mid + pw) >= f32(2))


def _warp_exclusive_max(t: np.ndarray, warp: int) -> np.ndarray:
    """Exclusive running max over axis 1 (the block's threads, -1 before
    the first): Kogge-Stone within each warp, as the shuffles run it, then
    the earlier warps' totals."""
    H, n = t.shape
    t = t.reshape(H, n // warp, warp).copy()
    off = 1
    while off < warp:
        t[:, :, off:] = np.maximum(t[:, :, off:], t[:, :, :-off])
        off *= 2
    tot = t[:, :, -1]
    before = np.concatenate([np.full((H, 1), -1), np.maximum.accumulate(tot, 1)[:, :-1]], 1)
    e = np.concatenate([np.full((H, n // warp, 1), -1), t[:, :, :-1]], 2)
    return np.maximum(e, before[:, :, None]).reshape(H, n)


def k11_kill(g: np.ndarray, b: np.ndarray, word: int, warp: int, threads: int) -> np.ndarray:
    """K11's kill cascade in its bracketing: the flags in words, each
    word's last b and last ~g, each thread's run of words folded, scanned
    over the threads, replayed into the words' carries, then each column's
    last b and last ~g inside its word, or the word's carry."""
    H, W = g.shape
    NW = -(-W // word)
    pad = np.zeros((H, NW * word - W), bool)
    G = np.concatenate([g, pad], 1).reshape(H, NW, word)
    B = np.concatenate([b, pad], 1).reshape(H, NW, word)
    cols = np.arange(NW * word).reshape(NW, word)
    per = -(-NW // threads)
    carries = []
    for bits in (B, ~G):
        last = np.where(bits, cols, -1).max(-1)                    # (H, NW)
        runs = np.concatenate([last, np.full((H, threads * per - NW), -1)], 1)
        runs = runs.reshape(H, threads, per)
        c = _warp_exclusive_max(runs.max(-1), warp)
        cw = np.empty_like(runs)
        for j in range(per):
            cw[:, :, j] = c
            c = np.maximum(c, runs[:, :, j])
        carries.append(cw.reshape(H, -1)[:, :NW])
    upto = np.arange(word)[None, :] <= np.arange(word)[:, None]    # [l, j]: j <= l
    last_b, last_break = [
        np.where(inword >= 0, inword, carry[:, :, None]) for inword, carry in (
            (np.where(bits[:, :, None, :] & upto, cols[None, :, None, :], -1).max(-1), carry)
            for bits, carry in ((B, carries[0]), (~G, carries[1])))]
    return (G & (last_b > last_break)).reshape(H, -1)[:, :W]


def k11_model(d0, d1, m0, m1, word=K11_WORD, warp=K11_WARP, threads=None):
    """K11: the three passes (forward, reverse on the updated forward map,
    forward again), each its flags, then its kill cascade."""
    threads = threads or k11_threads(d0.shape[1], warp)
    d0, d1 = d0.copy(), d1.copy()
    for p, q, ms, mt in ((d0, d1, m0, m1), (d1, d0, m1, m0), (d0, d1, m0, m1)):
        g, b = k11_flags(p, q, ms, mt)
        p[k11_kill(g, b, word, warp, threads)] = NOMATCH
    return d0, d1


# K12's sorting network (csrc/constraints.cu: median_kernel).
K12_NETWORK = ((0, 5), (1, 3), (2, 4), (1, 2), (3, 4), (0, 3), (2, 5), (0, 1), (2, 3),
               (4, 5), (1, 2), (3, 4))


def k12_sort(v: np.ndarray, idx: np.ndarray):
    """The network on (value, window index) along axis 0: NaN after every
    number, ties in window order."""
    v, idx = v.copy(), idx.copy()
    for a, b in K12_NETWORK:
        lt = (v[b] < v[a]) | (~np.isnan(v[b]) & np.isnan(v[a]))
        gt = (v[a] < v[b]) | (~np.isnan(v[a]) & np.isnan(v[b]))
        swap = lt | (~gt & (idx[b] < idx[a]))
        v[a], v[b] = np.where(swap, v[b], v[a]), np.where(swap, v[a], v[b])
        idx[a], idx[b] = np.where(swap, idx[b], idx[a]), np.where(swap, idx[a], idx[b])
    return v, idx


def k12_pick(v: np.ndarray, ok: np.ndarray):
    """(count, value at rank lo, value at rank hi) of windows (6, ...)."""
    k = ok.sum(0)
    key = np.where(ok, v, f32(1e9)).astype(f32)
    s, _ = k12_sort(key, np.broadcast_to(np.arange(6).reshape((6,) + (1,) * (v.ndim - 1)),
                                         v.shape))
    lo, hi = np.maximum((k - 1) >> 1, 0), np.minimum(k >> 1, 5)
    return k, np.take_along_axis(s, lo[None], 0)[0], np.take_along_axis(s, hi[None], 0)[0]


def k12_model(disp: np.ndarray, valid: np.ndarray, m, iterations: int = 1) -> np.ndarray:
    """K12, a thread a pixel an iteration: the window (0.0 outside the
    image), the network, the truncated mean, the fill and kill rules."""
    H, W = disp.shape
    compute = valid & _box(m, H, W)
    nm = f32(NOMATCH)
    d = disp
    for _ in range(iterations):
        pad = np.pad(d, 1)                                         # 0.0 outside
        v = np.stack([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                      for dx in (-1, 0) for dy in (-1, 0, 1)])
        k, v_lo, v_hi = k12_pick(v, v != NOMATCH)
        med = np.trunc((v_lo + v_hi) / f32(2)).astype(f32)
        out = np.where(d != NOMATCH, np.where(k <= 2, nm, med), np.where(k >= 4, med, nm))
        d = np.where(compute, out, nm).astype(f32)
    return d


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
# K10-K12
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    """The float32 bits (so that -0.0 and 0.0 differ)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=f32).view(np.uint32)


def _tm(m) -> Margins:
    return Margins(*[torch.tensor(int(v), dtype=torch.int32) for v in m])


def _signed_zeros(d: np.ndarray, seed: int) -> np.ndarray:
    """``d`` with about half its zeros made -0.0."""
    rng = np.random.default_rng(seed)
    d = d.copy()
    d[(d == 0) & (rng.uniform(size=d.shape) < 0.5)] = f32(-0.0)
    return d


@pytest.mark.parametrize("label", CASES)
def test_k10_model_exact(label):
    """K10's per-pixel rule (each neighbour boxed at its own coordinates)
    equals the plain smoothness pass bit for bit."""
    d, _, ms, _ = _case(label)
    d = _signed_zeros(d, 1)
    want = K67.smoothness_plain(torch.from_numpy(d.copy()), _tm(ms))
    np.testing.assert_array_equal(_bits(k10_model(d, ms)), _bits(want))


def _run_end(W: int) -> int:
    """The end of `_long_runs`' runs: p = 2x stays below 8,000, so that no
    NOMATCH of q matches it."""
    return min((W - 2) // 3, 4000)


def _long_runs(rng, H=8, W=300):
    """Random rows, and rows built so that one b starts a run of g that
    goes on for ~W/3 columns: p(x) = 2x after a NOMATCH, the target's
    q(3x) = 2 - 2x (no hit, the east check holds, the west check fails),
    every other q NOMATCH; row 4's run is broken in its middle by a hit
    (a q that matches p there), row 5's starts at column 1."""
    d0 = rng.integers(-3, 4, (H, W)).astype(f32)
    d1 = rng.integers(-3, 4, (H, W)).astype(f32)
    x = np.arange(W)
    e = _run_end(W)
    for y, s in ((1, 1), (2, 7), (3, 40), (4, 2), (5, 1)):
        d0[y], d1[y] = NOMATCH, NOMATCH
        d0[y, s:e] = 2 * x[s:e]
        d1[y, 3 * x[s:e]] = 2 - 2 * x[s:e]
    d1[4, 3 * (e // 2) - 1] = -2 * (e // 2)
    return d0, d1


UNIQUENESS_CASES = ["scene0", "scene1", "long runs", "wide", "edge rows", "empty box",
                    "empty target"]


def _uniqueness_case(label):
    """(d0, d1, m0, m1) of a uniqueness case, margins as lists of ints."""
    from torch_parity import random_scene

    from reconstruction_tpu_torch.stereo.margins import find_margin
    if label.startswith("scene"):
        rng = np.random.default_rng(100 + int(label[-1]))
        _, _, vL, vR, d0 = random_scene(rng)
        d1 = random_scene(rng)[4]
        return (d0, d1) + tuple([int(v) for v in find_margin(torch.from_numpy(v), 2)]
                                for v in (vL, vR))
    rng = np.random.default_rng(UNIQUENESS_CASES.index(label))
    if label == "long runs":
        d0, d1 = _long_runs(rng)
    elif label == "wide":                  # 282 words: two a thread at 256 threads
        d0, d1 = _long_runs(rng, H=6, W=9000)
    else:
        d0 = rng.integers(-3, 4, (10, 70)).astype(f32)
        d1 = -np.roll(d0, 2, 1) + rng.integers(-1, 2, (10, 70)).astype(f32)
        for d in (d0, d1):
            d[rng.uniform(size=d.shape) < 0.2] = NOMATCH
        d0[0], d1[3] = NOMATCH, NOMATCH                             # all-NOMATCH rows
        d0[1], d1[2] = rng.integers(-3, 4, (2, 70)).astype(f32)     # all-valid rows
    H, W = d0.shape
    full = [0, H - 1, 0, W - 1]
    m0 = {"empty box": [H - 3, 2, W - 3, 2]}.get(label, full)
    m1 = {"empty target": [0, H - 1, W - 3, 2]}.get(label, full)
    return _signed_zeros(d0, 2), _signed_zeros(d1, 3), m0, m1


@pytest.mark.parametrize("geometry", [(K11_WORD, K11_WARP, None), (8, 4, 8), (4, 2, 2)],
                         ids=["kernel", "8x4x8", "4x2x2"])
@pytest.mark.parametrize("label", UNIQUENESS_CASES)
def test_k11_block_scan_model_exact(label, geometry):
    """K11's three passes with the kill cascade in its bracketing (words of
    flags, each thread's run of words, the warp and block scans, the
    in-word finish) equal the plain uniqueness call bit for bit, at the
    kernel's geometry and at small ones, whose words, warps and runs put
    chunk boundaries inside every case."""
    d0, d1, m0, m1 = _uniqueness_case(label)
    word, warp, threads = geometry
    w0, w1 = K67.uniqueness_plain(torch.from_numpy(d0.copy()), torch.from_numpy(d1.copy()),
                                  _tm(m0), _tm(m1))
    g0, g1 = k11_model(d0, d1, m0, m1, word, warp, threads)
    np.testing.assert_array_equal(_bits(g0), _bits(w0))
    np.testing.assert_array_equal(_bits(g1), _bits(w1))


def test_k11_long_runs_are_killed_whole():
    """The long-run rows work as built: in the first pass one b kills its
    whole run of g (rows 1-3 and 5), and a hit in the middle of row 4's
    run stops the cascade there; so the carries cross every word and
    thread of those rows."""
    d0, d1 = _long_runs(np.random.default_rng(0))
    W = d0.shape[1]
    e = _run_end(W)
    full = _tm([0, d0.shape[0] - 1, 0, W - 1])
    out = K67.uniqueness_pass_plain(torch.from_numpy(d0), torch.from_numpy(d1), full,
                                    full).numpy()
    for y, s in ((1, 1), (2, 7), (3, 40), (5, 1)):
        assert (out[y, s:e] == NOMATCH).all(), y
    assert (out[4, 2:e // 2] == NOMATCH).all()
    assert (out[4, e // 2 + 1:e] != NOMATCH).all()
    g, b = k11_flags(d0, d1, [0, 7, 0, W - 1], [0, 7, 0, W - 1])
    assert b[2, 7] and not b[2, 8:e].any() and g[2, 7:e].all()


def test_k12_network_sorts():
    """The 12 comparators sort every 0-1 input (so every input: the 0-1
    principle), and every permutation of six distinct values."""
    import itertools
    ones = np.array(list(itertools.product([0, 1], repeat=6)), f32).T
    s, _ = k12_sort(ones, np.broadcast_to(np.arange(6)[:, None], ones.shape))
    assert (np.diff(s, axis=0) >= 0).all()
    perms = np.array(list(itertools.permutations(range(6))), f32).T
    s, idx = k12_sort(perms, np.broadcast_to(np.arange(6)[:, None], perms.shape))
    assert (s == np.arange(6)[:, None]).all()
    assert (np.take_along_axis(perms, idx, 0) == s).all()


@pytest.mark.parametrize("k", range(7))
def test_k12_network_equals_sort(k):
    """With k of the six window values valid, the network's values at the
    two middle ranks, and its whole order, equal `torch.sort`'s and the
    plain version's gathers bit for bit, on values with many ties, +0.0
    against -0.0 among them."""
    rng = np.random.default_rng(k)
    n = 20000
    pool = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 7.5, -3.0], f32)
    v = pool[rng.integers(0, len(pool), (6, n))]
    order = np.argsort(rng.uniform(size=(6, n)), axis=0)
    ok = np.take_along_axis(np.arange(6)[:, None] < k, order, 0)
    v = np.where(ok, v, f32(NOMATCH))
    kk, v_lo, v_hi = k12_pick(v, v != NOMATCH)
    assert (kk == k).all()
    vals = torch.from_numpy(v)
    tk = (vals != NOMATCH)
    svals = torch.sort(torch.where(tk, vals, torch.tensor(1e9, dtype=torch.float32)),
                       dim=0).values
    lo = torch.clamp((tk.sum(0) - 1) // 2, 0, 5)
    hi = torch.clamp(tk.sum(0) // 2, 0, 5)
    np.testing.assert_array_equal(_bits(v_lo), _bits(torch.gather(svals, 0, lo[None])[0]))
    np.testing.assert_array_equal(_bits(v_hi), _bits(torch.gather(svals, 0, hi[None])[0]))
    s, _ = k12_sort(np.where(v != NOMATCH, v, f32(1e9)),
                    np.broadcast_to(np.arange(6)[:, None], v.shape))
    np.testing.assert_array_equal(_bits(s), _bits(svals))


@pytest.mark.parametrize("label", CASES)
def test_k12_model_exact(label):
    """K12 (the window, the network, the rules) equals the plain masked
    median bit for bit, one iteration and two, with signed zeros."""
    d, v, ms, _ = _case(label)
    d = _signed_zeros(d, 4)
    for iters in (1, 2):
        want = K67.median_plain(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()),
                                _tm(ms), iters)
        np.testing.assert_array_equal(_bits(k12_model(d, v, ms, iters)), _bits(want))


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
    wrappers = (K67.ordering, K67.propagate_bounds, K67.smoothness, K67.uniqueness,
                K67.median)
    n = [w.launches for w in wrappers]
    D, V = torch.from_numpy(d), torch.from_numpy(v)
    assert torch.equal(tc.ordering_constraint(D, mt0), K67.ordering_plain(D, mt0))
    for a, b in zip(tc.propagate_bounds(D, V, mt0, mt1),
                    K67.propagate_bounds_plain(D, V, mt0, mt1)):
        assert torch.equal(a, b)
    assert torch.equal(tc.smoothness_constraint(D, mt0), K67.smoothness_plain(D, mt0))
    D1 = D.flip(1).contiguous()
    for a, b in zip(tc.uniqueness_constraint(D, D1, mt0, mt1),
                    K67.uniqueness_plain(D, D1, mt0, mt1)):
        assert torch.equal(a, b)
    assert torch.equal(tc.median_filter(D, V, mt0, 2), K67.median_plain(D, V, mt0, 2))
    assert [w.launches for w in wrappers] == n


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
    sel = valid & inner_box(m, H, W)
    assert torch.equal(BL[sel], BLp[sel]) and torch.equal(BR[sel], BRp[sel])


def _level_shapes():
    """(H, W) of every pyramid level of the `myself` and `dome32` rigs."""
    from reconstruction_tpu_torch.config import preset
    out = []
    for name in ("myself", "dome32"):
        cfg = preset(name)
        out += [cfg.level_size(lv)[::-1] for lv in range(cfg.pyramid_levels)]
    return out


def _pass_scene(dev, H, W, seed):
    """The card scene with holes denser down the rows (every window count
    of the median), some zeros signed, a target map that matches a shifted
    copy of it (hits and kills for the uniqueness passes), and, where the
    map has room, rows of all NOMATCH, all valid, and long runs of g
    (`_long_runs`)."""
    d0, valid = _card_scene(dev, H, W, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    yy = torch.arange(H, device=dev)[:, None].float()

    def rand():
        return torch.rand((H, W), generator=g, device=dev)

    d0 = torch.where(rand() < yy / max(H, 1), torch.full_like(d0, NOMATCH), d0)
    d0 = torch.where(rand() < 0.02, torch.zeros_like(d0), d0)
    d0 = torch.where(rand() < 0.02, torch.full_like(d0, -0.0), d0)
    shifted0 = torch.roll(d0, 45, 1)
    noise = torch.randint(-1, 2, (H, W), generator=g, device=dev).float()
    d1 = torch.where(shifted0 == NOMATCH, shifted0, -shifted0 + noise)
    if H >= 8 and W >= 16:
        r0, r1 = _long_runs(np.random.default_rng(seed), H=8, W=W)
        d0[:8], d1[:8] = torch.from_numpy(r0).to(dev), torch.from_numpy(r1).to(dev)
        d0[6], d1[7] = NOMATCH, NOMATCH
    return d0.contiguous(), d1.contiguous(), valid


def _cpu(m):
    return Margins(*[v.cpu() for v in m])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", _level_shapes() + [(5, 37), (8, K67.MAX_WIDTH)])
def test_k10_k11_k12_equal_plain_on_card(dev, H, W):
    """K10, K11 and K12 equal their plain versions, run on the same maps
    moved to the CPU, bit for bit, with the rig's margins, with a box of
    the whole map and with an empty box (YL > YR, XL > XR); one launch a
    call (a K12 iteration)."""
    from reconstruction_tpu_torch.stereo.margins import find_margin
    d0, d1, valid = _pass_scene(dev, H, W, seed=H * 7 + W)
    i32 = dict(dtype=torch.int32, device=dev)
    full = Margins(*[torch.tensor(v, **i32) for v in (0, H - 1, 0, W - 1)])
    empty = Margins(*[torch.tensor(v, **i32) for v in (H - 1, 0, W - 1, 0)])
    D0, D1, V = d0.cpu(), d1.cpu(), valid.cpu()
    for m in (find_margin(valid, 2), full, empty):
        n = (K67.smoothness.launches, K67.uniqueness.launches, K67.median.launches)
        s = K67.smoothness(d0, m)
        u0, u1 = K67.uniqueness(d0, d1, m, full)
        md = K67.median(d0, valid, m, 2)
        assert (K67.smoothness.launches - n[0], K67.uniqueness.launches - n[1],
                K67.median.launches - n[2]) == (1, 1, 2)
        mc = _cpu(m)
        np.testing.assert_array_equal(_bits(s.cpu()), _bits(K67.smoothness_plain(D0, mc)))
        w0, w1 = K67.uniqueness_plain(D0, D1, mc, _cpu(full))
        np.testing.assert_array_equal(_bits(u0.cpu()), _bits(w0))
        np.testing.assert_array_equal(_bits(u1.cpu()), _bits(w1))
        np.testing.assert_array_equal(_bits(md.cpu()), _bits(K67.median_plain(D0, V, mc, 2)))
    if H >= 8 and W >= 16:             # the long runs were killed whole
        u0 = K67.uniqueness(d0, d1, full, full)[0]
        assert bool((u0[1, 1:_run_end(W)] == NOMATCH).all())
    if H * W >= 100_000:               # every window count of the median
        from reconstruction_tpu_torch.stereo.ncc import shifted
        ok = torch.stack([shifted(D0, dy, dx) != NOMATCH
                          for dy, dx in K67.MEDIAN_OFFSETS]).sum(0)
        assert set(ok.unique().tolist()) == set(range(7))


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
        s = K67.smoothness(d, m)
        u0, u1 = K67.uniqueness(s, ok, m, m)
        K67.median(u0, valid, m, 2)
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
    with pytest.raises(ValueError):
        K67.smoothness(d, m)
    with pytest.raises(ValueError):
        K67.uniqueness(d, d, m, m)
    with pytest.raises(ValueError):
        K67.median(d, d > 0, m)
