"""Plain PyTorch row-sequential constraint passes: the ordering
constraint's greedy crossing removal and the disparity-bound propagation
(a frozen copy of the port's plain versions, the JAX package's TPU
formulation: a greedy loop stepped for all rows at once, and associative
scans evaluated in `jax.lax.associative_scan`'s pairing tree)."""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from portbench.reference.config import NOMATCH
from portbench.reference.stereo.margins import Margins, inner_box
from portbench.reference.stereo.ncc import shifted


_BIG = 1e9



_NM = float(NOMATCH)



def _nm(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_NM, dtype=torch.float32, device=like.device)



_MAX_PAIRS = 1 << 24   # bound on the (rows, W, W) crossing intermediate



_CHECK_EVERY = 8       # ordering steps between reads of the loop's end



def _crossings(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per point, the number of valid points on its row that cross it:
    (x_j < x_i and t_j > t_i) or (x_j > x_i and t_j < t_i).  O(W^2) per
    row, chunked over rows to bound the (rows, W, W) intermediate."""
    H, W = t.shape
    xs = torch.arange(W, device=t.device)
    before = xs[None, :] < xs[:, None]       # [i, j]: x_j < x_i
    after = xs[None, :] > xs[:, None]
    out = torch.empty((H, W), dtype=torch.int32, device=t.device)
    rows = max(1, _MAX_PAIRS // (W * W))
    for r0 in range(0, H, rows):
        tc = t[r0:r0 + rows]
        vc = valid[r0:r0 + rows]
        ti, tj = tc[:, :, None], tc[:, None, :]
        cross = (before & (tj > ti)) | (after & (tj < ti))
        cross &= vc[:, :, None] & vc[:, None, :]
        out[r0:r0 + rows] = cross.sum(dim=2, dtype=torch.int32)
    return out



def ordering_plain(disp: torch.Tensor, m: Margins) -> torch.Tensor:
    """Greedy epipolar-order enforcement (`CStereoMatching.cpp:310-368`).

    Every row repeatedly deletes its point with the most crossings (the
    first such point on ties) until none cross.  All rows step together;
    a row with no crossings left is untouched, exactly like the
    reference's per-row while loop.  The loop's end is read back from the
    device once every few steps (extra steps are no-ops)."""
    H, W = disp.shape
    dev = disp.device
    box = inner_box(m, H, W)
    d = torch.where(box, disp, _nm(disp))
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    t = d + xs
    alive = d != NOMATCH
    cnt = _crossings(t, alive)
    rows = torch.arange(H, device=dev)
    step = 0
    while True:
        if step % _CHECK_EVERY == 0 and not bool((cnt > 0).any()):
            break
        step += 1
        live_row = cnt.max(dim=1).values > 0
        k = torch.argmax(cnt, dim=1)           # first maximum, like jnp.argmax
        xk = k.to(torch.float32)[:, None]
        tk = t[rows, k][:, None]
        col = (((xs < xk) & (t > tk)) | ((xs > xk) & (t < tk))) & alive
        col &= live_row[:, None]
        cnt = cnt - col.to(torch.int32)
        r_live = rows[live_row]
        k_live = k[live_row]
        cnt[r_live, k_live] = 0
        alive[r_live, k_live] = False
        d[r_live, k_live] = _NM
    return torch.where(box, d, disp)



def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (len(a) - len(b) in {0, 1})."""
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    idx_a = torch.arange(0, n, 2, device=a.device)
    idx_b = torch.arange(1, n, 2, device=a.device)
    out.index_copy_(dim, idx_a, a)
    out.index_copy_(dim, idx_b, b)
    return out



def _slice(t: torch.Tensor, dim: int, start: int, stop, step: int = 1):
    n = t.shape[dim]
    stop = n if stop is None else (stop if stop >= 0 else n + stop)
    idx = torch.arange(start, stop, step, device=t.device)
    return t.index_select(dim, idx)



def associative_scan(fn: Callable, elems: List[torch.Tensor], dim: int,
                     reverse: bool = False) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` along ``dim`` with the pairing tree of
    `jax.lax.associative_scan` (odd/even recursion), so that a non-exact
    associative ``fn`` rounds exactly as the reference does."""
    if reverse:
        elems = [e.flip(dim) for e in elems]

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        reduced = fn([_slice(e, dim, 0, -1, 2) for e in es],
                     [_slice(e, dim, 1, None, 2) for e in es])
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn([_slice(e, dim, 0, -1) for e in odd],
                      [_slice(e, dim, 2, None, 2) for e in es])
        else:
            even = fn(odd, [_slice(e, dim, 2, None, 2) for e in es])
        even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                for e, r in zip(es, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    out = scan(list(elems))
    if reverse:
        out = [e.flip(dim) for e in out]
    return out



def _scan_shift_bound(s: torch.Tensor, mvals: torch.Tensor, dim: int,
                      reverse: bool, is_max: bool) -> torch.Tensor:
    """Prefix-compose f(c) = max/min(c + s, m) along ``dim``."""
    op = torch.maximum if is_max else torch.minimum

    def combine(a, b):
        s1, m1 = a
        s2, m2 = b
        return [s1 + s2, op(m1 + s2, m2)]

    return associative_scan(combine, [s, mvals], dim, reverse)[1]



def propagate_bounds_plain(
    disp: torch.Tensor,
    valid_mask: torch.Tensor,
    m_src: Margins,
    m_tgt: Margins,
    max_step: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Admissible target-column intervals [BL, BR] for hole re-matching
    (`SetBoundary_smooth`, `CStereoMatching.cpp:817-942`): valid
    disparities seed the bounds; down, up, left->right and right->left
    sweeps relax them.  Absolute-column float32 maps, meaningful at
    mask-valid source pixels."""
    H, W = disp.shape
    dev = disp.device
    f32 = torch.float32

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    box = inner_box(m_src, H, W)
    mask = valid_mask & box
    has_d = mask & (disp != NOMATCH)
    ref = torch.where(has_d, disp, c(0.0))
    MD = float(max_step)
    lo_init, hi_init, big = c(-10000.0), c(10000.0), c(_BIG)

    def vertical(reverse: bool):
        s_lo = torch.where(mask & ~has_d, c(-MD), -big)
        m_lo = torch.where(has_d, ref - MD, lo_init)
        m_lo = torch.where(mask, torch.maximum(m_lo, lo_init), lo_init)
        c_lo = _scan_shift_bound(s_lo, m_lo, 0, reverse, True)
        s_hi = torch.where(mask & ~has_d, c(MD), big)
        m_hi = torch.where(has_d, ref + MD, hi_init)
        m_hi = torch.where(mask, torch.minimum(m_hi, hi_init), hi_init)
        c_hi = _scan_shift_bound(s_hi, m_hi, 0, reverse, False)
        lo_row = lo_init.expand(1, W)
        hi_row = hi_init.expand(1, W)
        if reverse:
            return (torch.cat([c_lo[1:], lo_row], 0),
                    torch.cat([c_hi[1:], hi_row], 0))
        return (torch.cat([lo_row, c_lo[:-1]], 0),
                torch.cat([hi_row, c_hi[:-1]], 0))

    dn_lo, dn_hi = vertical(False)
    up_lo, up_hi = vertical(True)
    BL = torch.where(has_d, ref, torch.maximum(dn_lo, up_lo))
    BR = torch.where(has_d, ref, torch.minimum(dn_hi, up_hi))
    # Row YL: the down sweep pins valid pixels first, then the up sweep
    # max-writes into them (`:872-881` runs after `:842-869`).
    y_idx = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    at_yl = (y_idx == m_src.YL) & has_d
    BL = torch.where(at_yl, torch.maximum(ref, up_lo), BL)
    BR = torch.where(at_yl, torch.minimum(ref, up_hi), BR)

    # Forward horizontal (`:903-916`).
    mask_w = shifted(mask, 0, -1)                     # mask at x-1
    BL = _scan_shift_bound(torch.where(mask_w, c(-1.0), -big), BL, 1,
                           False, True)
    BR = _scan_shift_bound(torch.where(mask_w, c(MD), big), BR, 1,
                           False, False)

    # Backward horizontal with absolute conversion (`:917-940`).
    x = torch.arange(W, dtype=f32, device=dev)[None, :]
    XL1 = m_tgt.XL.to(f32)
    XR1 = m_tgt.XR.to(f32)
    s_lo = torch.where(mask, c(-MD), -big)
    m_lo = torch.where(mask, torch.maximum(BL, XL1 - x) - MD, -big)
    c_lo = _scan_shift_bound(s_lo, m_lo, 1, True, True)
    inc_lo = torch.cat([c_lo[:, 1:], (-big).expand(H, 1)], 1)
    BL_abs = torch.maximum(torch.maximum(BL, inc_lo) + x, XL1)

    s_hi = torch.where(mask, c(1.0), big)
    m_hi = torch.where(mask, torch.minimum(BR, XR1 - x) + 1.0, big)
    c_hi = _scan_shift_bound(s_hi, m_hi, 1, True, False)
    inc_hi = torch.cat([c_hi[:, 1:], big.expand(H, 1)], 1)
    BR_abs = torch.minimum(torch.minimum(BR, inc_hi) + x, XR1)
    return BL_abs, BR_abs



ordering = ordering_plain
propagate_bounds = propagate_bounds_plain
