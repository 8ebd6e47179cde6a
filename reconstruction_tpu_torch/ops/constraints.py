"""K6 (the ordering constraint's greedy crossing removal) and K7 (the
disparity-bound propagation): the wrappers of `csrc/constraints.cu`, each
beside its plain PyTorch version.

Both passes are sequential along a scanline in the reference
(`CStereoMatching.cpp:310-368`, `:817-942`).  The plain versions are the
JAX package's TPU formulation: a greedy loop stepped for all rows at once
whose end is read back from the device every few steps, and associative
scans evaluated with `jax.lax.associative_scan`'s pairing tree.  K6 gives
a row to a thread block (crossing counts by merge sort, the greedy loop
on one warp over the points that cross any); K7 composes its step
functions in segments of a column (128 a column) and in runs of a row (a
warp's 32 lanes), scans them across the segments and lanes and replays
them (`k7_layout`).  The margins are read from the device: a call never
waits for the device.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each
wrapper adds the kernels it launches to its `.launches` attribute: one a
K6 call, two a K7 call (the column pass, then the row pass).

Exactness.  K6 is comparisons and integer counts: bit-equal to
`ordering_plain` everywhere.  K7 groups the scans' operator in another
way than the scan tree, so its sums of the +-1e9 reset sentinels may
round to another multiple of 64; every term that can win a max or min at
an output is a sum of small integers, so the outputs are bit-equal to
`propagate_bounds_plain` at every mask-valid source pixel, the pixels the
reference defines them at (the CPU tests model the kernels' grouping and
find them equal everywhere on their inputs).
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Tuple

import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.ops.ncc_sweep import _dispatch, _require_cuda
from reconstruction_tpu_torch.stereo.margins import Margins, inner_box
from reconstruction_tpu_torch.stereo.ncc import shifted

_BIG = 1e9
_NM = float(NOMATCH)
# Widest row the kernels take: K6 keeps 14 bytes a column of a row in
# shared memory (227 KB at most a block), K7's row pass 9, and K6's
# (count, index) key and sort buffers hold an index in 16 bits
# (csrc/constraints.cu, RTT_CONSTRAINTS_MAX_W).
MAX_WIDTH = 16384
# K7's layout entries (`k7_layout`, `rtt_propagate_bounds_layout`).
_K7_LAYOUT_KEYS = ("columns_a_block", "segments", "segment_rows", "run", "rows_a_block",
                   "column_blocks", "row_blocks")


def _nm(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_NM, dtype=torch.float32, device=like.device)


def _margin_specs(*ms: Margins) -> list:
    return [(v, torch.int32, ()) for m in ms for v in m]


# ---------------------------------------------------------------------------
# K6: ordering
# ---------------------------------------------------------------------------

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


def ordering(disp: torch.Tensor, m: Margins) -> torch.Tensor:
    """K6 on CUDA tensors, `ordering_plain` on CPU tensors.

    disp: (H, W) float32; m: the source view's margins, 0-d int32 tensors
    on disp's device (the kernel reads them there).  Rows up to MAX_WIDTH
    columns; a wider one raises."""
    if _dispatch(disp):
        return ordering_plain(disp, m)
    H, W = disp.shape
    if W > MAX_WIDTH:
        raise ValueError(f"ordering: {W} columns, the kernel takes at most {MAX_WIDTH}")
    dev = _require_cuda("ordering", [(disp, torch.float32, (H, W))] + _margin_specs(m))
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W == 0:
        return out
    _build.launch("rtt_ordering", disp.data_ptr(), out.data_ptr(),
                  *[v.data_ptr() for v in m], H, W)
    ordering.launches += 1
    return out


ordering.launches = 0


# ---------------------------------------------------------------------------
# K7: bound propagation (SetBoundary_smooth)
# ---------------------------------------------------------------------------

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


def k7_layout(H: int, W: int) -> dict:
    """K7's geometry at H x W as `csrc/constraints.cu` defines it
    (`rtt_propagate_bounds_layout`; needs the built kernels): columns a
    column-pass block, segments a column and rows a segment, columns a
    lane's run of a row, rows (warps) a row-pass block, and each pass's
    blocks."""
    out = (ctypes.c_int * len(_K7_LAYOUT_KEYS))()
    _build.check(_build.load().rtt_propagate_bounds_layout(H, W, out),
                 "rtt_propagate_bounds_layout")
    return dict(zip(_K7_LAYOUT_KEYS, out))


def propagate_bounds(
    disp: torch.Tensor,
    valid_mask: torch.Tensor,
    m_src: Margins,
    m_tgt: Margins,
    max_step: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on CUDA tensors (a column pass, then a row pass),
    `propagate_bounds_plain` on CPU tensors.

    disp: (H, W) float32; valid_mask: (H, W) bool; m_src, m_tgt: margins
    of the source and target views, 0-d int32 tensors on disp's device.
    Rows up to MAX_WIDTH columns; a wider one raises."""
    if _dispatch(disp):
        return propagate_bounds_plain(disp, valid_mask, m_src, m_tgt, max_step)
    H, W = disp.shape
    if W > MAX_WIDTH:
        raise ValueError(f"propagate_bounds: {W} columns, the kernel takes at most "
                         f"{MAX_WIDTH}")
    dev = _require_cuda("propagate_bounds", [
        (disp, torch.float32, (H, W)), (valid_mask, torch.bool, (H, W))]
        + _margin_specs(m_src, m_tgt))
    BL = torch.empty((H, W), dtype=torch.float32, device=dev)
    BR = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W == 0:
        return BL, BR
    _build.launch("rtt_propagate_bounds", disp.data_ptr(), valid_mask.data_ptr(),
                  *[v.data_ptr() for v in m_src], m_tgt.XL.data_ptr(),
                  m_tgt.XR.data_ptr(), BL.data_ptr(), BR.data_ptr(),
                  float(max_step), H, W)
    propagate_bounds.launches += 2                 # the column pass and the row pass
    return BL, BR


propagate_bounds.launches = 0
