"""Fixed-radius neighbor search on a voxel grid (counterpart of
`reconstruction_tpu/cloud/neighbors.py`).

Points are quantized to cells of size ``cell`` (>= the search radius) and
sorted by cell id; a query's candidates are up to ``per_cell`` points of
each of its 27 adjacent cells, masked to the radius.  Queries stream
through in chunks and each chunk is reduced by a callback, so candidates
never exist beyond one (chunk, 27 * per_cell) block.

Two grids, as in the reference: the sorted grid (`build_grid`, binary
search of the 27 cell ids) and the dense grid (`build_dense_grid`, a
table of cell starts from the host-side geometry), the production path.
Sorts are stable, like `jnp.argsort`: which ``per_cell`` points of a full
cell are candidates depends on it.  A query with no validity gets the
callback's result for a query with no candidate, without being gathered.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_INVALID_ID = 2 ** 30

_OFFS = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
                             indexing="ij"), axis=-1).reshape(27, 3)

# Device memory a chunk's candidates may take (bytes per candidate counted
# for the gathered positions, distances, masks, indices and a callback's
# temporaries).
_CHUNK_BUDGET = {"cuda": 2 << 30, "cpu": 128 << 20}
_BYTES_PER_CANDIDATE = 96


def auto_chunk(per_cell: int, device: torch.device) -> int:
    """Queries per chunk: as many as the device's budget holds (every
    reduction is per query, so the chunk changes no result)."""
    budget = _CHUNK_BUDGET.get(torch.device(device).type, _CHUNK_BUDGET["cpu"])
    c = budget // (_BYTES_PER_CANDIDATE * 27 * per_cell)
    return int(max(256, c // 256 * 256))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32, device=device)


def _stream(queries, q_valid, fn, K, chunk, chunk_fn):
    """Run ``chunk_fn(q, qv, qi)`` over chunks of the valid queries and
    scatter its per-query outputs (a tuple, or one tensor) back to all M
    queries; invalid queries get ``fn``'s result for a query whose K
    candidates are all masked out."""
    M = queries.shape[0]
    dev = queries.device
    q = queries.float()
    sel = torch.nonzero(q_valid, as_tuple=True)[0]
    one = q[:1] if M else torch.zeros((1, 3), device=dev)
    empty = fn(one, torch.zeros((1, K), dtype=torch.int64, device=dev),
               torch.zeros((1, K, 3), device=dev),
               torch.full((1, K), float("inf"), device=dev),
               torch.zeros((1, K), dtype=torch.bool, device=dev))
    single = not isinstance(empty, tuple)
    empty = (empty,) if single else empty
    outs = [e.expand((M,) + e.shape[1:]).clone() for e in empty]
    for s in range(0, sel.numel(), chunk):
        qi = sel[s:s + chunk]
        res = chunk_fn(q[qi], torch.ones_like(qi, dtype=torch.bool), qi)
        res = (res,) if single else res
        for o, r in zip(outs, res):
            o[qi] = r.to(o.dtype)
    return outs[0] if single else tuple(outs)


# ---------------------------------------------------------------------------
# Sorted grid (binary search of the cell ids).
# ---------------------------------------------------------------------------


class VoxelGrid(NamedTuple):
    points: torch.Tensor      # (N, 3) original points
    valid: torch.Tensor       # (N,) bool
    order: torch.Tensor       # (N,) sort order (invalid last)
    sorted_ids: torch.Tensor  # (N,) flattened cell id per sorted point
    origin: torch.Tensor      # (3,) grid origin
    dims: torch.Tensor        # (3,) grid dims
    cell: torch.Tensor        # scalar cell size


class NeighborSet(NamedTuple):
    """Padded neighbor candidates for M query points."""

    idx: torch.Tensor    # (M, K) indices into the original point array
    dist2: torch.Tensor  # (M, K) squared distances (inf where invalid)
    ok: torch.Tensor     # (M, K) bool


def build_grid(points: torch.Tensor, valid: torch.Tensor, cell) -> VoxelGrid:
    pts = points.float()
    dev = pts.device
    cell_t = _f32(cell, dev)
    big = 1e30
    origin = torch.where(valid[:, None], pts, big).amin(0)
    origin = torch.where(torch.isfinite(origin) & (origin < 1e29), origin, 0.0)
    maxc = torch.where(valid[:, None], pts, -big).amax(0)
    maxc = torch.where(torch.isfinite(maxc) & (maxc > -1e29), maxc, 0.0)
    dims = torch.clamp_min(((maxc - origin) / cell_t).to(torch.int64) + 2, 1)
    ci = torch.minimum(torch.clamp_min(((pts - origin) / cell_t).to(torch.int64), 0),
                       dims - 1)
    ids = (ci[:, 0] * dims[1] + ci[:, 1]) * dims[2] + ci[:, 2]
    ids = torch.where(valid, ids, _INVALID_ID)
    order = torch.argsort(ids, stable=True)
    return VoxelGrid(points=pts, valid=valid, order=order, sorted_ids=ids[order],
                     origin=origin, dims=dims, cell=cell_t)


def neighbor_map(grid: VoxelGrid, queries: torch.Tensor, q_valid: torch.Tensor,
                 radius, fn, per_cell: int = 8, chunk: Optional[int] = None,
                 exclude_self: bool = False):
    """Stream the queries through the 27-cell candidate gather of the
    sorted grid and reduce each chunk with ``fn(q, cand, cpts, d2, ok)``
    (q (c, 3), cand (c, K) original indices, cpts (c, K, 3), d2 (c, K),
    ok (c, K)); returns fn's per-query outputs for all M queries."""
    dev = queries.device
    K = 27 * per_cell
    r = _f32(radius, dev)
    r2 = r * r
    N = grid.points.shape[0]
    offs = torch.as_tensor(_OFFS, device=dev)
    jj = torch.arange(per_cell, device=dev)
    dims = grid.dims

    def chunk_fn(q, qv, qi):
        c = q.shape[0]
        ci = torch.minimum(torch.clamp_min(((q - grid.origin) / grid.cell)
                                           .to(torch.int64), 0), dims - 1)
        nb = ci[:, None, :] + offs[None]
        in_grid = ((nb >= 0) & (nb < dims)).all(-1)
        nbc = torch.minimum(torch.clamp_min(nb, 0), dims - 1)
        nb_ids = (nbc[..., 0] * dims[1] + nbc[..., 1]) * dims[2] + nbc[..., 2]
        nb_ids = torch.where(in_grid, nb_ids, _INVALID_ID - 1)
        start = torch.searchsorted(grid.sorted_ids, nb_ids.reshape(-1)).reshape(c, 27)
        cand_sorted = torch.clamp(start[..., None] + jj, 0, N - 1)
        in_cell = (grid.sorted_ids[cand_sorted] == nb_ids[..., None]).reshape(c, K)
        cand = grid.order[cand_sorted].reshape(c, K)
        cpts = grid.points[cand]
        d2 = ((cpts - q[:, None, :]) ** 2).sum(-1)
        ok = in_cell & (d2 <= r2) & qv[:, None]
        if exclude_self:
            ok = ok & (cand != qi[:, None])
        d2 = torch.where(ok, d2, float("inf"))
        return fn(q, cand, cpts, d2, ok)

    chunk = chunk or auto_chunk(per_cell, dev)
    return _stream(queries, q_valid, fn, K, chunk, chunk_fn)


def gather_neighbors(grid: VoxelGrid, queries: torch.Tensor, q_valid: torch.Tensor,
                     radius, per_cell: int = 8, chunk: Optional[int] = None,
                     exclude_self: bool = False) -> NeighborSet:
    """Materialized candidates within ``radius`` of each query: O(M * 27 *
    per_cell) memory, for tests and small clouds."""
    idx, d2, ok = neighbor_map(
        grid, queries, q_valid, radius, lambda q, cand, cpts, d2, ok: (cand, d2, ok),
        per_cell=per_cell, chunk=chunk, exclude_self=exclude_self)
    return NeighborSet(idx=idx, dist2=d2, ok=ok)


# ---------------------------------------------------------------------------
# Dense grid: the production path.  The cell dims are computed on the host
# (every caller holds the cloud there), so cell starts are one table lookup
# and candidates are 27 contiguous slices of the cell-sorted points.
# ---------------------------------------------------------------------------


class DenseGrid(NamedTuple):
    sorted_pts: torch.Tensor  # (N + pad, 3) points in cell order
    order: torch.Tensor       # (N + pad,) original index per slot (-1 in the pad)
    starts: torch.Tensor      # (G + 3,) exclusive prefix of cell counts
    origin: torch.Tensor      # (3,)
    cell: torch.Tensor        # scalar


def robust_bbox(pts: np.ndarray, quantile: float = 5e-3):
    """Per-axis outlier-robust bounding box: the [q, 1-q] quantile box
    intersected with the Tukey fence [Q25 - 1.5 IQR, Q75 + 1.5 IQR]
    (immune to outliers up to 25% of the points)."""
    lo_q = np.quantile(pts, quantile, axis=0)
    hi_q = np.quantile(pts, 1.0 - quantile, axis=0)
    q25 = np.quantile(pts, 0.25, axis=0)
    q75 = np.quantile(pts, 0.75, axis=0)
    iqr = np.maximum(q75 - q25, 1e-6)
    lo = np.maximum(lo_q, q25 - 1.5 * iqr)
    hi = np.minimum(hi_q, q75 + 1.5 * iqr)
    return lo, hi


def host_grid_geometry(points, valid, cell, round_to=32,
                       max_cells=32_000_000, quantile=5e-3):
    """Host-side grid geometry: origin (np (3,)), dims tuple, and the cell
    size used (>= requested).  The box is `robust_bbox` of the valid points
    (on a subsample above 200k), so triangulation outliers clamp into
    border cells instead of blowing up the table; the cell grows by 1.5x
    until the table fits ``max_cells`` (a bigger cell keeps the 27 cells a
    superset of the search ball).  Dims round up to ``round_to``."""
    pts = np.asarray(points, np.float32)
    v = np.asarray(valid).astype(bool)
    cell = float(cell)
    if not v.any():
        return (np.zeros(3, np.float32), (round_to, round_to, round_to),
                max(cell, 1e-12))
    sel = pts[v]
    if len(sel) > 200_000:
        sel = sel[:: len(sel) // 200_000 + 1]
    lo, hi = robust_bbox(sel, quantile)
    ext = np.maximum(hi - lo, 1e-6)
    cell = max(cell, 1e-12)
    while True:
        dims = np.maximum((ext / cell).astype(np.int64) + 2, 1)
        dims = ((dims + round_to - 1) // round_to) * round_to
        if int(dims[0] * dims[1] * dims[2]) <= max_cells:
            break
        cell *= 1.5
    origin = (lo - cell).astype(np.float32)  # one guard cell of margin
    return (origin, (int(dims[0]), int(dims[1]), int(dims[2])), cell)


def _cell_index(pts, origin, cell, dims):
    hi = torch.as_tensor(dims, device=pts.device) - 1
    return torch.minimum(torch.clamp_min(((pts - origin) / cell).to(torch.int64), 0), hi)


def build_dense_grid(points: torch.Tensor, valid: torch.Tensor, origin, cell,
                     dims: Tuple[int, int, int], pad: int = 64) -> DenseGrid:
    G = dims[0] * dims[1] * dims[2]
    pts = points.float()
    dev = pts.device
    origin_t, cell_t = _f32(origin, dev), _f32(cell, dev)
    ci = _cell_index(pts, origin_t, cell_t, dims)
    ids = (ci[:, 0] * dims[1] + ci[:, 1]) * dims[2] + ci[:, 2]
    ids = torch.where(valid, ids, G)          # bucket G collects invalid points
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=G + 2)   # bucket G+1 stays empty
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)])
    far = torch.full((pad, 3), 1e30, device=dev)
    return DenseGrid(
        sorted_pts=torch.cat([pts[order], far]),
        order=torch.cat([order, torch.full((pad,), -1, dtype=torch.int64, device=dev)]),
        starts=starts, origin=origin_t, cell=cell_t)


def neighbor_map_dense(grid: DenseGrid, queries: torch.Tensor, q_valid: torch.Tensor,
                       radius, fn, dims: Tuple[int, int, int], per_cell: int = 8,
                       chunk: Optional[int] = None, exclude_self: bool = False):
    """`neighbor_map`'s contract on the dense grid: each query takes the
    first ``per_cell`` points of each adjacent cell, one contiguous slice a
    cell.  The grid's pad must be at least ``per_cell``."""
    dev = queries.device
    G = dims[0] * dims[1] * dims[2]
    K = 27 * per_cell
    r = _f32(radius, dev)
    r2 = r * r
    dims_t = torch.as_tensor(dims, device=dev)
    offs = torch.as_tensor(_OFFS, device=dev)
    jj = torch.arange(per_cell, device=dev)

    def chunk_fn(q, qv, qi):
        c = q.shape[0]
        nb = _cell_index(q, grid.origin, grid.cell, dims)[:, None, :] + offs[None]
        in_grid = ((nb >= 0) & (nb < dims_t)).all(-1)
        nbc = torch.minimum(torch.clamp_min(nb, 0), dims_t - 1)
        nb_ids = (nbc[..., 0] * dims[1] + nbc[..., 1]) * dims[2] + nbc[..., 2]
        nb_ids = torch.where(in_grid, nb_ids, G + 1)     # the empty bucket
        s = grid.starts[nb_ids]
        cnt = torch.clamp(grid.starts[nb_ids + 1] - s, max=per_cell)
        slot = s[..., None] + jj                          # (c, 27, per_cell)
        cpts = grid.sorted_pts[slot].reshape(c, K, 3)
        cord = grid.order[slot].reshape(c, K)
        within = (jj < cnt[..., None]).reshape(c, K)
        d2 = ((cpts - q[:, None, :]) ** 2).sum(-1)
        ok = within & (d2 <= r2) & qv[:, None]
        if exclude_self:
            ok = ok & (cord != qi[:, None])
        d2 = torch.where(ok, d2, float("inf"))
        return fn(q, cord, cpts, d2, ok)

    chunk = chunk or auto_chunk(per_cell, dev)
    return _stream(queries, q_valid, fn, K, chunk, chunk_fn)
