"""Point-cloud outlier filters (counterpart of
`reconstruction_tpu/cloud/filters.py`).

Statistical outlier removal replaces PCL's
`StatisticalOutlierRemoval(meanK, stddev)` (`CCloudOptimization.cpp:82-86`):
a per-point mean distance to the k nearest neighbors, then a global
mu + thresh * sigma gate.  The k-NN statistic comes from the dense voxel
grid's capped candidates through a distance histogram.  The optional
radius filter mirrors the reference's commented-out
`RadiusOutlierRemoval` (`CCloudOptimization.cpp:90-96`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from reconstruction_tpu_torch.cloud.neighbors import (
    build_dense_grid, host_grid_geometry, neighbor_map_dense, robust_bbox)
from reconstruction_tpu_torch.cloud.normals import _host


def _mean_spacing(pts: np.ndarray, v: np.ndarray) -> float:
    """Mean point spacing of a surface-like cloud from its robust box and
    its true count (points scale with area)."""
    if not v.any():
        return 1.0
    n_total = int(v.sum())
    sel = pts[v]
    if len(sel) > 200_000:
        sel = sel[:: len(sel) // 200_000 + 1]
    lo, hi = robust_bbox(sel)
    ext = np.sort(np.maximum(hi - lo, 1e-6))
    area = float(ext[1] * ext[2])
    return float(np.sqrt(area / max(n_total, 1)))


@lru_cache(None)
def _knn_stat(k: int, bins: int = 32):
    def fn(q, cand, cpts, d2, ok):
        """Per-query mean of the k nearest candidate distances, read off a
        ``bins``-bucket histogram whose edges are relative to the query's
        farthest candidate: whole bins below the k-th distance, the
        straddling bin at its mean distance.  The bins are summed one
        after the other with plain masked reductions, so the sums are the
        same on every run; on the card this is faster than the
        fixed-order path of one `scatter_add_` (atomic adds would not be
        deterministic)."""
        dist = torch.sqrt(torch.where(ok, d2, 0.0))
        w = dist.amax(-1) + 1e-12
        bi = torch.clamp((dist / w[..., None] * bins).to(torch.int32), 0, bins - 1)
        bi = torch.where(ok, bi, bins)               # not a candidate: no bin
        cnts, sums = [], []
        for b in range(bins):
            mb = bi == b
            cnts.append(mb.sum(-1))
            sums.append(torch.where(mb, dist, 0.0).sum(-1))
        cnt = torch.stack(cnts, -1).float()
        sm = torch.stack(sums, -1)
        ccum = torch.cumsum(cnt, -1)
        total = ccum[..., -1]
        m = torch.clamp(total, max=float(k))         # effective k
        need = torch.minimum(torch.clamp_min(m[..., None] - (ccum - cnt), 0.0), cnt)
        avg_bin = sm / torch.clamp_min(cnt, 1.0)
        md = (need * avg_bin).sum(-1) / torch.clamp_min(m, 1.0)
        # Truncated neighborhoods: the mean-of-k-NN distance of a locally
        # uniform surface scales as sqrt(k), so m < k found candidates are
        # extrapolated by sqrt(k / m).
        md = md * torch.sqrt(float(k) / torch.clamp_min(m, 1.0))
        return md, total > 0

    return fn


def sor_filter(
    points: torch.Tensor,
    valid: torch.Tensor,
    mean_k: int = 100,
    std_thresh: float = 1.0,
    per_cell: int = 32,
    chunk: Optional[int] = None,
    host_points: Optional[np.ndarray] = None,
    host_valid: Optional[np.ndarray] = None,
    backend: str = "auto",
):
    """The updated validity mask (outliers dropped): a bool tensor on the
    points' device ("torch"), or a numpy array ("native", the C++ exact
    k-NN on the host).  host_points / host_valid: host copies for the grid
    geometry."""
    from reconstruction_tpu_torch.cloud.backend import resolve_backend
    pts_np = _host(points, np.float32) if host_points is None else host_points
    v_np = _host(valid, bool) if host_valid is None else host_valid
    spacing = _mean_spacing(pts_np, v_np)
    # Cell sized so 27 cells usually hold >= mean_k candidates.
    cell = spacing * float(np.sqrt(mean_k)) * 0.6 + 1e-6
    if resolve_backend(backend) == "native":
        from reconstruction_tpu_torch import native
        mean_d, has = native.cloud_sor_stats(pts_np, v_np, float(cell), mean_k)
        return _sor_gate_np(mean_d, has, v_np, float(cell), float(std_thresh))
    origin, dims, cell = host_grid_geometry(pts_np, v_np, cell)
    grid = build_dense_grid(points, valid, origin, cell, dims, pad=per_cell)
    k = min(mean_k, 27 * per_cell)
    mean_d, has = neighbor_map_dense(grid, points, valid, cell, _knn_stat(k), dims,
                                     per_cell=per_cell, chunk=chunk, exclude_self=True)
    return _sor_gate(mean_d, has, valid, cell, std_thresh)


def _sor_gate_np(mean_d, has, valid, cell, std_thresh):
    """numpy twin of `_sor_gate` (same imputation and mu / sigma)."""
    has_nb = has & valid
    imputed = np.where(valid & ~has_nb, 10.0 * cell, mean_d)
    denom = max(int(valid.sum()), 1)
    mu = float(np.where(valid, imputed, 0.0).sum()) / denom
    sigma = float(np.sqrt(np.where(valid, (imputed - mu) ** 2, 0.0).sum() / denom))
    return valid & has_nb & (mean_d <= mu + std_thresh * sigma)


def _sor_gate(mean_d, has, valid, cell, std_thresh):
    """Global mu + thresh * sigma gate.  PCL's exact k-NN always finds k
    neighbors, so isolated points feed large distances into mu and sigma;
    the radius-bounded search imputes 10 cells for points with no
    neighbor, so the gate behaves the same, and drops them."""
    has_nb = has & valid
    cell = torch.tensor(cell, dtype=torch.float32, device=mean_d.device)
    imputed = torch.where(valid & ~has_nb, 10.0 * cell, mean_d)
    denom = torch.clamp_min(valid.sum(), 1).float()
    mu = torch.where(valid, imputed, 0.0).sum() / denom
    var = torch.where(valid, (imputed - mu) ** 2, 0.0).sum() / denom
    sigma = torch.sqrt(var)
    return valid & has_nb & (mean_d <= mu + float(std_thresh) * sigma)


def _count_fn(q, cand, cpts, d2, ok):
    return ok.sum(-1)


def radius_outlier_filter(
    points: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    min_neighbors: int = 50,
    per_cell: int = 16,
    chunk: Optional[int] = None,
    host_points: Optional[np.ndarray] = None,
    host_valid: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Drop points with fewer than ``min_neighbors`` within ``radius``."""
    pts_np = _host(points, np.float32) if host_points is None else host_points
    v_np = _host(valid, bool) if host_valid is None else host_valid
    origin, dims, cell = host_grid_geometry(pts_np, v_np, radius)
    grid = build_dense_grid(points, valid, origin, cell, dims, pad=per_cell)
    counts = neighbor_map_dense(grid, points, valid, radius, _count_fn, dims,
                                per_cell=per_cell, chunk=chunk, exclude_self=True)
    return valid & (counts >= min_neighbors)


def radius_outlier_filter_np(
    points: np.ndarray,
    valid: np.ndarray,
    radius: float,
    min_neighbors: int = 50,
) -> np.ndarray:
    """Host (exact) twin of `radius_outlier_filter` for the native
    backend: KD-tree neighbor counts."""
    from scipy.spatial import cKDTree
    out = np.zeros(len(points), bool)
    sel = np.flatnonzero(valid)
    if len(sel) == 0:
        return out
    pts = np.asarray(points, np.float64)[sel]
    tree = cKDTree(pts)
    counts = tree.query_ball_point(pts, r=float(radius), return_length=True,
                                   workers=-1)
    out[sel] = (counts - 1) >= min_neighbors  # exclude self
    return out
