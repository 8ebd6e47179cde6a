"""Moving least squares smoothing (counterpart of
`reconstruction_tpu/cloud/mls.py`).

Replaces PCL `MovingLeastSquaresOMP(radius, polynomial order 1)`
(`CCloudOptimization.cpp:350-364`): per point a Gaussian-weighted plane
fit over the radius neighborhood; the point projects onto the plane, and
the plane normal, re-oriented against the earlier normals (`:369-386`),
is the output normal.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from reconstruction_tpu_torch.cloud.neighbors import (
    build_dense_grid, host_grid_geometry, neighbor_map_dense)
from reconstruction_tpu_torch.cloud.normals import (
    _host, _on, covariance, smallest_eigenvector_3x3)


@lru_cache(None)
def _plane_stat(r: float):
    r2 = float(np.float32(r * r))

    def fn(q, cand, cpts, d2, ok):
        """Weighted plane-fit moments, reduced in the candidate stream."""
        # Gaussian weights exp(-d^2 / r^2) (PCL sqr_gauss_param = r^2).
        w = torch.where(ok, torch.exp(-d2 / r2), 0.0)
        wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1e-20)
        mean = (cpts * w[..., None]).sum(-2) / wsum
        d = (cpts - mean[:, None, :]) * torch.sqrt(w)[..., None]
        return mean, covariance(d) / wsum[..., None], ok.any(-1)

    return fn


def mls_smooth(
    points: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    prev_normals,
    per_cell: int = 8,
    chunk: Optional[int] = None,
    host_points: Optional[np.ndarray] = None,
    host_valid: Optional[np.ndarray] = None,
    backend: str = "auto",
):
    """Returns (smoothed points, normals, valid): tensors on the points'
    device ("torch") or numpy arrays ("native").  Points with no neighbor
    in ``radius`` are dropped, as PCL's MLS gives no sample for them."""
    from reconstruction_tpu_torch.cloud.backend import resolve_backend
    radius = float(radius)
    if resolve_backend(backend) == "native":
        from reconstruction_tpu_torch import native
        pts_np = _host(points, np.float32) if host_points is None else host_points
        return native.cloud_mls(pts_np, _host(valid, bool), radius,
                                _host(prev_normals, np.float32))
    origin, dims, cell = host_grid_geometry(
        _host(points, np.float32) if host_points is None else host_points,
        _host(valid, bool) if host_valid is None else host_valid, radius)
    grid = build_dense_grid(points, valid, origin, cell, dims, pad=per_cell)
    mean, cov, any_ok = neighbor_map_dense(grid, points, valid, radius,
                                           _plane_stat(radius), dims,
                                           per_cell=per_cell, chunk=chunk)
    return _mls_epilogue(points.float(), valid, mean, cov, any_ok,
                         _on(prev_normals, points.device))


def _mls_epilogue(points, valid, mean, cov, any_ok, prev_normals):
    """Eigen, plane projection and re-orientation."""
    _, n = smallest_eigenvector_3x3(cov)
    dist = ((points - mean) * n).sum(-1, keepdim=True)
    proj = points - dist * n
    flip = (n * prev_normals).sum(-1) < 0
    n = torch.where(flip[:, None], -n, n)
    ok = valid & any_ok
    return torch.where(ok[:, None], proj, points), n, ok
