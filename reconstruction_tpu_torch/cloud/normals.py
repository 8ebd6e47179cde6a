"""Normal estimation via neighborhood covariance (counterpart of
`reconstruction_tpu/cloud/normals.py`).

Replaces PCL `NormalEstimationOMP(radius)` and the manual camera-facing
flip (`CCloudOptimization.cpp:101-121`).  The 3x3 eigenproblem is solved
in closed form (Smith's trigonometric method), batched and branch-free.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.cloud.neighbors import (
    build_dense_grid, host_grid_geometry, neighbor_map_dense)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Cofactor determinant of (..., 3, 3) matrices (an LU per 3x3 block
    would cost far more at millions of blocks)."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))


def smallest_eigenvector_3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpair of symmetric (..., 3, 3) matrices: trigonometric
    closed form, then the most independent cross product of the rows of
    A - lambda I.  Returns (eigenvalue (...,), unit eigenvector (..., 3))."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    r = torch.clamp(_det3(B) / (2.0 * p ** 3 + 1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # eigenvalues q + 2p cos(phi + 2k pi/3); the smallest at k = 1
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam = torch.where(p2 < 1e-20, q, lam)

    C = A - lam[..., None, None] * eye
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    cs = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], -2)
    best = (cs * cs).sum(-1).argmax(-1)
    v = torch.take_along_dim(cs, best[..., None, None], dim=-2)[..., 0, :]
    nv = torch.sqrt((v * v).sum(-1, keepdim=True))
    z = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    v = torch.where(nv > 1e-20, v / torch.clamp_min(nv, 1e-30), z.expand_as(v))
    return lam, v


def covariance(d: torch.Tensor) -> torch.Tensor:
    """sum_k d[n, k, i] d[n, k, j] as (n, 3, 3), one reduction per entry
    (no matrix-multiply unit, so no reduced-precision path)."""
    e = {}
    for i in range(3):
        for j in range(i, 3):
            e[i, j] = e[j, i] = (d[..., i] * d[..., j]).sum(-1)
    return torch.stack([torch.stack([e[i, j] for j in range(3)], -1)
                        for i in range(3)], -2)


def _cov_stat(q, cand, cpts, d2, ok):
    """Neighborhood covariance, reduced in the candidate stream."""
    w = ok.float()
    cnt = torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
    mean = (cpts * w[..., None]).sum(-2) / cnt
    d = torch.where(ok[..., None], cpts - mean[:, None, :], 0.0)
    return covariance(d) / cnt[..., None]


def estimate_normals(
    points: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    viewpoint,
    per_cell: int = 8,
    chunk: Optional[int] = None,
    host_points: Optional[np.ndarray] = None,
    host_valid: Optional[np.ndarray] = None,
    backend: str = "auto",
):
    """Covariance normals within ``radius``, flipped toward ``viewpoint``
    (the pair's camera center, `CCloudOptimization.cpp:117-120`).

    host_points / host_valid: host copies for the grid geometry (saves a
    read-back); host_valid may be a superset of ``valid``.  The "native"
    backend runs the C++ exact-radius path on the host and returns a
    numpy array; "torch" returns a tensor on the points' device."""
    from reconstruction_tpu_torch.cloud.backend import resolve_backend
    radius = float(radius)
    if resolve_backend(backend) == "native":
        from reconstruction_tpu_torch import native
        pts_np = _host(points, np.float32) if host_points is None else host_points
        return native.cloud_normals(pts_np, _host(valid, bool), radius,
                                    _host(viewpoint, np.float32))
    origin, dims, cell = host_grid_geometry(
        _host(points, np.float32) if host_points is None else host_points,
        _host(valid, bool) if host_valid is None else host_valid, radius)
    grid = build_dense_grid(points, valid, origin, cell, dims, pad=per_cell)
    cov = neighbor_map_dense(grid, points, valid, radius, _cov_stat, dims,
                             per_cell=per_cell, chunk=chunk)
    return _normals_epilogue(cov, points.float(), _on(viewpoint, points.device))


def _normals_epilogue(cov, points, viewpoint):
    _, normals = smallest_eigenvector_3x3(cov)
    to_cam = viewpoint[None, :] - points
    flip = (normals * to_cam).sum(-1) < 0
    return torch.where(flip[:, None], -normals, normals)


def _on(x, device) -> torch.Tensor:
    """float32 tensor on ``device`` of a tensor or array (arrays copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _host(x, dtype) -> np.ndarray:
    """numpy copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype, copy=False)
