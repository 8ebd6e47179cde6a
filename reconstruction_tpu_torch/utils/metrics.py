"""Geometry fidelity metrics (counterpart of `reconstruction_tpu/utils/metrics.py`).

BASELINE.md's fidelity criterion is point-to-mesh RMSE against a
reference PLY.  `point_to_mesh_distance` computes exact point-to-triangle
distances (Ericson's region tests) in point x triangle chunks on the
device, keeping the running minimum there and reading it back once.
"""

from __future__ import annotations

import numpy as np
import torch


def _point_tri_dist2(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """Squared distance point->triangle (Ericson's method), batched.

    p: (N, 1, 3); a, b, c: (1, M, 3) -> (N, M).
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(den):
        return torch.where(den == 0, torch.ones_like(den), den)

    # region tests
    denom_abc = va + vb + vc
    nz = denom_abc != 0
    v = torch.where(nz, vb / safe(denom_abc), torch.zeros_like(vb))
    w = torch.where(nz, vc / safe(denom_abc), torch.zeros_like(vc))
    proj_face = a + v[..., None] * ab + w[..., None] * ac

    t_ab = torch.clamp(d1 / safe(d1 - d3), 0, 1)
    proj_ab = a + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / safe(d2 - d6), 0, 1)
    proj_ac = a + t_ac[..., None] * ac
    t_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0, 1)
    proj_bc = b + t_bc[..., None] * (c - b)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (~in_b) & (~in_c) & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    proj = proj_face
    proj = torch.where(on_bc[..., None], proj_bc, proj)
    proj = torch.where(on_ac[..., None], proj_ac, proj)
    proj = torch.where(on_ab[..., None], proj_ab, proj)
    proj = torch.where(in_c[..., None], c.expand_as(proj), proj)
    proj = torch.where(in_b[..., None], b.expand_as(proj), proj)
    proj = torch.where(in_a[..., None], a.expand_as(proj), proj)
    return ((p - proj) ** 2).sum(-1)


def point_to_mesh_distance(
    points: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    point_chunk: int = 512,
    tri_chunk: int = 4096,
    *,
    device="cuda",
) -> np.ndarray:
    """Exact distance from each point to the mesh surface (host arrays in
    and out, the work on ``device``)."""
    dev = torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    tri = torch.as_tensor(np.asarray(verts, np.float32)[np.asarray(faces)], device=dev)
    best = torch.full((len(pts),), float("inf"), dtype=torch.float32, device=dev)
    for i0 in range(0, len(pts), point_chunk):
        p = pts[i0:i0 + point_chunk][:, None, :]
        m = best[i0:i0 + point_chunk]
        for j0 in range(0, len(tri), tri_chunk):
            t = tri[j0:j0 + tri_chunk]
            d2 = _point_tri_dist2(p, t[None, :, 0], t[None, :, 1], t[None, :, 2])
            m = torch.minimum(m, d2.min(dim=1).values)
        best[i0:i0 + point_chunk] = m
    return torch.sqrt(best).cpu().numpy()


def point_to_mesh_rmse(points, verts, faces, **kw) -> float:
    d = point_to_mesh_distance(points, verts, faces, **kw)
    return float(np.sqrt(np.mean(d ** 2)))


def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 2048, *,
                     device="cuda") -> float:
    """Symmetric mean nearest-neighbor distance between two clouds."""
    dev = torch.device(device)

    def one_way(x, y):
        out = np.zeros(len(x), np.float32)
        yj = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        for i0 in range(0, len(x), chunk):
            xx = torch.as_tensor(np.asarray(x[i0:i0 + chunk], np.float32), device=dev)
            d2 = ((xx[:, None] - yj[None]) ** 2).sum(-1)
            out[i0:i0 + chunk] = torch.sqrt(d2.min(dim=1).values).cpu().numpy()
        return out.mean()
    return float(0.5 * (one_way(a, b) + one_way(b, a)))
