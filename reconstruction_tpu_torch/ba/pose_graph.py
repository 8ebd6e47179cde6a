"""Temporal pose-graph optimization for video sequences (counterpart of
`reconstruction_tpu/ba/pose_graph.py`).

Nodes are per-frame rig poses, edges relative SE(3) measurements
(odometry and loop closures).  Gauss-Newton on r_ij = Log(Z_ij^-1 T_i^-1 T_j)
with left perturbations T_i <- Exp(xi_i) T_i, Jacobians by forward-mode
autodiff (`torch.func.jacfwd`).  Every function here works over leading
batch dims, so the edges are one batch rather than a vmap.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """xi = (omega, tau) (..., 6) -> (..., 4, 4) transform.

    Autodiff-safe at xi = 0 (Gauss-Newton linearizes there): smooth sinc
    coefficients of the unnormalized skew matrix, no ||omega|| division."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2 + 1e-12)
    Wx = _skew(w)
    WW = Wx @ Wx
    A = torch.sin(th) / th
    B = (1 - torch.cos(th)) / (th2 + 1e-12)
    C = (1 - A) / (th2 + 1e-12)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A * Wx + B * WW
    V = eye + B * Wx + C * WW
    top = torch.cat([R, V @ v[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                                   device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def _log_so3(R: torch.Tensor) -> torch.Tensor:
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7)
    th = torch.arccos(c)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    return w * (th / (2 * torch.sin(th) + 1e-12))[..., None]


def _residual(Ti, Tj, Zij):
    """6-vector error of edge (i, j), over leading batch dims."""
    E = torch.linalg.inv(Zij) @ torch.linalg.inv(Ti) @ Tj
    return torch.cat([_log_so3(E[..., :3, :3]), E[..., :3, 3]], dim=-1)


class PoseGraph(NamedTuple):
    """edges: (E, 2) int32 node indices; Z: (E, 4, 4) measurements."""

    edges: torch.Tensor
    Z: torch.Tensor
    num_nodes: int


def pose_graph_optimize(
    edges: torch.Tensor,
    Z: torch.Tensor,
    T_init: torch.Tensor,
    num_nodes: int,
    iterations: int = 20,
    damping: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton over all node poses, node 0 pinned.

    Returns (T (N, 4, 4), costs (iterations,), each before its update)."""
    N = num_nodes
    i_idx, j_idx = edges[:, 0].long(), edges[:, 1].long()

    def total(xi_all):
        Ti = _exp_se3(xi_all[i_idx]) @ T_init[i_idx]
        Tj = _exp_se3(xi_all[j_idx]) @ T_init[j_idx]
        return _residual(Ti, Tj, Z).reshape(-1)

    dev, dt = T_init.device, T_init.dtype
    xi = torch.zeros((N, 6), dtype=dt, device=dev)
    mask = torch.arange(N * 6, device=dev) >= 6
    costs = []
    for _ in range(iterations):
        r = total(xi)
        J = jacfwd(total)(xi).reshape(r.shape[0], N * 6)
        H = J.T @ J + damping * torch.eye(N * 6, dtype=dt, device=dev)
        g = -J.T @ r
        H = torch.where(mask[:, None] & mask[None, :], H, torch.zeros_like(H))
        H = H + torch.diag((~mask).to(dt))
        g = torch.where(mask, g, torch.zeros_like(g))
        xi = xi + torch.linalg.solve(H, g).reshape(N, 6)
        costs.append(0.5 * torch.sum(r ** 2))
    return _exp_se3(xi) @ T_init, torch.stack(costs)
