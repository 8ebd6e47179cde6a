"""Z-block-sharded screened-Poisson multigrid (counterpart of
`reconstruction_tpu/parallel/poisson_sharded.py`).

The single-device solver (`surface/poisson.py`) is spectral — one global
FFT, which is undesirable across devices.  For distributed operation the
multigrid V-cycle runs with the grid split along the leading z axis over
the mesh `tile` axis; every 7-point stencil application trades one
boundary PLANE with each z-neighbour (`mesh.halo_rows`, one `all_gather`
of every block's two edge planes).  Restriction is halo-free
(full-weighting averages 2x2x2 children, never crossing a block boundary
when the local extent is even); prolongation needs the +-1 coarse plane,
one halo exchange a level.

The sums run in the dense solver's order (`surface/poisson._jacobi`,
`_laplacian`), so one rank's solve equals the dense `_vcycle` bit for bit.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconstruction_tpu_torch.parallel.mesh import (
    all_gather_blocks, axis_rank, axis_size, halo_rows)
from reconstruction_tpu_torch.surface.poisson import _interleave, _shift3

_AXIS = "tile"


def _halo_z(x: torch.Tensor, group) -> torch.Tensor:
    """The block with one plane of halo on each z side; the outer blocks
    receive zeros (the dense solver's `_shift3` zero-pads the boundary)."""
    up, dn = halo_rows(x, 1, group, 0.0)
    return torch.cat([up, x, dn])


def _neighbor_sum(x: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours, z from the halo'd block ``xh``."""
    nb = xh[2:] + xh[:-2]
    for ax in (1, 2):
        nb = nb + _shift3(x, ax, 1) + _shift3(x, ax, -1)
    return nb


def _jacobi_sharded(x, f, screen, n_iter: int, group):
    omega = 2.0 / 3.0
    diag = -6.0 - screen
    for _ in range(n_iter):
        x_new = (f - _neighbor_sum(x, _halo_z(x, group))) / diag
        x = x + omega * (x_new - x)
    return x


def _laplacian_sharded(x, group):
    xh = _halo_z(x, group)
    out = -6.0 * x + xh[2:] + xh[:-2]
    for ax in (1, 2):
        out = out + _shift3(x, ax, 1) + _shift3(x, ax, -1)
    return out


def _restrict_local(x):
    """Full-weighting 2x restriction — purely within 2^3 blocks, so no
    halo is needed as long as the local z extent is even."""
    Z, Y, X = x.shape
    return x.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2).mean(dim=(1, 3, 5))


def _prolong_sharded(x, group):
    """Cell-centered trilinear prolongation; the z axis needs the +-1
    COARSE plane of the neighbouring blocks (one halo exchange)."""
    xh = _halo_z(x, group)
    lo = 0.75 * x + 0.25 * xh[:-2]       # fine 2i   <- 0.75 c_i + 0.25 c_{i-1}
    hi = 0.75 * x + 0.25 * xh[2:]        # fine 2i+1 <- 0.75 c_i + 0.25 c_{i+1}
    x = _interleave(lo, hi, 0)
    for ax in (1, 2):
        lo = 0.75 * x + 0.25 * _shift3(x, ax, -1)
        hi = 0.75 * x + 0.25 * _shift3(x, ax, 1)
        x = _interleave(lo, hi, ax)
    return x


def _vcycle_sharded(x, f, screen, levels: int, pre: int, post: int, group):
    # The local z extent must stay >= 2 and even through `levels`
    # coarsenings; the caller's grid guarantees it.
    if levels == 0 or x.shape[0] <= 2:
        return _jacobi_sharded(x, f, screen, 40, group)
    x = _jacobi_sharded(x, f, screen, pre, group)
    r = f - (_laplacian_sharded(x, group) - screen * x)
    r2 = _restrict_local(r) * 4.0
    e2 = torch.zeros_like(r2)
    e2 = _vcycle_sharded(e2, r2, _restrict_local(screen) * 4.0,
                         levels - 1, pre, post, group)
    x = x + _prolong_sharded(e2, group)
    return _jacobi_sharded(x, f, screen, post, group)


def poisson_vcycle_sharded(
    mesh: DeviceMesh,
    f: torch.Tensor,
    screen: torch.Tensor,
    levels: int = 3,
    cycles: int = 8,
    pre: int = 2,
    post: int = 2,
) -> torch.Tensor:
    """Solve (Delta - screen) chi = f with the grid z-split over `tile`:
    ``cycles`` V-cycles from chi = 0, as `cycles` calls of the dense
    `surface/poisson._vcycle`.

    Args: f, screen (R, R, R) on every rank, R divisible by tile * 2^levels.
    Returns chi (R, R, R) on every rank."""
    n_tile = axis_size(mesh, _AXIS)
    R = f.shape[0]
    if R % (n_tile * (1 << levels)):
        raise ValueError(f"poisson_vcycle_sharded: R={R} is not a multiple of "
                         f"tile {n_tile} x 2^{levels}")
    group = mesh.get_group(_AXIS)
    z = R // n_tile
    z0 = axis_rank(mesh, _AXIS) * z
    f_blk, s_blk = f[z0:z0 + z], screen[z0:z0 + z]
    x = torch.zeros_like(f_blk)
    for _ in range(cycles):
        x = _vcycle_sharded(x, f_blk, s_blk, levels, pre, post, group)
    return all_gather_blocks(x, group, R)
