"""Distributed cloud fusion (counterpart of
`reconstruction_tpu/parallel/fusion.py`).

The reference fuses per-pair clouds by accumulating into one global PCL
cloud in-process (`CCloudOptimization.cpp:123`, `*cloud_normals +=
*cloud_normal`).  Pair-sharded execution fuses with collectives:

  * `all_gather_clouds`: each rank's padded clouds -> the global cloud on
    every rank (one `all_gather` a field),
  * `distributed_splat`: point-sharded Poisson splatting and one
    `all_reduce` sum of the grid over the pair axis — the depth-fusion
    collective of BASELINE.json's dome config ("partitioned camera pairs
    + distributed depth fusion").
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconstruction_tpu_torch.parallel.mesh import all_gather_list, all_reduce_sum
from reconstruction_tpu_torch.stereo.triangulate import PointCloud
from reconstruction_tpu_torch.surface.poisson import _splat3


def all_gather_clouds(mesh: DeviceMesh, cloud: PointCloud) -> PointCloud:
    """Gather the ranks' padded clouds into the global cloud.

    Args: this rank's block of the pairs, fields with leading axis
    (pairs_per_rank, N, ...), the same shape on every rank.  Returns the
    flattened (num_pairs * N, ...) cloud, pairs in rank order, on every
    rank."""
    group = mesh.get_group("pair")
    return PointCloud(*[torch.cat(all_gather_list(f, group)).flatten(0, 1)
                        for f in cloud])


def distributed_splat(
    mesh: DeviceMesh,
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    origin: torch.Tensor,
    spacing: torch.Tensor,
    resolution: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-sharded Poisson splatting: each rank splats its points (any
    leading shape, (..., 3)) into a local (R, R, R, 4) grid of normal field
    and density (`surface/poisson._splat3`, as `poisson_reconstruct` does)
    and one `all_reduce` over the pair axis sums the grids.  Returns the
    global normal field (R, R, R, 3) and density (R, R, R) on every rank."""
    R = resolution
    w = valid.reshape(-1).float()
    keep = w != 0       # a point of weight 0 adds exact zeros: leave it out
    w = w[keep]
    gp = (points.reshape(-1, 3)[keep].float() - origin) / spacing
    vals = torch.cat([normals.reshape(-1, 3)[keep].float(), torch.ones_like(w)[:, None]], 1)
    grid = _splat3(torch.zeros((R, R, R, 4), device=gp.device), gp, w, vals)
    grid = all_reduce_sum(grid, mesh.get_group("pair"))
    return grid[..., :3], grid[..., 3]
