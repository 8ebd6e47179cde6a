"""Distributed bundle adjustment: point-sharded Schur reduction
(counterpart of `reconstruction_tpu/parallel/distributed_ba.py`).

The north-star distributed-BA recipe (BASELINE.json): points (and their
observations, grouped per point) split over the ranks; every rank
assembles its partial reduced camera system (`ba_blocks`, with the
coupling kernel K4 on the card); one `all_reduce` sums S, b and the cost;
the small 6C x 6C solve runs on every rank; the point back-substitution
is rank-local.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconstruction_tpu_torch.ba.bundle_adjust import (
    BAProblem, ba_blocks, camera_step, point_step)
from reconstruction_tpu_torch.parallel.mesh import (
    all_gather_blocks, all_reduce_sum, axis_rank, axis_size, block_lanes)


def ba_step_sharded(
    mesh: DeviceMesh,
    problem: BAProblem,
    poses: torch.Tensor,
    points: torch.Tensor,
    num_cameras: int,
    damping: float = 1e-3,
    huber_delta: float = 2.0,
    fix_gauge: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GN step (`ba/bundle_adjust.ba_step`) with the point axis split
    over the mesh's `pair` axis (the generic data axis for BA).

    Every rank holds the whole problem; a rank's padded lanes (repeats of
    point 0) carry no valid observation, so they add nothing.  Returns
    (poses', points', cost), the same on every rank."""
    C = num_cameras
    M = problem.points0.shape[0]
    group = mesh.get_group("pair")
    lanes, real = block_lanes(M, axis_size(mesh, "pair"), axis_rank(mesh, "pair"))
    idx = torch.tensor(lanes, device=points.device)
    real = torch.tensor(real, device=points.device)
    shard = BAProblem(K=problem.K, Rt0=problem.Rt0, points0=problem.points0[idx],
                      obs_uv=problem.obs_uv[idx], obs_cam=problem.obs_cam[idx],
                      obs_ok=problem.obs_ok[idx] & real[:, None])
    S, b, hpp, b_p, W_t, cost = ba_blocks(shard, poses, points[idx], C, huber_delta)
    n = S.numel()
    red = all_reduce_sum(torch.cat([S.reshape(-1), b, cost.reshape(1)]), group)
    S, b, cost = red[:n].reshape(S.shape), red[n:-1], red[-1]
    dc = camera_step(S, b, C, damping, fix_gauge)
    local = points[idx] + point_step(W_t, hpp, b_p, dc)
    return poses + dc, all_gather_blocks(local, group, M), cost
