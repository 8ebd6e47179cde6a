"""Cross-view point dedup (counterpart of `reconstruction_tpu/cloud/dedup.py`;
the reference's optional `isdelete` path, `CCloudOptimization.cpp:152-346`).

Each fused point goes to its best-facing pair (largest normal-to-view
cosine, `:160-176`) and projects into that pair's reference camera; the
points that land in one pixel bucket are resolved by the reference
package's rules: the nearest candidate is kept, and a farther one only
where its facing differs from the candidate before it, up to ``cap``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class DedupInputs(NamedTuple):
    """Per-pair projection context, tensors on one device."""

    P0: torch.Tensor       # (num_pairs, 3, 4) world -> cam0 pixels (scaled)
    P1: torch.Tensor       # (num_pairs, 3, 4) world -> cam1 pixels
    centers: torch.Tensor  # (num_pairs, 3) pair cam0 centers
    masks0: torch.Tensor   # (num_pairs, H, W) validity of the cam0 grids


def cross_view_dedup(points: torch.Tensor, normals: torch.Tensor,
                     valid: torch.Tensor, ctx: DedupInputs,
                     cap: int = 4) -> torch.Tensor:
    """The updated validity mask."""
    N = points.shape[0]
    npair, H, W = ctx.masks0.shape
    dev = points.device
    ar = torch.arange(N, device=dev)

    # Best-facing pair per point (`:160-176`).
    dirs = ctx.centers[:, None, :] - points[None, :, :]          # (P, N, 3)
    dn = torch.sqrt((dirs * dirs).sum(-1))
    score = (normals[None] * dirs).sum(-1) / torch.clamp_min(dn, 1e-9)
    pair = score.argmax(0)

    # Project into the pair's cam0.
    Ph = ctx.P0[pair]                                            # (N, 3, 4)
    pr = (Ph[..., :3] * points[:, None, :]).sum(-1) + Ph[..., 3]
    z = pr[:, 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    u = torch.round(pr[:, 0] / zs).to(torch.int64)
    v = torch.round(pr[:, 1] / zs).to(torch.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0) & valid
    uc, vc = u.clamp(0, W - 1), v.clamp(0, H - 1)
    inb = inb & (ctx.masks0[pair, vc, uc] > 0.5)

    # Bucket key per point; invalid points share a dead bucket.
    dead = npair * H * W
    key = torch.where(inb, (pair * H + vc) * W + uc, dead)

    # Candidates of a bucket near to far: sort by distance, then stably by
    # key (numpy's lexsort((dist, key))).
    dist = dn[pair, ar]
    by_dist = torch.argsort(dist, stable=True)
    order = by_dist[torch.argsort(key[by_dist], stable=True)]
    k_sorted = key[order]
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    seg_start = torch.cummax(torch.where(first, ar, 0), 0).values
    rank = ar - seg_start                                        # 0 = nearest

    # Facing toward the camera (`:273-281`); a farther candidate is kept
    # where its facing differs from the one before it.
    facing = (score[pair, ar] > 0)[order]
    prev_facing = torch.cat([facing[:1], facing[:-1]])
    keep_sorted = (rank == 0) | ((facing != prev_facing) & (rank < cap))
    keep_sorted = keep_sorted & (k_sorted < dead)

    keep = torch.zeros(N, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted
    return keep & valid


def build_dedup_inputs(pair_results: Sequence, masks0: Sequence, device) -> DedupInputs:
    """Projection context from the pairs' rectification results and their
    eroded rectified cam0 masks ([0, 255], kept above 200)."""
    def t(rows):
        return torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in rows]),
                               device=device)

    rects = [r.rectification for r in pair_results]
    m = torch.stack([torch.as_tensor(mm, device=device).float() for mm in masks0])
    # T_final is the cam0 world center (`CStereoMatching.cpp:133`).
    return DedupInputs(P0=t(r.P1_world for r in rects), P1=t(r.P2_world for r in rects),
                       centers=t(r.T_final for r in rects),
                       masks0=(m > 200).float())
