"""The stereo core over the device mesh (counterpart of
`reconstruction_tpu/parallel/sharded.py`).

Two sharding strategies (SURVEY.md section 2 "parallelism strategies"):

  * pair-sharding: the reference iterates camera pairs sequentially
    (`CStereoMatching.cpp:17`); here each rank runs its block of the
    pairs through the same per-level function (K1, K3 and K2 on the
    card), and the results come back to every rank by one `all_gather`.

  * tile-sharding with halo exchange: the refinement sweep couples +-1
    rows per sweep (`CStereoMatching.cpp:597-599`).  Each row-block shard
    refines a slab of its rows plus T halo rows on each side, T sweeps a
    K2 launch (`ops/refine.SWEEPS_PER_LAUNCH`): a Jacobi sweep's error at
    the slab's cut edge moves inward one row a sweep, so after T sweeps
    the shard's own rows are exact, and the shards trade their T edge
    rows once every T sweeps instead of one row every sweep.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops.refine import (
    SWEEPS_PER_LAUNCH, refine_sweeps_fused, window_anchors)
from reconstruction_tpu_torch.parallel.mesh import (
    all_gather_blocks, axis_rank, axis_size, block_lanes, halo_rows)
from reconstruction_tpu_torch.stereo.margins import Margins, inner_box
from reconstruction_tpu_torch.stereo.pipeline import LevelState, match_one_level
from reconstruction_tpu_torch.stereo.refine import _band_ranges, band_volume


def match_level_pairs_sharded(
    mesh: DeviceMesh,
    imgs0: torch.Tensor,
    imgs1: torch.Tensor,
    masks0: torch.Tensor,
    masks1: torch.Tensor,
    coarse: Optional[LevelState],
    level: int,
    axis: str = "pair",
    **kw,
) -> LevelState:
    """All camera pairs of one level, split over the mesh's ``axis``.

    Args: imgs* (Npair, H, W, C), masks* (Npair, H, W) and the coarse
    state's (Npair, H/2, W/2) disparities, the same on every rank; the
    leading axis is split over ``axis`` (default `pair`; a video batch
    passes `frame` to split frames, the DP analogue of
    `BatchProcess/main.cpp:74-75`'s sequential per-take loop), padded with
    repeats of pair 0.  Each rank runs its pairs through
    `stereo/pipeline.match_one_level` (``kw`` are its options) one after
    the other.  Returns the (Npair, ...) state on every rank."""
    n = imgs0.shape[0]
    group = mesh.get_group(axis)
    lanes, _ = block_lanes(n, axis_size(mesh, axis), axis_rank(mesh, axis))
    outs = []
    for i in lanes:
        cs = None if coarse is None else LevelState(disp0=coarse.disp0[i],
                                                    disp1=coarse.disp1[i])
        outs.append(match_one_level(imgs0[i], imgs1[i], masks0[i], masks1[i],
                                    cs, level, **kw))
    fields = [torch.stack([getattr(o, f) for o in outs]) for f in LevelState._fields]
    return LevelState(*[all_gather_blocks(t, group, n) for t in fields])


def refine_tiled(
    mesh: DeviceMesh,
    disp: torch.Tensor,
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    m: Margins,
    iterations: int,
    ws: float = 0.03,
    s_cap: int = 64,
    band: int = 16,
) -> torch.Tensor:
    """Row-block-sharded subpixel refinement over the `tile` axis: equal,
    bit for bit, to `stereo/refine.disparity_refine(disp, imgL, imgR, m,
    iterations, ws, s_cap, band, recenter_every=0)` (K2's taps come from
    the 32-slot window of the first extraction, as that call's do).

    Every rank holds the full inputs and returns the full (H, W) result.
    The slot window of every row is the unsharded one: the per-band
    ranges come from the full disparity and the unsharded band height,
    and each rank builds (K3) only the rows of its slab, from its rows of
    the images with one context row on each side."""
    H, W = disp.shape
    n_tile = axis_size(mesh, "tile")
    if H % n_tile:
        raise ValueError(f"refine_tiled: {H} rows do not split over {n_tile} tiles")
    group = mesh.get_group("tile")
    rows = H // n_tile
    r0 = axis_rank(mesh, "tile") * rows
    r1 = r0 + rows
    k = min(SWEEPS_PER_LAUNCH, rows)     # halo rows = sweeps between exchanges
    s0, s1 = max(r0 - k, 0), min(r1 + k, H)
    c0, c1 = max(s0 - 1, 0), min(s1 + 1, H)

    disp = disp.float()
    band = min(band, H)
    base_b, lo_b, hi_b = _band_ranges(disp, s_cap, band, drift=16)
    per_row = [t.repeat_interleave(band)[:H][c0:c1].clone() for t in (base_b, lo_b, hi_b)]
    ctx = torch.ones(c1 - c0, dtype=torch.bool, device=disp.device)
    ctx[s0 - c0:s1 - c0] = False      # context rows: no shift filled, dropped below
    per_row[1][ctx] = 0
    per_row[2][ctx] = -1
    cv = band_volume(imgL[c0:c1], imgR[c0:c1], *per_row, s_cap, 1)[s0 - c0:s1 - c0]
    base = per_row[0][s0 - c0:s1 - c0]
    inner = inner_box(m, H, W, inset=1)[s0:s1].contiguous()
    j0, jref = window_anchors(disp[s0:s1], base)

    own = disp[r0:r1].contiguous()
    done = 0
    while done < iterations:
        up, dn = halo_rows(own, k, group, float(NOMATCH))
        slab = torch.cat([up[k - (r0 - s0):], own, dn[:s1 - r1]])
        n = min(k, iterations - done)
        own = refine_sweeps_fused(slab, cv, j0, jref, inner, ws, n)[r0 - s0:r1 - s0]
        own = own.contiguous()
        done += n
    return all_gather_blocks(own, group, H)
