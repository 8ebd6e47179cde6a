"""Production pair-sharded stereo (counterpart of
`reconstruction_tpu/parallel/production.py`).

The reference iterates camera pairs strictly sequentially
(`CStereoMatching.cpp:17`); SURVEY.md's parallelism table names the pair
axis as the primary scale-out target.  `match_pairs_sharded` gives the
same per-pair `PairResult`s as the sequential `stereo.pipeline.match_pair`
loop, so the orchestrator's cloud/surface/texture stages run unchanged
downstream (`pipeline.reconstruct.reconstruct(mesh=...)`).

  * Each rank runs its block of the pairs through `match_pair` itself,
    the sequential loop's path (K1, K3 and K2 on the card).
  * The pair count pads up to a multiple of the pair-axis size with
    repeats of pair 0 (`mesh.block_lanes`); a padded lane's result would
    be dropped, so it is not run.
  * The results move to the host and one `all_gather_object` over the
    pair axis hands every rank all the pairs' results, in input order.

The reference's int16 packing of the fetch (`fetch_packed`) is a
transfer format of its relay and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconstruction_tpu_torch.config import ReconstructionConfig
from reconstruction_tpu_torch.parallel.mesh import (
    all_gather_objects, axis_rank, axis_size, block_lanes, mesh_device)
from reconstruction_tpu_torch.stereo.pipeline import PairResult, match_pair
from reconstruction_tpu_torch.utils.timing import Timer


def move_result(obj, device):
    """``obj`` (a PairResult, or any tuple, named tuple or dataclass of
    tensors) with every tensor on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        moved = [move_result(v, device) for v in obj]
        return type(obj)(*moved) if hasattr(obj, "_fields") else tuple(moved)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: move_result(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def match_pairs_sharded(
    cfg: ReconstructionConfig,
    pairs: Sequence,
    mesh: DeviceMesh,
    timer: Optional[Timer] = None,
) -> List[PairResult]:
    """Run the per-pair stereo recipe for all pairs, split over the mesh's
    `pair` axis.

    ``pairs`` is a sequence of `pipeline.reconstruct.PairInput`, the same
    on every rank.  Returns one PairResult per input pair, in input order,
    on every rank, with its tensors on the host.  With a ``timer``, the
    rank's own pairs and the gather are its spans "local" and "gather"."""
    timer = timer or Timer()
    dev = mesh_device(mesh)
    lanes, real = block_lanes(len(pairs), axis_size(mesh, "pair"), axis_rank(mesh, "pair"))
    local = []
    with timer.span("local"):
        for i in (i for i, is_real in zip(lanes, real) if is_real):
            pin = pairs[i]
            res = match_pair(cfg, pin.image0, pin.image1, pin.mask0, pin.mask1,
                             pin.K0, pin.Rt0, pin.K1, pin.Rt1, device=dev)
            local.append(move_result(res, "cpu"))
    with timer.span("gather"):
        gathered = all_gather_objects(local, mesh.get_group("pair"),
                                      nbytes=_tensor_bytes(local))
    return [r for block in gathered for r in block]
