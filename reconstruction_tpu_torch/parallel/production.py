"""Production pair-sharded stereo (counterpart of
`reconstruction_tpu/parallel/production.py`).

The reference iterates camera pairs strictly sequentially
(`CStereoMatching.cpp:17`); SURVEY.md's parallelism table names the pair
axis as the primary scale-out target.  `match_pairs_sharded` gives the
same per-pair `PairResult`s as the sequential `stereo.pipeline.match_pair`
loop, so the orchestrator's cloud/surface/texture stages run unchanged
downstream (`pipeline.reconstruct.reconstruct(mesh=...)`).

  * Each rank runs its block of the pairs through `match_pair` itself,
    the sequential loop's path (K1-K8 on the card).
  * The pair count pads up to a multiple of the pair-axis size with
    repeats of pair 0 (`mesh.block_lanes`); a padded lane's result would
    be dropped, so it is not run.
  * `gather_results` hands every rank all the pairs' results, in input
    order, on its own device: one `all_gather_objects` of the host values
    and of each tensor's place, shape and dtype (where the ranks meet),
    then one `all_gather_list` of a flat byte buffer a rank holding its
    results' tensors, padded with zeros to the largest rank's.  Nothing
    is pickled but the host values, so on NCCL the tensors go card to
    card.

The reference's int16 packing of the fetch (`fetch_packed`) is a
transfer format of its relay and is not ported.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from reconstruction_tpu_torch.config import ReconstructionConfig
from reconstruction_tpu_torch.parallel.mesh import (
    all_gather_list, all_gather_objects, axis_rank, axis_size, block_lanes, mesh_device)
from reconstruction_tpu_torch.stereo.pipeline import PairResult, match_pair
from reconstruction_tpu_torch.utils.timing import Timer, span

# A tensor's offset in its rank's byte buffer is a multiple of this, so a
# view of it as any dtype is aligned.
_ALIGN = 16


class _Leaf(NamedTuple):
    """A tensor's place in a result sent by `gather_results`: its index
    in the sender's layout."""

    index: int


def _is_leaf(obj) -> bool:
    return isinstance(obj, _Leaf)


def _map_leaves(obj, is_leaf, fn):
    """``obj`` with each part for which ``is_leaf`` holds replaced by
    ``fn(part)``, through tuples, named tuples, lists and dataclasses."""
    if is_leaf(obj):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        parts = [_map_leaves(v, is_leaf, fn) for v in obj]
        return type(obj)(*parts) if hasattr(obj, "_fields") else type(obj)(parts)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(getattr(obj, f.name), is_leaf, fn)
            for f in dataclasses.fields(obj)})
    return obj


def gather_results(local: list, group, device, timer: Optional[Timer] = None) -> list:
    """Every group member's ``local`` results (PairResults, or any
    tuples, lists and dataclasses of tensors and picklable host values),
    concatenated in group-rank order, on every member.

    One `all_gather_objects` ("gather_meta") sends each member's results
    with their tensors taken out, and each tensor's offset, size, shape
    and dtype in the member's byte buffer.  The members meet there, so the
    wait for the slowest lands in it.  One `all_gather_list`
    ("gather_tensors") then sends the buffers, each padded with zeros to
    the largest; a received tensor is a view of its sender's buffer on
    ``device``, bit-equal to what the sender held.  A member's own
    results come back as the objects it passed in."""
    timer = timer or Timer(device)
    tensors: list = []

    def take(t: torch.Tensor) -> _Leaf:
        tensors.append(t)
        return _Leaf(len(tensors) - 1)

    skeletons = [_map_leaves(r, torch.is_tensor, take) for r in local]
    layout, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        layout.append((size, nbytes, tuple(t.shape), t.dtype))
        size += -(-nbytes // _ALIGN) * _ALIGN
    meta = (skeletons, layout, size)
    with timer.span("gather_meta"):
        metas = all_gather_objects(meta, group, nbytes=len(pickle.dumps(meta)))
    width, bufs = max(m[2] for m in metas), None
    with timer.span("gather_tensors"):
        if width:
            buf = torch.zeros(width, dtype=torch.uint8, device=device)
            for t, (offset, nbytes, _, _) in zip(tensors, layout):
                buf[offset:offset + nbytes] = t.contiguous().reshape(-1).view(torch.uint8)
            bufs = all_gather_list(buf, group)
    me = dist.get_rank(group)
    out = []
    for member, (skels, lay, _) in enumerate(metas):
        if member == me:
            out.extend(local)
            continue
        received = [bufs[member][offset:offset + nbytes].view(dtype).reshape(shape)
                    for offset, nbytes, shape, dtype in lay]
        out.extend(_map_leaves(s, _is_leaf, lambda leaf, got=received: got[leaf.index])
                   for s in skels)
    return out


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
    on every rank, with its tensors on the rank's device, bit-equal to
    what the rank that ran the pair computed (`gather_results`).  The call
    is the span "match_pairs_sharded"; the rank's own pairs are the
    ``timer``'s span "local" and the gather its span "gather", holding
    "gather_meta" and "gather_tensors" (`Timer` spans, synchronized at
    both ends on a CUDA device)."""
    dev = mesh_device(mesh)
    timer = timer or Timer(dev)
    lanes, real = block_lanes(len(pairs), axis_size(mesh, "pair"), axis_rank(mesh, "pair"))
    with span("match_pairs_sharded"):
        local = []
        with timer.span("local"):
            for i in (i for i, is_real in zip(lanes, real) if is_real):
                pin = pairs[i]
                local.append(match_pair(cfg, pin.image0, pin.image1, pin.mask0, pin.mask1,
                                        pin.K0, pin.Rt0, pin.K1, pin.Rt1, device=dev))
        with timer.span("gather"):
            return gather_results(local, mesh.get_group("pair"), dev, timer)
