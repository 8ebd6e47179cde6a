"""Device mesh construction and the layer's collectives (counterpart of
`reconstruction_tpu/parallel/mesh.py`).

The scale-out axes (SURVEY.md section 2 "parallelism strategies"):

  frame — data parallelism over captures/frames (the reference's
          BatchProcess loop, `BatchProcess/main.cpp:74-75`),
  pair  — camera-pair parallelism (the reference processes pairs
          sequentially, `CStereoMatching.cpp:17`; here the primary
          scale-out axis),
  tile  — row/plane blocks inside one pair or grid with halo exchange.

A mesh is a `torch.distributed` `DeviceMesh` over the initialized world
(one rank a device) with those three named dimensions; an axis's process
group is `mesh.get_group(name)`.  Every rank holds the whole input of a
sharded function and works on its contiguous block of the leading axis
(`block_lanes`); results come back to every rank by `all_gather`.

The layer uses four collectives only: `all_reduce`, list-form
`all_gather`, `broadcast` and `all_gather_object` (host objects).  gloo
takes CUDA tensors for the first three and NCCL takes all of them, so the
same code runs on NCCL (one rank a card), on gloo on the CPU, and on
several gloo ranks sharing one card.  Each collective here adds one call
and its bytes to `COMM`; none of them synchronizes the device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_axes() -> Tuple[str, str, str]:
    return ("frame", "pair", "tile")


def make_mesh(frame: int = 1, pair=None, tile: int = 1, device="cuda") -> DeviceMesh:
    """A (frame, pair, tile) mesh over the initialized world
    (`parallel/multihost.initialize_distributed`).  With pair=None, all
    remaining ranks go to the pair axis.  ``device``: "cuda" (this rank's
    card) or "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.initialize_distributed first")
    n = dist.get_world_size()
    if pair is None:
        if n % (frame * tile):
            raise ValueError(f"make_mesh: {n} ranks do not split into "
                             f"frame={frame} x tile={tile}")
        pair = n // (frame * tile)
    if frame * pair * tile != n:
        raise ValueError(f"make_mesh: frame {frame} x pair {pair} x tile {tile} "
                         f"!= {n} ranks")
    return init_device_mesh(torch.device(device).type, (frame, pair, tile),
                            mesh_dim_names=mesh_axes())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (its rank in the axis's group)."""
    return mesh.get_local_rank(axis)


def block_lanes(n: int, size: int, rank: int) -> Tuple[List[int], List[bool]]:
    """The lanes of ``rank``'s contiguous block when a leading axis of ``n``
    items is split over ``size`` ranks: the count is padded up to a multiple
    of ``size`` with repeats of item 0 (the reference's padding rule,
    `parallel/production.py`), so every rank has ceil(n / size) lanes.
    Returns each lane's item index and whether it is a real item."""
    per = -(-n // size)
    lanes = range(rank * per, (rank + 1) * per)
    return [i if i < n else 0 for i in lanes], [i < n for i in lanes]


class CommCounter:
    """Calls and bytes sent of this process's collectives."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.calls, self.bytes = 0, 0

    def as_dict(self) -> dict:
        return dict(calls=self.calls, bytes=self.bytes)


COMM = CommCounter()


def _counted(op, nbytes: int):
    COMM.calls += 1
    COMM.bytes += nbytes
    return op()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every group member's ``t`` (same shape and dtype everywhere), in
    group-rank order."""
    t = t.contiguous()
    if t.dtype == torch.bool:     # gathered as bytes on every backend
        return [o.bool() for o in all_gather_list(t.to(torch.uint8), group)]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _counted(lambda: dist.all_gather(out, t, group=group), _nbytes(t))
    return out


def all_gather_blocks(local: torch.Tensor, group, n: int) -> torch.Tensor:
    """The members' equal blocks of a leading axis, concatenated in group
    order and cut to the ``n`` real items (`block_lanes`'s padding)."""
    return torch.cat(all_gather_list(local, group))[:n]


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over the group; returns ``t``."""
    _counted(lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group), _nbytes(t))
    return t


def broadcast_objects(objs: list) -> list:
    """Rank 0's picklable host ``objs``, on every rank of the world."""
    _counted(lambda: dist.broadcast_object_list(objs, src=0), 0)
    return objs


def all_gather_objects(obj, group, nbytes: int = 0) -> list:
    """Every member's picklable host object, in group-rank order (``nbytes``:
    its tensors' size, for `COMM`).  Tensors in it must be on the CPU: a
    pickled CUDA tensor unpickles onto the sender's device index."""
    out = [None] * dist.get_world_size(group)
    _counted(lambda: dist.all_gather_object(out, obj, group=group), nbytes)
    return out


def halo_rows(own: torch.Tensor, k: int, group, fill: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The halo exchange of a block split along its leading axis: the last
    ``k`` entries of the previous member's block and the first ``k`` of the
    next's (``own`` needs at least ``k``), by one `all_gather` of every
    member's two edges, so it holds for any group size on any backend.  The
    first member's upper halo and the last's lower one are ``fill``."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    edges = all_gather_list(torch.stack([own[:k], own[-k:]]), group)
    up = edges[rank - 1][1] if rank > 0 else torch.full_like(own[:k], fill)
    dn = edges[rank + 1][0] if rank < size - 1 else torch.full_like(own[:k], fill)
    return up, dn
