"""What each rank runs in the multi-process tests of the port's
multi-device layer (tests/test_torch_parallel*.py).

`parallel/launch.run_local` imports this module in every rank, so it
imports torch and the port only; the tests hand the ranks numpy inputs
and compare what comes back (numpy) with the port's single-device
functions and with the JAX package in the pytest process.  Every rank
runs 2 intra-op threads, as the pytest process does
(`tests/torch_parity.py`), so that CPU reductions split the same way on
both sides.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem
from reconstruction_tpu_torch.parallel.distributed_ba import ba_step_sharded
from reconstruction_tpu_torch.parallel.fusion import all_gather_clouds, distributed_splat
from reconstruction_tpu_torch.parallel.mesh import (
    all_reduce_sum, axis_rank, axis_size, block_lanes, make_mesh)
from reconstruction_tpu_torch.parallel.multihost import make_pod_mesh
from reconstruction_tpu_torch.parallel.poisson_sharded import poisson_vcycle_sharded
from reconstruction_tpu_torch.parallel.sharded import match_level_pairs_sharded, refine_tiled
from reconstruction_tpu_torch.stereo.margins import find_margin
from reconstruction_tpu_torch.stereo.triangulate import PointCloud

THREADS = 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def core(inp: dict) -> dict:
    """Every sharded function of the layer but the production path, on
    the CPU: pair-sharded stereo (scene8), the tile-sharded refine, the
    cloud gather, a BA step, the splat and the z-sharded multigrid."""
    torch.set_num_threads(THREADS)
    n = dist.get_world_size()
    out = {"rank": dist.get_rank()}

    pmesh = make_mesh(frame=1, pair=n, tile=1, device="cpu")
    i0, i1, mk = (_t(inp["scene8"][k]) for k in ("imgs0", "imgs1", "masks"))
    st = match_level_pairs_sharded(pmesh, i0, i1, mk, mk, None, 0, refine_iters=4)
    out["pairs"] = dict(disp0=_np(st.disp0), disp1=_np(st.disp1),
                        drift0=_np(st.refine_drift0))

    tmesh = make_mesh(frame=1, pair=1, tile=n, device="cpu")
    r = inp["refine"]
    m = find_margin(_t(r["valid"]), 2)
    out["refine"] = {it: _np(refine_tiled(tmesh, _t(r["disp"]), _t(r["imgL"]), _t(r["imgR"]),
                                          m, iterations=it, s_cap=32, band=8))
                     for it in r["iterations"]}

    c = inp["clouds"]
    rank = axis_rank(pmesh, "pair")
    per = c["xyz"].shape[0] // n
    mine = slice(rank * per, (rank + 1) * per)
    g = all_gather_clouds(pmesh, PointCloud(_t(c["xyz"][mine]), _t(c["colors"][mine]),
                                            _t(c["valid"][mine])))
    out["clouds"] = dict(xyz=_np(g.xyz), colors=_np(g.colors), valid=_np(g.valid))

    b = inp["ba"]
    prob = BAProblem(*[_t(b[k]) for k in BAProblem._fields])
    p2, x2, c2 = ba_step_sharded(pmesh, prob, torch.zeros((b["C"], 6)), prob.points0, b["C"])
    out["ba"] = dict(poses=_np(p2), points=_np(x2), cost=float(c2))

    s = inp["splat"]
    V, D = distributed_splat(pmesh, _t(s["pts"][mine]), _t(s["nrm"][mine]),
                             _t(s["valid"][mine]), torch.zeros(3), torch.tensor(1.0),
                             s["R"])
    out["splat"] = dict(V=_np(V), D=_np(D))

    v = inp["vcycle"]
    out["vcycle"] = _np(poisson_vcycle_sharded(tmesh, _t(v["f"]), _t(v["screen"]),
                                               levels=v["levels"], cycles=v["cycles"],
                                               pre=v["pre"], post=v["post"]))
    out["lanes"] = block_lanes(3, axis_size(pmesh, "pair"), rank)
    return out


def frames(takes: dict) -> dict:
    """The multi-host layout with one rank a "host": the pod mesh's frame
    axis spans the hosts, a sum over the whole world, and each host's
    frame matched by itself and gathered over the frame axis."""
    torch.set_num_threads(THREADS)
    os.environ["LOCAL_WORLD_SIZE"] = "1"      # one rank on each host
    n = dist.get_world_size()
    mesh = make_pod_mesh(device="cpu")
    rows = [sorted(mesh.mesh[f].flatten().tolist()) for f in range(mesh.mesh.shape[0])]
    total = all_reduce_sum(torch.ones(()), dist.group.WORLD)
    st = match_level_pairs_sharded(mesh, _t(takes["imgL"]), _t(takes["imgR"]),
                                   _t(takes["mask"]), _t(takes["mask"]), None, 0,
                                   axis="frame", radius=2, offset=2, ws=0.03, refine_iters=3)
    return dict(shape=tuple(mesh.mesh.shape), frame_rows=rows, world=n,
                total=float(total), disp0=_np(st.disp0))


def production(cfg3, pairs3, cfg2, pairs2) -> dict:
    """`match_pairs_sharded` over the pair axis (every rank a pair rank),
    then `reconstruct(mesh=...)`, on the CPU."""
    from reconstruction_tpu_torch.parallel.production import match_pairs_sharded
    from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct

    torch.set_num_threads(THREADS)
    mesh = make_mesh(frame=1, tile=1, device="cpu")
    rs = match_pairs_sharded(cfg3, pairs3, mesh)
    results = [dict(disparity=_np(r.disparity), xyz=_np(r.cloud.xyz),
                    colors=_np(r.cloud.colors), valid=_np(r.cloud.valid),
                    rect0=_np(r.rect_images[0]), rect1=_np(r.rect_images[1]),
                    mask0=_np(r.rect_masks[0]), em0=_np(r.rect_masks_eroded[0]),
                    drift=_np(r.refine_drift),
                    margins0=[int(v) for v in r.margins0],
                    margins1=[int(v) for v in r.margins1])
               for r in rs]
    rec = reconstruct(cfg2, pairs2, mesh=mesh, device="cpu")
    return dict(pairs=results, vertices=rec.vertices, faces=rec.faces, colors=rec.colors,
                spans=sorted(rec.timer.spans), stats=rec.stats.records)


def default_device_error(cfg, pairs) -> str:
    """The error `reconstruct(mesh=...)` raises on a CPU mesh when its
    device is left at the default (the card)."""
    from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct

    mesh = make_mesh(frame=1, tile=1, device="cpu")
    try:
        reconstruct(cfg, pairs, mesh=mesh)
    except ValueError as e:
        return str(e)
    return ""


def rank_and_world() -> tuple:
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass
class Odd:
    """A result whose shapes differ by rank and by item, for
    `gather_results`: tensors of five dtypes, a 0-d one and an empty one,
    nested in a tuple and a list, beside host values."""

    a: torch.Tensor
    b: tuple
    c: torch.Tensor
    d: torch.Tensor
    e: list
    host: dict


def odd_result(rank: int, i: int) -> Odd:
    g = torch.Generator().manual_seed(100 * rank + i)
    return Odd(a=torch.randn((rank + 1, i + 2), generator=g),
               b=(torch.rand((i + 1,), generator=g) < 0.5,
                  torch.randint(0, 256, (3, rank + 1), generator=g, dtype=torch.uint8)),
               c=torch.tensor(7 * rank + i, dtype=torch.int32),
               d=torch.zeros((0, rank), dtype=torch.float64),
               e=[0.5 * i, torch.arange(rank + i + 1, dtype=torch.int64)],
               host={"rank": rank, "i": i})


def tensors_of(obj) -> list:
    """Every tensor in a result, in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in tensors_of(v)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in tensors_of(getattr(obj, f.name))]
    return []


def arrays_of(obj):
    """A result as nested host values: each tensor a numpy array."""
    if isinstance(obj, torch.Tensor):
        return _np(obj)
    if isinstance(obj, (tuple, list)):
        return [arrays_of(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: arrays_of(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def gather(cfg, pairs) -> dict:
    """`match_pairs_sharded` over the pair axis of the whole world, then
    again on no pair under a CPU profiler session (its spans), then
    `gather_results` of `Odd` results (rank r sends r + 1 of them), with
    the calls and bytes `COMM` counted for the first call and the last."""
    from reconstruction_tpu_torch.parallel.mesh import COMM, mesh_device
    from reconstruction_tpu_torch.parallel.production import gather_results, match_pairs_sharded
    from reconstruction_tpu_torch.utils.timing import Timer, span_mark, span_records

    torch.set_num_threads(THREADS)
    mesh = make_mesh(frame=1, tile=1, device="cpu")
    dev = mesh_device(mesh)
    rank = dist.get_rank()
    timer = Timer(dev)
    COMM.reset()
    rs = match_pairs_sharded(cfg, pairs, mesh, timer=timer)
    out = dict(rank=rank, device=str(dev), pairs=[arrays_of(r) for r in rs],
               devices=sorted({str(t.device) for r in rs for t in tensors_of(r)}),
               timer=sorted(timer.spans), comm=COMM.as_dict())
    mark = span_mark()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        match_pairs_sharded(cfg, pairs[:0], mesh)
    out["spans"] = sorted({(s.name, s.parent) for s in span_records(mark)}, key=str)
    COMM.reset()
    got = gather_results([odd_result(rank, i) for i in range(rank + 1)],
                         mesh.get_group("pair"), dev)
    out.update(odd=[arrays_of(r) for r in got], odd_types=[type(r).__name__ for r in got],
               odd_devices=sorted({str(t.device) for r in got for t in tensors_of(r)}),
               odd_comm=COMM.as_dict())
    return out
