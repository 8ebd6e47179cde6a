"""Closed loop, one client: the stereo stage of one take split over the
ranks of one host, `parallel/production.match_pairs_sharded` on all the
configuration's pairs, each rank's block of them on its own device, then
every result gathered to every rank.

The run's own process is rank 0 on the first device.  Set-up starts ranks
1 to n-1 as processes of this file, rank r on device r, and joins them all
through `parallel/multihost.initialize_distributed` on a free localhost
port, with the configuration's `backend` and the traffic's `timeout_s`.
Each rank is pinned to a block of whole cores of its own (`cpu_blocks`),
on its device's NUMA node where the host says which, and runs as many
torch threads as its block has CPUs: four ranks that share a host's cores
otherwise meet on them, and the slowest rank sets each request's time.
Every rank renders the seeded take (the same bits on every rank, as
`scene.make_take` gives them), builds the configuration's `mesh` and
serves the warm-up requests.

A request: rank 0 broadcasts its index, then every rank runs
`match_pairs_sharded`.  It ends when rank 0's call returns and its device
is synchronized.  Its record holds the backend, rank 0's `Timer` seconds ("local",
"gather", "gather_meta", "gather_tensors"; None where the program has no
such span) and the calls and bytes of rank 0's collectives in the call
(`mesh.COMM`).

The comparison takes the traffic's `check_requests` finished requests
drawn from the seed (each worker mirrors the harness's `Reservoir`, which
depends only on the seed and the count, and keeps its own results of the
request drawn):
  gather_mismatch_pairs  the request's pairs whose results on rank 0
                         differ in any bit (every tensor, host value and
                         shape) from those on the rank that computed them:
                         each owner digests its own copies, rank 0 what it
                         received;
and then, with the workers stopped, `compare.pair_numbers` of one pair
drawn from the seed among those of the other ranks, so that it came to
rank 0 by the gather, against the plain reference.

A worker that exits ends the run at once with a non-zero code (rank 0
watches them); a worker ends when rank 0's process is gone (it watches its
parent); a rank that stops answering fails its collectives after the
process group's timeout.  A request that raises ends the run too: the
ranks' collectives would no longer match.
"""

from __future__ import annotations

import atexit
import dataclasses
import glob
import hashlib
import inspect
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import links

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SPANS = ("local", "gather", "gather_meta", "gather_tensors")

# A worker's first lines: take rank 0's import path, load this file by its
# path and run `worker` with the spec.
_BOOT = ("import importlib.util, pickle, sys\n"
         "f = open(sys.argv[1], 'rb')\n"
         "sys.path[:0] = pickle.load(f)\n"
         "s = importlib.util.spec_from_file_location('portbench_sharded_worker', sys.argv[2])\n"
         "m = sys.modules[s.name] = importlib.util.module_from_spec(s)\n"
         "s.loader.exec_module(m)\n"
         "m.worker(pickle.load(f), int(sys.argv[3]))\n")


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class State:
    pairs: list
    mesh: object
    device: torch.device
    program_cfg: object
    procs: List[subprocess.Popen] = field(default_factory=list)
    stopping: threading.Event = field(default_factory=threading.Event)
    check_pair: int = 0
    refs: Dict[int, object] = field(default_factory=dict)


def mesh_shape(config: dict) -> Dict[str, int]:
    m = config["mesh"]
    return {"frame": int(m["frame"]), "pair": int(m["pair"]), "tile": int(m["tile"])}


def world_size(config: dict) -> int:
    m = mesh_shape(config)
    return m["frame"] * m["pair"] * m["tile"]


def digest(obj) -> str:
    """A digest of every bit of ``obj``: each tensor's dtype, shape and
    bytes, each array's, and every other value's repr, in field order."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(f"tensor {o.dtype} {tuple(o.shape)};".encode())
            h.update(o.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
        elif isinstance(o, np.ndarray):
            h.update(f"array {o.dtype} {o.shape};".encode())
            h.update(np.ascontiguousarray(o).view(np.uint8))
        elif isinstance(o, (tuple, list)):
            h.update(f"{type(o).__name__} {len(o)};".encode())
            for v in o:
                walk(v)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            h.update(f"{type(o).__name__};".encode())
            for f in dataclasses.fields(o):
                h.update(f"{f.name}=".encode())
                walk(getattr(o, f.name))
        else:
            h.update(f"{o!r};".encode())

    walk(obj)
    return h.hexdigest()


def host_cores(cpus) -> List[List[int]]:
    """``cpus`` grouped by physical core, the siblings of one core
    together, ordered by NUMA node, package and core as sysfs gives them
    (a CPU it says nothing of is a core of its own)."""
    def read(path, default):
        try:
            with open(path) as f:
                return int(f.read().split()[0])
        except (OSError, ValueError, IndexError):
            return default

    cores: Dict[tuple, List[int]] = {}
    for c in sorted(cpus):
        base = f"/sys/devices/system/cpu/cpu{c}"
        nodes = glob.glob(f"{base}/node[0-9]*")
        node = int(nodes[0].rsplit("node", 1)[1]) if nodes else 0
        key = (node, read(f"{base}/topology/physical_package_id", 0),
               read(f"{base}/topology/core_id", -1 - c))
        cores.setdefault(key, []).append(c)
    return [cores[k] for k in sorted(cores)]


def device_node(index: int) -> int:
    """The NUMA node of CUDA device ``index`` from sysfs; -1 where unknown."""
    try:
        p = torch.cuda.get_device_properties(index)
        path = (f"/sys/bus/pci/devices/{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
                f"{p.pci_device_id:02x}.0/numa_node")
        with open(path) as f:
            return int(f.read())
    except (AttributeError, OSError, ValueError, RuntimeError, AssertionError):
        return -1


def cpu_blocks(cores: List[List[int]], nodes: List[int]) -> Optional[List[List[int]]]:
    """Rank r's CPUs: ``len(cores) // len(nodes)`` whole cores of
    ``cores`` (as `host_cores` orders them), handed out in the order of the
    ranks' NUMA nodes ``nodes``, so that a rank's cores lie on its device's
    node where the counts allow; None where there are fewer cores than
    ranks."""
    per = len(cores) // len(nodes)
    if per == 0:
        return None
    blocks: List[List[int]] = [[] for _ in nodes]
    for k, r in enumerate(sorted(range(len(nodes)), key=lambda r: nodes[r])):
        blocks[r] = [c for core in cores[k * per:(k + 1) * per] for c in core]
    return blocks


def _pin(cpus: Optional[List[int]]) -> None:
    """Pin every thread of this process to ``cpus``; the threads it starts
    later inherit them."""
    if not cpus:
        return
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:         # a thread that ended meanwhile
            pass


def _join_world(config: dict, traffic: dict, port: int, rank: int, device_type: str):
    """Join the run's process group as ``rank``; returns (device, mesh)."""
    from reconstruction_tpu_torch.parallel.mesh import make_mesh
    from reconstruction_tpu_torch.parallel.multihost import initialize_distributed
    # A program whose initialize_distributed takes no timeout keeps torch's.
    kw = ({"timeout": float(traffic["timeout_s"])}
          if "timeout" in inspect.signature(initialize_distributed).parameters else {})
    dev = initialize_distributed(coordinator_address=f"localhost:{port}",
                                 num_processes=world_size(config), process_id=rank,
                                 device=device_type, backend=config.get("backend"), **kw)
    return dev, make_mesh(**mesh_shape(config), device=device_type)


def _render(config: dict, seed: int, finest_size, device) -> list:
    from portbench import scene
    params = scene.draw_params(np.random.default_rng(seed), config["rig"]["num_cameras"])
    return scene.make_take(config["rig"], finest_size, config["cam_pairs"], params, device)


def _finest_size(config: dict):
    w, h = config["lowest_level_size"]
    s = 1 << (int(config["pyramid_levels"]) - 1)
    return (w * s, h * s)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _match(state: State):
    """One request's call on this rank: (results, Timer spans, COMM calls
    and bytes of the call)."""
    from reconstruction_tpu_torch.parallel.mesh import COMM
    from reconstruction_tpu_torch.parallel.production import match_pairs_sharded
    from reconstruction_tpu_torch.utils.timing import Timer
    timer = Timer(state.device)
    calls, nbytes = COMM.calls, COMM.bytes
    rs = match_pairs_sharded(state.program_cfg, state.pairs, state.mesh, timer=timer)
    _sync(state.device)
    return rs, dict(timer.spans), (COMM.calls - calls, COMM.bytes - nbytes)


def _send(msg) -> None:
    from reconstruction_tpu_torch.parallel.mesh import broadcast_objects
    broadcast_objects([msg])


def _gather_digests(mine: Dict[int, str]) -> List[Dict[int, str]]:
    import torch.distributed as dist
    from reconstruction_tpu_torch.parallel.mesh import all_gather_objects
    return all_gather_objects(mine, dist.group.WORLD)


# ---------------------------------------------------------------- workers


def _watch_parent(ppid: int) -> None:
    while os.getppid() == ppid:
        time.sleep(0.5)
    os._exit(1)


def worker(spec: dict, rank: int) -> None:
    """Rank ``rank`` (1 or more) of the run: serve rank 0's requests until
    it says stop."""
    import torch.distributed as dist
    from portbench.run import Reservoir
    from reconstruction_tpu_torch.parallel.mesh import broadcast_objects

    cpus = spec["cpus"][rank] if spec["cpus"] else None
    _pin(cpus)
    threading.Thread(target=_watch_parent, args=(spec["ppid"],), daemon=True).start()
    torch.set_num_threads(len(cpus) if cpus else spec["threads"])
    config, traffic = spec["config"], spec["traffic"]
    dev, mesh = _join_world(config, traffic, spec["port"], rank, spec["device_type"])
    state = State(pairs=_render(config, spec["seed"], _finest_size(config), dev), mesh=mesh,
                  device=dev, program_cfg=spec["program_cfg"])
    own = links.owned_pairs(config, mesh.get_local_rank("pair"))
    keep = Reservoir(int(traffic["check_requests"]), spec["seed"])
    while True:
        msg = broadcast_objects([None])[0]
        if msg[0] == "serve":
            rs, _, _ = _match(state)
            if msg[1] >= 0:
                keep.offer(msg[1], {pi: rs[pi] for pi in own})
            del rs
        elif msg[0] == "digest":
            kept = dict(keep.items).get(msg[1], {})
            _gather_digests({pi: digest(r) for pi, r in kept.items()})
        else:
            break
    dist.destroy_process_group()


# ---------------------------------------------------------------- rank 0


def _stop_workers(state: State, wait_s: float = 60.0) -> None:
    state.stopping.set()
    deadline = time.monotonic() + wait_s
    for p in state.procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
    for p in state.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _watch_workers(state: State) -> None:
    while not state.stopping.is_set():
        for r, p in enumerate(state.procs, 1):
            if p.poll() is not None and not state.stopping.is_set():
                _log(f"rank {r} exited with {p.returncode}; the run ends")
                state.stopping.set()
                for q in state.procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(1)
        time.sleep(0.2)


def _fail(state: State, what: str, exc: BaseException):
    _log(f"{what} failed: {type(exc).__name__}: {exc}; the run ends")
    _stop_workers(state, wait_s=0.0)
    raise SystemExit(1)


def setup(ctx) -> State:
    cfg, traffic = ctx.config, ctx.traffic
    from reconstruction_tpu_torch.parallel.multihost import free_port
    world = world_size(cfg)
    threads = max(1, len(os.sched_getaffinity(0)) // world)
    nodes = [device_node(r) if ctx.device.type == "cuda" else -1 for r in range(world)]
    blocks = cpu_blocks(host_cores(os.sched_getaffinity(0)), nodes)
    spec = dict(config=cfg, traffic=traffic, seed=ctx.seed, program_cfg=ctx.program_cfg,
                port=free_port(), device_type=ctx.device.type, threads=threads,
                cpus=blocks, ppid=os.getpid())
    tmp = tempfile.mkdtemp(prefix="portbench_sharded_")
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump([ROOT] + [p for p in sys.path if p], f)
        pickle.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    procs = [subprocess.Popen([sys.executable, "-c", _BOOT, spec_path, os.path.abspath(__file__),
                               str(r)], env=dict(env, LOCAL_RANK=str(r)))
             for r in range(1, world)]
    _log(f"ranks 1-{world - 1} started: pids {[p.pid for p in procs]}; CPUs a rank {blocks} "
         f"(devices' NUMA nodes {nodes}); backend {cfg.get('backend')}, "
         f"timeout {traffic['timeout_s']} s")
    state = State(pairs=[], mesh=None, device=ctx.device, program_cfg=ctx.program_cfg,
                  procs=procs)
    atexit.register(_stop_workers, state, 0.0)
    _pin(blocks[0] if blocks else None)
    threading.Thread(target=_watch_workers, args=(state,), daemon=True).start()
    torch.set_num_threads(len(blocks[0]) if blocks else threads)
    try:
        dev, state.mesh = _join_world(cfg, traffic, spec["port"], 0, ctx.device.type)
        state.device = dev
        state.pairs = _render(cfg, ctx.seed, ctx.finest_size, dev)
        others = [i for i in range(len(cfg["cam_pairs"])) if i not in links.owned_pairs(cfg, 0)]
        rng = np.random.default_rng([ctx.seed, 0x5a1d])
        state.check_pair = int(rng.choice(others)) if others else 0
        for _ in range(int(traffic.get("warmup_requests", 1))):
            _send(("serve", -1))
            _match(state)
    except Exception as exc:  # a failed set-up ends the run, and the workers with it
        _fail(state, "set-up", exc)
    return state


def serve(ctx, state: State, i: int):
    """Request ``i``: (its record, what the comparison keeps of it)."""
    try:
        _send(("serve", i))
        rs, spans, (calls, nbytes) = _match(state)
    except Exception as exc:
        _fail(state, f"request {i}", exc)
    import torch.distributed as dist
    n = len(state.pairs)
    rec = {"pairs": n, "views": 2 * n, "backend": dist.get_backend(), "comm_calls": calls,
           "comm_bytes": nbytes}
    rec.update({f"{name}_s": spans.get(name) for name in SPANS})
    return rec, rs


def check(ctx, state: State, kept: list) -> Dict[str, float]:
    from portbench import compare
    from portbench.reference.stereo.pipeline import match_pair as ref_match
    mismatch = 0
    own = links.owned_pairs(ctx.config, 0)
    try:
        for i, rs in kept:
            _send(("digest", i))
            held = [digest(r) for r in rs]
            owners: Dict[int, str] = {}
            for block in _gather_digests({pi: held[pi] for pi in own}):
                owners.update(block)
            mismatch += sum(owners.get(pi) != d for pi, d in enumerate(held))
        state.stopping.set()        # the workers' exits from here on are the run's end
        _send(("stop",))
    except Exception as exc:
        _fail(state, "the digests", exc)
    import torch.distributed as dist
    dist.destroy_process_group()
    _stop_workers(state)
    rows = []
    pi = state.check_pair
    for _, rs in kept:
        if pi not in state.refs:
            p = state.pairs[pi]
            state.refs[pi] = ref_match(ctx.reference_cfg, p.image0, p.image1, p.mask0, p.mask1,
                                       p.K0, p.Rt0, p.K1, p.Rt1, device=ctx.device)
        rows.append(compare.pair_numbers(rs[pi].disparity, rs[pi].cloud, state.refs[pi]))
    out = compare.worst(rows)
    out["gather_mismatch_pairs"] = float(mismatch)
    return out
