"""Run a function on a world of local processes, one rank each.

`run_local(fn, world, device, *args)` starts ``world`` Python processes
on this host, joins them into one process group on a free localhost port
(`parallel/multihost.initialize_distributed`: gloo on the CPU, NCCL or
gloo on the card), calls ``fn(*args)`` in each and returns the results
by rank.  It raises when a rank fails or the world outlives ``timeout``,
and stops every process it started either way.

``fn`` must be importable by name (a module-level function of a module
on ``sys.path``; a child imports that module and nothing else of the
caller's), and its arguments and result picklable host data.  Each child
starts from a fresh interpreter, so importing this module starts nothing.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional

# The child's first lines: take the caller's import path (pickled ahead of
# the spec, whose arguments may need it to unpickle), then run _child.
_BOOT = ("import pickle, sys\n"
         "f = open(sys.argv[1], 'rb')\n"
         "sys.path[:0] = pickle.load(f)\n"
         "spec = pickle.load(f)\n"
         "from reconstruction_tpu_torch.parallel.launch import _child\n"
         "_child(spec, int(sys.argv[2]), sys.argv[3])\n")


def _child(spec: dict, rank: int, out_path: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    from reconstruction_tpu_torch.parallel.multihost import initialize_distributed

    torch.set_num_threads(spec["threads"])
    initialize_distributed(device=spec["device"], backend=spec["backend"])
    fn = importlib.import_module(spec["module"])
    for part in spec["name"].split("."):
        fn = getattr(fn, part)
    try:
        result = fn(*spec["args"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


class _PortTaken(RuntimeError):
    """Rank 0 found the world's port taken between its choice and its bind."""


def run_local(fn: Callable, world: int, device="cuda", *args,
              backend: Optional[str] = None, timeout: float = 900.0) -> List[Any]:
    """``fn(*args)`` on ranks 0..world-1 of a new local world; returns the
    results in rank order.  ``device``: "cuda" (rank r on cuda:(r % device
    count)) or "cpu"; ``backend``: None for the device's own (gloo,
    NCCL), or "gloo" for several ranks on one card.  A world whose free
    port was taken before rank 0 bound it starts again on another, up to
    three times."""
    module = fn.__module__
    if module == "__main__":
        raise ValueError("run_local: fn must live in an importable module, "
                         "not in __main__")
    with tempfile.TemporaryDirectory(prefix="rtt_world_") as tmp:
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump([p for p in sys.path if p], f)
            pickle.dump(dict(module=module, name=fn.__qualname__, args=args, device=str(device),
                             backend=backend,
                             threads=max(1, (os.cpu_count() or 1) // (2 * world))), f)
        for attempt in range(3):
            try:
                return _run_world(spec_path, world, os.path.join(tmp, str(attempt)), timeout)
            except _PortTaken:
                if attempt == 2:
                    raise


def _run_world(spec_path: str, world: int, tmp: str, timeout: float) -> List[Any]:
    from reconstruction_tpu_torch.parallel.multihost import free_port

    os.makedirs(tmp)
    env = {k: v for k, v in os.environ.items() if k not in (
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    procs, logs, outs = [], [], []

    def failed(r: int) -> Exception:
        text = _tail(logs[r])
        if "EADDRINUSE" in text:
            return _PortTaken(text)
        return RuntimeError(f"run_local: rank {r} of {world} exited with "
                            f"{procs[r].returncode}:\n{text}")

    try:
        for r in range(world):
            logs.append(os.path.join(tmp, f"rank{r}.log"))
            outs.append(os.path.join(tmp, f"rank{r}.pkl"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _BOOT, spec_path, str(r), outs[-1]],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise failed(r)
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_local: the world of {world} ran past "
                                   f"{timeout:.0f} s; rank 0's log:\n" + _tail(logs[0]))
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0 or not os.path.exists(outs[r]):
                raise failed(r)
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
