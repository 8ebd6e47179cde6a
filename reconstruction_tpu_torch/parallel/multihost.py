"""Process-group initialization and the pod mesh layout (counterpart of
`reconstruction_tpu/parallel/multihost.py`).

The reference is single-process (files as IPC, SURVEY.md section 5); the
port runs one process a device on `torch.distributed`.  Axis layout rule:
the `frame` axis maps across hosts (frames are independent, traffic is
zero until final artifact collection), `pair` and `tile` stay within a
host (halo exchange and cloud fusion collectives).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from reconstruction_tpu_torch.parallel.mesh import make_mesh
from reconstruction_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> torch.device:
    """Join the process group and bind this rank's device; returns it.

    The address is the argument, else the reference's COORDINATOR_ADDRESS
    (host:port) with NUM_PROCESSES and PROCESS_ID, else torchrun's
    MASTER_ADDR/MASTER_PORT with WORLD_SIZE and RANK (``env://``); with
    none of them, a world of one on a free localhost port.  The backend is
    NCCL for "cuda" and gloo for "cpu" unless given: gloo on "cuda" runs
    several ranks on one card.  Rank r takes cuda:(LOCAL_RANK % device
    count); NCCL refuses two ranks on one card, so this raises first.
    ``timeout``: seconds a collective or the join may wait for the other
    ranks before it fails (torch's default if None).  A process that
    already joined keeps its group."""
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address:
        world = num_processes or int(os.environ["NUM_PROCESSES"])
        rank = process_id if process_id is not None else int(os.environ["PROCESS_ID"])
        init = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = "env://"
    else:
        world, rank = 1, 0
        init = f"tcp://localhost:{free_port()}"
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("initialize_distributed: no CUDA device; pass device='cpu'")
        if backend == "nccl" and local_rank >= count:
            raise ValueError(
                f"initialize_distributed: local rank {local_rank} would share "
                f"cuda:{local_rank % count} with local rank {local_rank % count}, "
                f"and NCCL refuses two ranks on one GPU; run at most {count} "
                "ranks a host, or pass backend='gloo'")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(dev_type)
    if dist.is_initialized():
        return dev
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **extra)
    log.info("distributed: rank %d/%d on %s (%s)", rank, world, dev, backend)
    return dev


def factor_pod(
    n_devices: int,
    n_local: int,
    frames_per_pod: Optional[int] = None,
) -> tuple:
    """(frame, pair, tile) factoring of n_devices.

    Invariants (tests/test_parallel.py::test_factor_pod_*):
      * frame * pair * tile == n_devices always (no dropped devices);
      * the frame axis defaults to the host count and is clamped DOWN to
        the largest divisor of n_devices <= the request, so uneven
        requests degrade instead of asserting;
      * frame == n_hosts keeps every frame row process-aligned (the DCN
        axis) when hosts are homogeneous — per-host device counts on TPU
        pods are uniform, and the multihost test asserts the alignment.
    """
    n = max(n_devices, 1)
    n_hosts = max(n // max(n_local, 1), 1)
    frame = max(min(frames_per_pod or n_hosts, n), 1)
    while n % frame:
        frame -= 1  # largest feasible divisor <= the request
    per_frame = n // frame
    tile = 2 if per_frame % 2 == 0 and per_frame > 1 else 1
    pair = per_frame // tile
    return frame, pair, tile


def _local_ranks() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun sets it), else the
    ranks whose host name is this rank's."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names.count(socket.gethostname())


def make_pod_mesh(frames_per_pod: Optional[int] = None, device="cuda"):
    """Mesh over all ranks: the frame axis spans hosts, pair and tile stay
    within a host (ranks are numbered host by host, as torchrun does)."""
    n = dist.get_world_size()
    frame, pair, tile = factor_pod(n, _local_ranks(), frames_per_pod)
    if frames_per_pod and frame != frames_per_pod:
        log.warning("frames_per_pod=%d does not divide %d devices; using %d",
                    frames_per_pod, n, frame)
    return make_mesh(frame=frame, pair=pair, tile=tile, device=device)
