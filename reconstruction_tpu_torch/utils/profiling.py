"""Device profiling and roofline accounting (the port's own counterpart of
`reconstruction_tpu/utils/profiling.py`).

  * `CHIP_PEAKS`: the card's published peaks, the one table that
    `chip_smoke.py` reads;
  * `resolve_chip(device)`: the device's name mapped onto a table entry;
  * `card_line(device)`: the card's name and power limit, as nvidia-smi
    reports them, to write beside every number taken on it;
  * `trace(path)`: `torch.profiler` over a block, written as a Chrome
    trace with the program's spans on a track of their own;
  * `cuda_activity(prof)`: a finished session's device events, read raw
    (held once a process against `prof.events()`: `check_event_reader`);
  * `KernelCost.utilization`: a measured time against those peaks;
  * the cost models of the bench's cells (`ncc_sweep_cost`, `refine_cost`,
    `poisson_cost`, `schur_cost`): the float32 operations and the
    device-memory bytes of each cell's whole function, counted from its
    shapes, whatever kernels or launches compute it.  A cell may span
    several launches; `chip_smoke.py`'s bounds each bound one launch.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch

# Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit):
# float32 outside the tensor cores, int8 on the tensor cores, and device
# memory in bytes/s (the key keeps the reference's name).
CHIP_PEAKS = {
    "h100": {"flops_f32": 67e12, "int8_ops": 1979e12, "hbm_gbps": 3.35e12},
}


def resolve_chip(device="cuda") -> Tuple[str, str]:
    """Map the device's identity onto a CHIP_PEAKS entry.

    Returns (peaks_key, device name).  A name that is not an H100 keeps the
    H100's peaks and says so in the returned name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "h100", f"{dev.type} (not a GPU; h100 peaks nominal)"
    kind = torch.cuda.get_device_name(dev)
    if "h100" in kind.lower().replace(" ", ""):
        return "h100", kind
    return "h100", f"{kind} (unknown; h100 peaks assumed)"


def card_line(device="cuda") -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card ("cpu" for a CPU device); raises if nvidia-smi fails."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(path: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler (CPU and, where there is one, CUDA activity) over the
    block; the trace is written to ``path`` (Chrome trace JSON), with the
    program's spans recorded inside the block (`utils/timing.span`) on a
    track of their own ("program spans"), on the device rows' time base."""
    from torch.profiler import ProfilerActivity, profile

    from reconstruction_tpu_torch.utils.timing import span_mark, span_records
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    mark = span_mark()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)   # the trace's ts: microseconds after it
    pid = "program spans"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for r in span_records(mark):
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
                       "tid": r.thread, "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": {"parent": r.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


def _raw_cuda(prof) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda), key=lambda e: e.start_ns())


_READER_CHECKED = 0


def check_event_reader(attempts: int = 3) -> int:
    """Hold `cuda_activity`'s raw reader against `prof.events()` on a small
    session of its own (32 elementwise kernels): the same device events,
    names and durations (within 1 ns), or AssertionError.  Runs once a
    process; returns the number of events compared."""
    global _READER_CHECKED
    if _READER_CHECKED:
        return _READER_CHECKED
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                x = x * 1.0001 + 1.0
            torch.cuda.synchronize()
        raw = _raw_cuda(prof)
        if raw:
            break
    else:
        raise AssertionError(f"the profiler recorded no device event in {attempts} sessions")
    cuda = torch.autograd.DeviceType.CUDA
    wrapped = sorted((e for e in prof.events() if e.device_type == cuda),
                     key=lambda e: e.time_range.start)
    got = [(e.name(), e.duration_ns() / 1e3) for e in raw]
    want = [(e.name, e.time_range.elapsed_us()) for e in wrapped]
    if len(got) != len(want) or any(a[0] != b[0] or abs(a[1] - b[1]) > 1e-3
                                    for a, b in zip(got, want)):
        raise AssertionError(f"the raw profiler events differ from prof.events() "
                             f"(torch {torch.__version__}): {got[:4]} against {want[:4]}")
    _READER_CHECKED = len(got)
    return _READER_CHECKED


def cuda_activity(prof) -> list:
    """The device events of a finished torch.profiler session, sorted by
    start, as the profiler's raw records (``name()``, ``start_ns()``,
    ``duration_ns()``) from its private ``prof.profiler.kineto_results``
    (torch 2.x): `prof.events()` takes 10-50 s to wrap the ~44,000-55,000
    events of a 1920x1280 pair.  The first call in a process runs
    `check_event_reader`."""
    check_event_reader()
    return _raw_cuda(prof)


@dataclass
class KernelCost:
    """Float32 operations and device-memory bytes of one piece of work."""
    flops: float
    hbm_bytes: float

    def utilization(self, seconds: float, chip: str = "h100") -> Dict[str, float]:
        peaks = CHIP_PEAKS[chip]
        return {
            "gflops_per_s": self.flops / seconds / 1e9,
            "flops_util": self.flops / seconds / peaks["flops_f32"],
            "hbm_gbps": self.hbm_bytes / seconds / 1e9,
            "hbm_util": self.hbm_bytes / seconds / peaks["hbm_gbps"],
            "bound": ("hbm" if self.hbm_bytes / peaks["hbm_gbps"]
                      > self.flops / peaks["flops_f32"] else "flops"),
        }


def ncc_sweep_cost(H: int, W: int, C: int, radius: int,
                   num_shifts: int) -> KernelCost:
    """The zero-mean NCC shift sweep with a running argmax over
    ``num_shifts`` shifts of an (H, W, C) pair (`stereo/matching.
    ncc_sweep_match`), as the JAX package counts it.

    Operations per pixel and shift: C multiplies and C - 1 adds of the
    channel product, 4 * radius adds of the separable box sum, and ~10 for
    the score and the compare-and-keep: (2C - 1) + 4r + 10.

    Bytes per pixel, each read once and the state written once: the two
    images (2 * 4C), four moment maps (16), validR as float32 (4), active
    (1), the two bound maps (8) and the (score, best shift) state (8):
    8C + 37."""
    per_px = (2 * C - 1) + 4 * radius + 10
    return KernelCost(flops=float(H * W * per_px * num_shifts),
                      hbm_bytes=H * W * (8.0 * C + 37.0))


def refine_cost(H: int, W: int, iterations: int, s_cap: int,
                build_shifts: int) -> KernelCost:
    """The subpixel refine (`stereo/refine.disparity_refine`): a 3x3 NCC
    cost volume of ``s_cap`` float32 slots a pixel, ``build_shifts`` of
    them filled, then ``iterations`` Jacobi sweeps.

    The build: `ncc_sweep_cost` at C 3, radius 1 over ``build_shifts``
    shifts for its inputs and operations, and the volume written once,
    H * W * s_cap * 4 bytes.

    A sweep, per pixel: its three parabola taps (12 bytes), its disparity
    and its window's anchor (8) and the inner-box mask (1) read once, its
    disparity written once (4): 25 bytes.  94 operations: the parabola over
    the three taps, the two exps of the N/S/E/W weights and the blend (the
    JAX package's ~230 less the 136 compares and selects with which the
    TPU picks the three taps out of a 32-slot window; here they are three
    loads)."""
    build = ncc_sweep_cost(H, W, 3, 1, build_shifts)
    px = float(H * W)
    return KernelCost(
        flops=build.flops + iterations * px * 94.0,
        hbm_bytes=build.hbm_bytes + px * s_cap * 4.0 + iterations * px * 25.0)


def poisson_cost(resolution: int) -> KernelCost:
    """The spectral Poisson solve on an R^3 grid, as the JAX package counts
    it: an rfftn and an irfftn (5 n log2 n operations each, twice for the
    complex arithmetic) and ~10 operations of eigenvalue scaling a cell;
    six 8-byte passes over the n = R^3 cells."""
    n = resolution ** 3
    fft_flops = 2 * 5.0 * n * math.log2(max(n, 2))
    return KernelCost(flops=fft_flops + 10 * n, hbm_bytes=8.0 * n * 6)


def schur_cost(num_points: int, obs_per_point: int, num_cameras: int) -> KernelCost:
    """One BA Gauss-Newton step's assembly and Schur reduction
    (`ba/bundle_adjust.ba_step`) over M points with O observations each
    (n = M * O) and C cameras.

    Operations: ~250 an observation for the analytic Jacobians and ~160
    for its block products, and per point the coupling contractions
    (C * 6 * 3 * 3) and its share of the Schur product (C^2 * 36 * 3).

    Bytes, each stream read once: per observation the 20 component arrays
    of the Jacobians and residual, written and read (40 floats), and the 54
    rows of the block stacks (4 bytes each); the 18 coupling rows He once
    (n * 18 * 4), reduced into W_t by each observation's camera index; the
    three (6C, M) operand pairs of the Schur product (6 * 6C * M * 4)."""
    m, o, c = num_points, obs_per_point, num_cameras
    n = m * o
    red = m * (c * 6 * 3 * 3 + c * c * 36 * 3)
    bytes_obs = n * (40 + 54) * 4
    bytes_w = n * 18 * 4
    bytes_s = 6 * (c * 6) * m * 4
    return KernelCost(flops=float(n * (250 + 160) + red),
                      hbm_bytes=float(bytes_obs + bytes_w + bytes_s))
