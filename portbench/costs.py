"""The yardstick's peaks and cost models (a frozen copy of the port's
`utils/profiling.CHIP_PEAKS` and `ncc_sweep_cost`, and its `refine_cost`
counted by passes over device memory rather than by sweeps).

A cost model counts the float32 operations and the device-memory bytes
that a function's work needs, from its shapes, whatever kernels compute
it.  A roofline share is the least time the card could take (operations
at the float32 peak or bytes at the memory peak, the larger) over the
measured time.
"""

from __future__ import annotations

import math
import subprocess
from dataclasses import dataclass

# Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit):
# float32 outside the tensor cores, and device memory in bytes/s.
PEAKS = {"flops_f32": 67e12, "hbm_bytes_per_s": 3.35e12}

# Sweeps of the subpixel refine that one pass over device memory runs
# (`refine_cost`).
SWEEPS_PER_PASS = 6


@dataclass
class KernelCost:
    """Float32 operations and device-memory bytes of one piece of work."""

    flops: float
    hbm_bytes: float

    def bound_s(self) -> float:
        return max(self.flops / PEAKS["flops_f32"], self.hbm_bytes / PEAKS["hbm_bytes_per_s"])

    def bound_by(self) -> str:
        return ("bytes" if self.hbm_bytes / PEAKS["hbm_bytes_per_s"]
                > self.flops / PEAKS["flops_f32"] else "operations")

    def share_pct(self, seconds: float) -> float:
        return 100.0 * self.bound_s() / seconds


def ncc_sweep_cost(H: int, W: int, C: int, radius: int, num_shifts: int) -> KernelCost:
    """The zero-mean NCC shift sweep with a running argmax over
    ``num_shifts`` shifts of an (H, W, C) pair.

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


def refine_cost(H: int, W: int, iterations: int, build_shifts: float) -> KernelCost:
    """The subpixel refine: a 3x3 NCC cost volume with ``build_shifts``
    shifts a pixel filled, then ``iterations`` sweeps.

    The build: `ncc_sweep_cost` at C 3, radius 1 over ``build_shifts``
    shifts for its inputs and operations, and the filled slots written
    once, 4 bytes each.

    The sweeps: a sweep reads its neighbours' disparities of the sweep
    before, so a kernel can keep only a tile's few sweeps on chip between
    passes over device memory.  They are counted in passes of
    SWEEPS_PER_PASS sweeps, as the port's K2 fuses them: per pass and
    pixel the disparity read and written (8 bytes), its window's two
    anchors (8), the inner-box mask (1) and the three parabola taps of the
    pass's first sweep (12), 29 bytes; a later sweep's taps are counted
    as read on chip.  94 operations a sweep and pixel."""
    build = ncc_sweep_cost(H, W, 3, 1, 1)
    px = float(H * W)
    passes = math.ceil(iterations / SWEEPS_PER_PASS)
    return KernelCost(
        flops=build.flops * build_shifts + iterations * px * 94.0,
        hbm_bytes=build.hbm_bytes + px * build_shifts * 4.0 + passes * px * 29.0)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card ("not read" where nvidia-smi fails)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    if out.returncode != 0:
        return f"not read ({out.stderr.strip()})"
    return out.stdout.strip().splitlines()[0]
