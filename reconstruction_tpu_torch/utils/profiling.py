"""Device profiling and roofline accounting (the port's own counterpart of
`reconstruction_tpu/utils/profiling.py`).

  * `CHIP_PEAKS`: the card's published peaks, the one table that
    `chip_smoke.py` reads;
  * `resolve_chip(device)`: the device's name mapped onto a table entry;
  * `card_line(device)`: the card's name and power limit, as nvidia-smi
    reports them, to write beside every number taken on it;
  * `trace(path)`: `torch.profiler` over a block, written as a Chrome
    trace;
  * `KernelCost.utilization`: a measured time against those peaks.
"""

from __future__ import annotations

import contextlib
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
    block; the trace is written to ``path`` (Chrome trace JSON)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


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
