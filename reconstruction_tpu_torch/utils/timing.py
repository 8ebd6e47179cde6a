"""Wall-clock stage timing (counterpart of `reconstruction_tpu/utils/timing.py`).

A context-manager timer of named spans.  On a CUDA device a span starts
and ends with `torch.cuda.synchronize()`, so the work queued inside it is
counted in it and not in the next span.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


class Timer:
    """Collects named wall-clock spans; a name used twice adds up."""

    def __init__(self, device="cpu") -> None:
        self.spans: Dict[str, float] = {}
        self.sync = torch.device(device).type == "cuda"

    class _Span:
        def __init__(self, timer: "Timer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            if self.timer.sync:
                torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self.timer.sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - self.t0
            self.timer.spans[self.name] = self.timer.spans.get(self.name, 0.0) + dt
            return False

    def span(self, name: str) -> "Timer._Span":
        return Timer._Span(self, name)

    def report(self) -> str:
        total = sum(self.spans.values())
        lines = [f"{k:<32s} {v:8.3f}s" for k, v in self.spans.items()]
        lines.append(f"{'total':<32s} {total:8.3f}s")
        return "\n".join(lines)
