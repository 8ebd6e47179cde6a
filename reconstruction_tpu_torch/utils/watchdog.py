"""Stage watchdogs and failure containment (counterpart of
`reconstruction_tpu/utils/watchdog.py`).

The reference's only failure handling is a 20 s `WaitForSingleObject`
watchdog around TextureStitcher (`CCloudOptimization.cpp:396-397,423-440`)
and hard exits elsewhere.  Here: a deadline wrapper for host-side stages,
and a NaN guard for stage outputs, host arrays or device tensors (the
analogue of the lone `assert(dCenter==dCenter)` at `CStereoMatching.cpp:621`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np
import torch

from reconstruction_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class StageTimeout(Exception):
    pass


def run_with_deadline(fn: Callable[[], Any], seconds: float,
                      name: str = "stage") -> Any:
    """Run a host-side stage with a watchdog (the `safe_process`
    equivalent).  On timeout the worker thread is abandoned (daemonized)
    and StageTimeout raised; callers fall back or resume from the last
    checkpoint."""
    result: list = [None]
    error: list = [None]

    def target():
        try:
            result[0] = fn()
        except BaseException as e:  # noqa: BLE001  (re-raised in the caller)
            error[0] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        log.error("%s exceeded %.1fs deadline; abandoning", name, seconds)
        raise StageTimeout(name)
    if error[0] is not None:
        raise error[0]
    return result[0]


def check_finite(name: str, *arrays) -> None:
    """NaN/Inf guard on stage outputs (numpy arrays or tensors, counted on
    their own device); raises with the stage name."""
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            bad = int((~torch.isfinite(a)).sum()) if a.is_floating_point() else 0
        else:
            a = np.asarray(a)
            bad = int((~np.isfinite(a)).sum()) if a.dtype.kind == "f" else 0
        if bad:
            raise FloatingPointError(f"{name}: output {i} has {bad} non-finite values")
