"""Structured logging and per-stage scalar stats (counterpart of
`reconstruction_tpu/utils/logging.py`)."""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List


def get_logger(name: str = "reconstruction_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


@dataclass
class StageStats:
    """Accumulates per-stage scalars, one record a stage."""

    records: List[Dict[str, Any]] = field(default_factory=list)

    def add(self, stage: str, **scalars: Any) -> None:
        rec = {"stage": stage}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "item") else v
        self.records.append(rec)
