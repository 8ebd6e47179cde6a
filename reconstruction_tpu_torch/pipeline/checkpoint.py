"""Stage checkpoint store (a copy of `reconstruction_tpu/pipeline/checkpoint.py`).

The reference has no formal checkpointing — restart means rerun, with
`tmp/*.ply` artifacts as accidental checkpoints (SURVEY.md section 5).
Here every stage output is stored keyed by (stage, index) so a failed or
preempted run resumes at pair/stage granularity — the per-pair
checkpointed fusion required for elastic multi-host operation.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


class StageStore:
    """Directory-backed npz store keyed by (stage, index)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, stage: str, index: Any) -> str:
        return os.path.join(self.root, f"{stage}_{index}.npz")

    def save(self, stage: str, index: Any, **arrays: np.ndarray) -> None:
        # np.savez appends .npz when missing; keep the suffix on the temp
        # name so the atomic rename finds it.
        tmp = self._path(stage, index) + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, self._path(stage, index))

    def load(self, stage: str, index: Any) -> Optional[Dict[str, np.ndarray]]:
        p = self._path(stage, index)
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}

    def has(self, stage: str, index: Any) -> bool:
        return os.path.exists(self._path(stage, index))

    def manifest(self) -> Dict[str, Any]:
        return {"entries": sorted(os.listdir(self.root))}
