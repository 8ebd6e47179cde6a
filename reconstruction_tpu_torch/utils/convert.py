"""State carried across from the JAX package.

The system has no learned weights; what one package's run hands the next
stage is its state: margins, a pyramid level's disparities (the coarse
state the next level starts from), the pair's rectification, and for
bundle adjustment a problem (`BAProblem`) or a view's detections
(`Features`).
`from_jax_state` turns those outputs (fields as numpy arrays, or
anything `np.asarray` accepts) into this package's types, so that a test can feed
the reference's coarse level into the port's next one.  It matches types
by their field names and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem
from reconstruction_tpu_torch.ba.features import Features
from reconstruction_tpu_torch.core.rectify import RectifyResult
from reconstruction_tpu_torch.stereo.margins import Margins
from reconstruction_tpu_torch.stereo.pipeline import LevelState

_MARGIN_FIELDS = ("YL", "YR", "XL", "XR")
_LEVEL_FIELDS = ("disp0", "disp1", "refine_drift0", "refine_drift1")
_BA_TYPES = {  # field names -> (type, dtype per field)
    BAProblem._fields: (BAProblem, (torch.float32,) * 4 + (torch.int32, torch.bool)),
    Features._fields: (Features, (torch.float32, torch.float32, torch.bool)),
}


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def from_jax_state(obj, device="cpu"):
    """Margins, LevelState, RectifyResult, BAProblem or Features of the JAX
    package -> the port's counterpart on ``device``."""
    fields = getattr(obj, "_fields", None)
    if fields == _MARGIN_FIELDS:
        return Margins(*[_tensor(v, device, torch.int32) for v in obj])
    if fields == _LEVEL_FIELDS:
        return LevelState(*[_tensor(v, device, torch.float32) for v in obj])
    if fields in _BA_TYPES:
        cls, dtypes = _BA_TYPES[fields]
        return cls(*[_tensor(v, device, dt) for v, dt in zip(obj, dtypes)])
    if dataclasses.is_dataclass(obj) and type(obj).__name__ == "RectifyResult":
        kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        for k, v in kw.items():
            if k != "baseline_axis":
                kw[k] = np.array(v, np.float64, copy=True)
        return RectifyResult(**kw)
    raise TypeError(f"from_jax_state: no counterpart for {type(obj).__name__}")
