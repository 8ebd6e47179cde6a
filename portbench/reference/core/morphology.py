"""Binary morphology on masks (counterpart of
`reconstruction_tpu/core/morphology.py`).

The reference erodes with one float convolution of the invalid indicator
by the structuring element.  Here the hit count is an exact integer sum:
the ellipse's rows are contiguous runs, so the 2D count is one row-window
difference of a cumulative sum per SE row.  No TF32, no float rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def ellipse_kernel(width: int, height: int) -> np.ndarray:
    """OpenCV-compatible ellipse structuring element
    (cv::getStructuringElement(MORPH_ELLIPSE, Size(width, height)))."""
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    se = np.zeros((height, width), np.float32)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, width)
            se[i, j1:j2] = 1.0
    return se


def _erode(valid: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """A pixel survives iff no invalid pixel lies under the SE footprint,
    anchored at (h//2, w//2); outside the image counts as valid."""
    h, w = se.shape
    r, c = h // 2, w // 2
    H, W = valid.shape
    inv = (~valid).to(torch.int32)
    invp = torch.nn.functional.pad(inv, (c, w - 1 - c, r, h - 1 - r))
    cs = torch.nn.functional.pad(torch.cumsum(invp, dim=1, dtype=torch.int32),
                                 (1, 0))
    hits = torch.zeros((H, W), dtype=torch.int32, device=valid.device)
    for dy in range(h):
        nz = np.flatnonzero(se[dy])
        if len(nz) == 0:
            continue
        a, b = int(nz[0]), int(nz[-1])
        hits += cs[dy:dy + H, b + 1:b + 1 + W] - cs[dy:dy + H, a:a + W]
    return hits == 0


def erode_mask(mask: torch.Tensor, se_size: int,
               threshold: float = 254.5) -> torch.Tensor:
    """Erode a [0,255] mask with an ellipse of diameter ``se_size``; float32
    out, 255.0 where every covered pixel was >= threshold, else 0.0."""
    out = _erode(mask >= threshold, ellipse_kernel(se_size, se_size))
    return out.float() * 255.0


def valid_mask(mask: torch.Tensor, threshold: float = 254.5) -> torch.Tensor:
    """Boolean validity from a [0,255] mask (reference: `mask == 255`)."""
    return mask >= threshold
