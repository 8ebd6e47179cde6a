"""Zero-mean NCC window machinery (counterpart of
`reconstruction_tpu/stereo/ncc.py`): zero-padded static shifts, dense
window descriptors and the per-scanline score matrix."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def shifted(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """out[y, x] = img[y+dy, x+dx], ``fill`` outside (static shifts).

    img: (H, W) or (H, W, C)."""
    H, W = img.shape[:2]
    py0, py1 = max(-dy, 0), max(dy, 0)
    px0, px1 = max(-dx, 0), max(dx, 0)
    trail = (0, 0) * (img.ndim - 2)
    if img.dtype == torch.bool:
        x = F.pad(img.to(torch.uint8), trail + (px0, px1, py0, py1),
                  value=int(fill)).bool()
    else:
        x = F.pad(img, trail + (px0, px1, py0, py1), value=fill)
    return x[py1:py1 + H, px1:px1 + W]


def window_descriptors(img: torch.Tensor, radius: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense zero-mean L2-normalized (2r+1)^2 x C window descriptors.

    img: (H, W) or (H, W, C) float32.  Returns (desc (H, W, K) with
    K = (2r+1)^2 * C, taps ordered (dy, dx, c) as the reference; norm (H, W)
    the pre-normalization L2 norms).  The mean is taken first, then the
    norm of the centered window; a norm of 0 divides by 1.  Windows past
    the image read zeros."""
    if img.ndim == 2:
        img = img[..., None]
    cols = [shifted(img, dy, dx)
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    desc = torch.cat(cols, dim=-1)
    desc = desc - desc.mean(dim=-1, keepdim=True)
    norm = torch.linalg.vector_norm(desc, dim=-1)
    safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    return desc / safe[..., None], norm


def row_score_matrix(descL: torch.Tensor, descR: torch.Tensor) -> torch.Tensor:
    """(H, W, W) scores[y, x, x'] = NCC of left window (y, x) and right
    window (y, x'), from (H, W, K) normalized descriptors."""
    return torch.einsum("hwk,hvk->hwv", descL, descR)
