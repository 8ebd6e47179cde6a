"""Gaussian image pyramids (counterpart of `reconstruction_tpu/core/pyramid.py`).

5-tap binomial blur [1,4,6,4,1]/16, separable, reflect-101 borders, then
2x decimation.  Written as shifted slices summed in the reference's order
rather than as a convolution: a float32 `conv2d` on the card runs in TF32
through cuDNN, which would round values the reference keeps exact.
These are the plain versions: for CUDA tensors `ops/pyramid` runs each
step as one kernel, K9, with the same operations.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from reconstruction_tpu_torch.utils.fp import fma32

_KERNEL = (np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0).tolist()


def _reflect_pad(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """Reflect-101 padding of ``p`` along ``dim`` (jnp.pad mode='reflect')."""
    n = x.shape[dim]
    idx = torch.arange(-p, n + p, device=x.device)
    idx = idx.abs()
    idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return x.index_select(dim, idx)


def _blur(x: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_i k_i * x[i:i+n] along ``dim``, as the reference's contraction
    evaluates it: k0*x0, then one fused multiply-add per further tap."""
    n = x.shape[dim]
    xp = _reflect_pad(x, dim, 2)
    acc = _KERNEL[0] * xp.narrow(dim, 0, n)
    for i in range(1, 5):
        acc = fma32(_KERNEL[i], xp.narrow(dim, i, n), acc)
    return acc


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid step: blur + 2x decimate.  (H, W) or (H, W, C) float32."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    x = img.float()
    x = _blur(x, 0)
    x = _blur(x, 1)
    out = x[::2, ::2]
    if squeeze:
        out = out[..., 0]
    return out.contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Coarse->fine list of length ``levels``; ``img`` is the finest."""
    pyr = [img]
    cur = img
    for _ in range(levels - 1):
        cur = pyr_down(cur)
        pyr.insert(0, cur)
    return pyr


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """Round (half to even) to the uint8 grid; the values stay float32."""
    return torch.clamp(torch.round(img), 0.0, 255.0)
