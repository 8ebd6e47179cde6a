"""Rectification remap: map computation (host, numpy; on the card K8,
`ops/rectify_map`) + bilinear sampling (torch, on the images' device).
Counterpart of `reconstruction_tpu/core/remap.py`."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.utils.fp import fma32


def rectify_inverse(R_rect: np.ndarray, P_new: np.ndarray) -> np.ndarray:
    """M_inv = (A' R)^{-1}, float64 (3, 3): rectified pixel -> ray in the
    original camera, A' the left 3x3 block of ``P_new``."""
    A = np.asarray(P_new, np.float64)[:, :3]
    return np.linalg.inv(A @ np.asarray(R_rect, np.float64))


def sampling_maps(M_inv: np.ndarray, K: np.ndarray,
                  out_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The per-pixel part of `rectify_map`, float64 elementwise in a fixed
    order (K8, `csrc/rectify_map.cu`, repeats it operation for operation):

        xyw_i = (M_inv[i,0]*u + M_inv[i,1]*v) + M_inv[i,2]
        x, y  = xyw_0 / xyw_2, xyw_1 / xyw_2
        map_x = (K[0,0]*x + K[0,1]*y) + K[0,2],  map_y = K[1,1]*y + K[1,2]

    then rounded to float32.  The JAX package's `einsum` sums its terms in
    this order (0 + a and m*1 are exact), so the bits agree with it."""
    K = np.asarray(K, np.float64)
    M = np.asarray(M_inv, np.float64)
    w, h = out_size
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    xw, yw, ww = ((M[i, 0] * u + M[i, 1] * v) + M[i, 2] for i in range(3))
    x = xw / ww
    y = yw / ww
    map_x = (K[0, 0] * x + K[0, 1] * y) + K[0, 2]
    map_y = K[1, 1] * y + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def rectify_map(
    K: np.ndarray,
    R_rect: np.ndarray,
    P_new: np.ndarray,
    out_size: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """dst->src sampling map for one camera: (map_x, map_y) float32 arrays
    of shape (height, width), source coordinates in the original image."""
    return sampling_maps(rectify_inverse(R_rect, P_new), K, out_size)


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """a*(1-f) + b*f with the reference's contraction: fma(a, 1-f, b*f)."""
    return fma32(a, 1.0 - f, b * f)


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Bilinear sampling of ``img`` at (map_x, map_y), out-of-bounds -> fill
    (`cv::remap` with `CV_INTER_LINEAR` + `BORDER_CONSTANT`).

    img: (H, W) or (H, W, C); map_x, map_y: (Ho, Wo) on the same device.
    """
    H, W = img.shape[0], img.shape[1]
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    imgf = img.float()
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = (map_x - x0)[..., None]
    fy = (map_y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = imgf[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], vals,
                           torch.full_like(vals, fill))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    out = _lerp(_lerp(v00, v01, fx), _lerp(v10, v11, fx), fy)
    if squeeze:
        out = out[..., 0]
    return out
