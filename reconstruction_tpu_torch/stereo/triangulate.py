"""Disparity -> world-space point cloud (counterpart of
`reconstruction_tpu/stereo/triangulate.py`): Q-matrix reprojection with
the reference's scale handling, extra mask erosion by 2% of the image
height, the rectified-cam -> world transform and BGR colours.  The
buffer keeps every pixel with a validity mask (fixed shapes)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.core.morphology import erode_mask, erode_mask_np, valid_mask
from reconstruction_tpu_torch.stereo.margins import Margins, inner_box
from reconstruction_tpu_torch.utils.fp import fma32


class PointCloud(NamedTuple):
    """Padded point buffer: xyz (N, 3) f32, colors (N, 3) uint8 BGR,
    valid (N,) bool."""

    xyz: torch.Tensor
    colors: torch.Tensor
    valid: torch.Tensor

    def compact(self) -> "PointCloud":
        """Host numpy arrays of the valid rows only."""
        v = self.valid.cpu().numpy()
        return PointCloud(xyz=self.xyz.cpu().numpy()[v],
                          colors=self.colors.cpu().numpy()[v],
                          valid=np.ones(int(v.sum()), bool))


def disparity_to_cloud(
    disp: torch.Tensor,
    mask: torch.Tensor,
    image: torch.Tensor,
    Q: np.ndarray,
    R_final: np.ndarray,
    T_final: np.ndarray,
    m: Margins,
    scale: float,
    erode_frac: float = 0.02,
) -> PointCloud:
    """Triangulate one disparity map.

    disp: (H, W) disparity (d = x_r - x_l), NOMATCH holes; mask: (H, W)
    [0,255]; image: (H, W, 3) rectified BGR source image; Q: 4x4
    reprojection matrix; R_final, T_final: rectified-cam -> world;
    m: source margins; scale: LowestLevelWidth / OriginWidth * 2^level.
    """
    H, W = disp.shape
    dev = disp.device
    erode_size = int(np.ceil(erode_frac * H))
    mask_e = erode_mask(mask, erode_size) if erode_size > 1 else mask
    ok = valid_mask(mask_e) & (disp != NOMATCH) & inner_box(m, H, W)

    Qs = np.asarray(Q, np.float32).copy()
    Qs[:, 3] *= np.float32(scale)
    q03, q13, q23, q32, q33 = (float(v) for v in (
        Qs[0, 3], Qs[1, 3], Qs[2, 3], Qs[3, 2], Qs[3, 3]))
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    iW = 1.0 / fma32(q32, disp, q33)
    X = (q03 + x) * iW
    Y = (y + q13) * iW
    Z = q23 * iW
    Rf = np.asarray(R_final, np.float32)
    Tf = np.asarray(T_final, np.float32)
    # World transform written out per component (no TF32 matmul).
    world = torch.stack([
        float(Rf[i, 0]) * X + float(Rf[i, 1]) * Y + float(Rf[i, 2]) * Z
        + float(Tf[i]) for i in range(3)], dim=-1)
    colors = torch.clamp(image, 0, 255).to(torch.uint8)
    return PointCloud(xyz=world.reshape(-1, 3), colors=colors.reshape(-1, 3),
                      valid=ok.reshape(-1))


def disparity_to_cloud_np(
    disp: np.ndarray,
    mask_u8: np.ndarray,
    image_u8: np.ndarray,
    Q: np.ndarray,
    R_final: np.ndarray,
    T_final: np.ndarray,
    margins: np.ndarray,
    scale: float,
    erode_frac: float = 0.02,
) -> PointCloud:
    """Host twin of `disparity_to_cloud` on numpy arrays, returning numpy
    arrays: the same erosion (`erode_mask_np`) and the JAX package's host
    float32 math (no fused multiply-adds, a matmul for the world
    transform), so it is exact against that package's twin, not against
    `disparity_to_cloud`.

    margins: (4,) int array (YL, YR, XL, XR), the Margins in field order.
    """
    H, W = disp.shape
    erode_size = int(np.ceil(erode_frac * H))
    valid = (erode_mask_np(mask_u8, erode_size) if erode_size > 1
             else np.asarray(mask_u8) >= 254.5)
    YL, YR, XL, XR = (int(v) for v in margins)
    y = np.arange(H, dtype=np.float32)[:, None]
    x = np.arange(W, dtype=np.float32)[None, :]
    inner = (y >= YL) & (y <= YR) & (x >= XL) & (x <= XR)
    disp = np.asarray(disp, np.float32)
    ok = valid & (disp != NOMATCH) & inner

    Qs = np.asarray(Q, np.float32).copy()
    Qs[:, 3] *= np.float32(scale)
    q03, q13, q23 = Qs[0, 3], Qs[1, 3], Qs[2, 3]
    q32, q33 = Qs[3, 2], Qs[3, 3]
    iW = np.float32(1.0) / (q33 + q32 * disp)
    X = (q03 + x) * iW
    Y = (y + q13) * iW
    Z = (q23 * iW) * np.ones_like(X)
    F = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    world = F @ np.asarray(R_final, np.float32).T + np.asarray(T_final, np.float32)
    return PointCloud(xyz=world.reshape(-1, 3),
                      colors=np.ascontiguousarray(image_u8).reshape(-1, 3),
                      valid=ok.reshape(-1))
