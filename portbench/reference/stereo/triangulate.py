"""Disparity -> world-space point cloud (counterpart of
`reconstruction_tpu/stereo/triangulate.py`): Q-matrix reprojection with
the reference's scale handling, extra mask erosion by 2% of the image
height, the rectified-cam -> world transform and BGR colours.  The
buffer keeps every pixel with a validity mask (fixed shapes)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.config import NOMATCH
from portbench.reference.core.morphology import erode_mask, valid_mask
from portbench.reference.stereo.margins import Margins, inner_box
from portbench.reference.utils.fp import fma32


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
