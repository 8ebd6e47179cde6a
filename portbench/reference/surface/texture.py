"""Multi-view vertex texturing (counterpart of
`reconstruction_tpu/surface/texture.py`).

Replaces TextureStitcher.exe (`CCloudOptimization.cpp:396`) and the
single-view recolor `texture_color` (`:400-421`): every vertex projects
into each camera (world -> scaled rectified pixels, `CStereoMatching.cpp:145`),
samples the rectified image bilinearly, and the views blend weighted by
mask validity and normal-to-view alignment.  The blend runs on a device
(`texture_vertices`) or in numpy (`texture_vertices_np`, the native
backend's host path).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _t(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def project_vertices(P: torch.Tensor, verts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World -> pixel coordinates through a 3x4 projection.  Returns (uv, z)."""
    P = _t(P, verts.device)
    p = (verts[:, None, :] * P[None, :, :3]).sum(-1) + P[None, :, 3]
    z = p[:, 2]
    uv = p[:, :2] / torch.where(z.abs() > 1e-12, z, 1e-12)[:, None]
    return uv, z


def _bilinear(img: torch.Tensor, uv: torch.Tensor, fill: float = 127.0) -> torch.Tensor:
    H, W = img.shape[:2]
    x, y = uv[:, 0], uv[:, 1]
    xf, yf = torch.floor(x), torch.floor(y)
    fx = (x - xf)[:, None]
    fy = (y - yf)[:, None]
    x0, y0 = xf.to(torch.int64), yf.to(torch.int64)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(ok[:, None], val, fill)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def texture_single_view(verts: np.ndarray, P: np.ndarray, image: np.ndarray) -> np.ndarray:
    """Single-view recolor (the reference's per-pair `color_<pair>_k.ply`,
    `CCloudOptimization.cpp:127-143`): nearest pixel, gray (127, 127, 127)
    outside (`:412-415`).  Host math: the values go straight to a PLY."""
    verts = np.asarray(verts, np.float32)
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1)
    p = vh @ np.asarray(P, np.float32).T
    z = p[:, 2]
    uv = p[:, :2] / np.where(np.abs(z) > 1e-12, z, 1e-12)[:, None]
    uvr = np.round(uv).astype(np.int64)
    H, W = image.shape[:2]
    ok = ((uvr[:, 0] >= 0) & (uvr[:, 0] < W)
          & (uvr[:, 1] >= 0) & (uvr[:, 1] < H))
    img = np.asarray(image, np.float32)
    col = img[np.clip(uvr[:, 1], 0, H - 1), np.clip(uvr[:, 0], 0, W - 1)]
    return np.where(ok[:, None], col, 127.0)


def _bilinear_np(img: np.ndarray, uv: np.ndarray, fill: float) -> np.ndarray:
    """numpy twin of `_bilinear` (same taps, same out-of-bounds fill)."""
    H, W = img.shape[:2]
    x, y = uv[:, 0], uv[:, 1]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(ok[:, None], val, fill)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def texture_vertices_np(verts, normals, cameras) -> np.ndarray:
    """Host texture blend, the same math as `texture_vertices`."""
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    acc = np.zeros((len(verts), 3), np.float32)
    wacc = np.zeros((len(verts),), np.float32)
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1)
    for P, image, mask, center in cameras:
        p = vh @ np.asarray(P, np.float32).T
        z = p[:, 2]
        uv = p[:, :2] / np.where(np.abs(z) > 1e-12, z, 1e-12)[:, None]
        col = _bilinear_np(np.asarray(image, np.float32), uv, 127.0)
        mval = _bilinear_np(np.asarray(mask, np.float32)[..., None], uv, 0.0)[:, 0]
        view_dir = np.asarray(center, np.float32)[None] - verts
        view_dir /= np.maximum(np.linalg.norm(view_dir, axis=1, keepdims=True), 1e-9)
        facing = (normals * view_dir).sum(1)
        w = np.maximum(facing, 0.0) * (mval > 200.0) * (z > 0)
        acc += col * w[:, None].astype(np.float32)
        wacc += w.astype(np.float32)
    return np.where(wacc[:, None] > 1e-6, acc / np.maximum(wacc, 1e-6)[:, None], 127.0)


def texture_vertices(
    verts: np.ndarray,
    normals: np.ndarray,
    cameras: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    backend: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Blend vertex colors over views.

    Args:
      verts: (V, 3) world positions; normals: (V, 3) vertex normals.
      cameras: per view (P 3x4 world->pixel, image (H, W, 3), mask (H, W),
        center (3,) world camera center); images and masks may be tensors.
      backend: "torch" or "auto" (the blend on ``device``, the card unless
        the caller asks for the CPU) or "native" (the numpy host blend).

    Returns (V, 3) colors (BGR, 0..255) as a host array.
    """
    dev = torch.device(device)
    v = _t(verts, dev)
    n = _t(normals, dev)
    acc = torch.zeros((len(v), 3), device=dev)
    wacc = torch.zeros((len(v),), device=dev)
    for P, image, mask, center in cameras:
        uv, z = project_vertices(P, v)
        col = _bilinear(_t(image, dev), uv)
        mval = _bilinear(_t(mask, dev)[..., None], uv, 0.0)[:, 0]
        view_dir = _t(center, dev)[None] - v
        view_dir = view_dir / torch.clamp_min(
            torch.sqrt((view_dir * view_dir).sum(1, keepdim=True)), 1e-9)
        facing = (n * view_dir).sum(1)
        w = torch.clamp_min(facing, 0.0) * (mval > 200.0) * (z > 0)
        acc = acc + col * w[:, None]
        wacc = wacc + w
    out = torch.where(wacc[:, None] > 1e-6,
                      acc / torch.clamp_min(wacc, 1e-6)[:, None], 127.0)
    return out.cpu().numpy()
