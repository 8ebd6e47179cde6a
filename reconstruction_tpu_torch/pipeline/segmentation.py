"""Foreground mask generation: background-subtraction NCC, morphology and
region growing (counterpart of `reconstruction_tpu/pipeline/segmentation.py`).

Replaces the MATLAB/mex preprocessing (`Demo/segmentation/CutImageDir.m`,
`CutImageDir_canon.m`, `RegionGrowing.m`, `RegionGrowing_mex.cpp`):

  1. background model: the mean of a camera's frames (`CutImageDir.m:10-20`),
  2. per-pixel NCC score S between frame and background over a small
     window; foreground where S < threshold (0.4, `CutImageDir.m:40-46`),
  3. morphological close/fill/open,
  4. keep the connected component containing the image center,
  5. region growing from the corner with the intensity criterion
     |region_mean - I| < max_dif (`RegionGrowing_mex.cpp:153-266`) to carve
     away background bleed, then final morphology.

The score, the morphology and the flood fill run on the device; hole
filling and connected components are one scipy pass each on the host, as
in the reference.  The flood fill checks for its fixed point every
``CHECK_EVERY`` iterations, which is one read-back from the device each.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reconstruction_tpu_torch.core.morphology import ellipse_kernel
from reconstruction_tpu_torch.ops.ncc_sweep import box_sum
from reconstruction_tpu_torch.stereo.matching import ncc_moments

# Iterations of the flood fill between two fixed-point checks.
CHECK_EVERY = 32


def background_ncc_score(img: torch.Tensor, bg: torch.Tensor,
                         radius: int = 2) -> torch.Tensor:
    """Zero-mean NCC between the frame and the background model at each
    pixel (windowed): high where the frame matches the background."""
    a = img.float() - 128.0
    b = bg.float() - 128.0
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    ma = ncc_moments(a, radius)
    mb = ncc_moments(b, radius)
    cross = box_sum((a * b).sum(-1), radius)
    return (cross - ma.n * ma.mean * mb.mean) * ma.inv_norm * mb.inv_norm


def _binary_morph(mask: torch.Tensor, op: str, radius: int) -> torch.Tensor:
    """Disk open/close/dilate/erode by counting with a convolution (the
    counts are small integers, exact in any precision)."""
    se = torch.as_tensor(ellipse_kernel(2 * radius + 1, 2 * radius + 1),
                         dtype=torch.float32, device=mask.device)

    def dil(m):
        h = F.conv2d(m.float()[None, None], se[None, None], padding=radius)[0, 0]
        return h > 0.5

    def ero(m):
        return ~dil(~m)

    if op == "dilate":
        return dil(mask)
    if op == "erode":
        return ero(mask)
    if op == "open":
        return dil(ero(mask))
    if op == "close":
        return ero(dil(mask))
    raise ValueError(op)


def _grow(cur: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """One masked 4-neighbour dilation step (zero outside the image)."""
    p = F.pad(cur.to(torch.uint8), (1, 1, 1, 1)).bool()
    return (cur | p[1:-1, 2:] | p[1:-1, :-2] | p[2:, 1:-1] | p[:-2, 1:-1]) & allowed


def flood_fill(seed: torch.Tensor, allowed: torch.Tensor,
               max_iters: int = 4096) -> torch.Tensor:
    """Fixed point of masked 4-neighbor dilation: all `allowed` pixels
    reachable from `seed`, after at most ``max_iters`` steps.

    The step is idempotent at the fixed point, so running up to
    ``CHECK_EVERY`` steps between two checks gives the reference's result;
    the last chunk stops at ``max_iters``.  Each check reads one flag back
    from the device (counted in ``flood_fill.readbacks``)."""
    cur = seed & allowed
    done = 0
    while done < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - done)):
            prev, cur = cur, _grow(cur, allowed)
            done += 1
        flood_fill.readbacks += 1
        if torch.equal(prev, cur):
            break
    return cur


flood_fill.readbacks = 0


def region_growing(img: torch.Tensor, seed_xy: Tuple[int, int],
                   max_dif: float, iters: int = 64) -> torch.Tensor:
    """Region growing with a running region mean
    (`RegionGrowing_mex.cpp:153-266`): alternate between flood-fill over
    the |mean - I| < max_dif level set and mean re-estimation."""
    g = img.float()
    seed = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    seed[seed_xy[1], seed_xy[0]] = True
    region = seed
    mean = g[seed_xy[1], seed_xy[0]]
    for _ in range(4):  # a few mean refinements
        allowed = (g - mean).abs() < max_dif
        region = flood_fill(region | seed, allowed, max_iters=iters)
        # The mean in float64, so that the card and the CPU agree on it
        # whatever their reduction order.
        mean = (torch.where(region, g, 0.0).double().sum()
                / region.sum().clamp_min(1)).float()
    return region


def segment_frame(
    img: np.ndarray,
    background: np.ndarray,
    threshold: float = 0.4,
    radius: int = 2,
    *,
    device="cuda",
) -> np.ndarray:
    """Full per-frame mask (`CutOneImage`, `CutImageDir.m:29-70`) of host
    images, computed on ``device``.  Returns a float32 mask in {0, 255}."""
    from scipy import ndimage
    dev = torch.device(device)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    S = background_ncc_score(on(img), on(background), radius)
    fg = _binary_morph(S < threshold, "close", 3).cpu().numpy()
    fg = ndimage.binary_fill_holes(fg)
    fg = _binary_morph(on(fg), "open", 2).cpu().numpy()

    # keep the component containing the image center (`:47-49`)
    lab, n = ndimage.label(fg)
    cy, cx = np.asarray(fg.shape) // 2
    target = lab[cy, cx]
    if target == 0 and n > 0:
        sizes = ndimage.sum(fg, lab, index=range(1, n + 1))
        target = 1 + int(np.argmax(sizes))
    fg = lab == target

    # region-grow the BACKGROUND from the corner to carve bleed (`:53`)
    gray = img.mean(-1) if img.ndim == 3 else img
    bg_region = region_growing(on(gray), (1, 1), max_dif=0.2 * 255,
                               iters=max(fg.shape))
    fg = fg & ~bg_region.cpu().numpy()

    fg = ndimage.binary_fill_holes(fg)
    lab, n = ndimage.label(fg)
    if n > 1:
        sizes = ndimage.sum(fg, lab, index=range(1, n + 1))
        fg = lab == (1 + int(np.argmax(sizes)))
    return fg.astype(np.float32) * 255.0


def cut_image_dir(indir: str, outdir: Optional[str] = None,
                  cameras: int = 10, threshold: float = 0.4, *,
                  device="cuda") -> None:
    """Directory driver (`CutImageDir.m:1-27`): a background model per
    camera (the mean of its frames), then per-frame masks into mask/."""
    from reconstruction_tpu_torch.io.images import imread, imwrite
    outdir = outdir or os.path.join(indir, "mask")
    os.makedirs(outdir, exist_ok=True)
    files = sorted(os.listdir(indir))
    for cam in range(cameras):
        cam_files = [f for f in files if f.endswith(f"_Cam{cam}.jpg")]
        if not cam_files:
            continue
        imgs = [imread(os.path.join(indir, f)) for f in cam_files]
        bg = np.mean(imgs, axis=0)
        for f, img in zip(cam_files, imgs):
            mask = segment_frame(img, bg, threshold, device=device)
            imwrite(os.path.join(outdir, f), mask)
