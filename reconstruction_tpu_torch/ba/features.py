"""Feature detection and description for the BA front end (counterpart of
`reconstruction_tpu/ba/features.py`): Harris corners with per-cell
non-maximum suppression and a fixed-capacity top K, and zero-mean
normalized window descriptors (`stereo/ncc.window_descriptors`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from reconstruction_tpu_torch.stereo.ncc import shifted, window_descriptors


class Features(NamedTuple):
    xy: torch.Tensor      # (N, 2) float32 pixel coords (x, y)
    score: torch.Tensor   # (N,) Harris response
    ok: torch.Tensor      # (N,) bool, False on padding


def _gauss_blur(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur, zero-padded, taps in ascending offset."""
    r = max(1, int(3 * sigma))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device) / sigma
    k = torch.exp(-0.5 * t ** 2)
    k = k / k.sum()
    out = k[0] * shifted(x, 0, -r)
    for i in range(-r + 1, r + 1):
        out = out + k[i + r] * shifted(x, 0, i)
    acc = out
    out = k[0] * shifted(acc, -r, 0)
    for i in range(-r + 1, r + 1):
        out = out + k[i + r] * shifted(acc, i, 0)
    return out


def harris_corners(
    gray: torch.Tensor,
    valid: torch.Tensor,
    max_features: int = 1024,
    k: float = 0.04,
    nms_cell: int = 8,
) -> Features:
    """Harris response, the maximum of each nms_cell^2 cell, then the
    max_features strongest cells (fixed capacity; ties keep the lower cell
    index first, as the reference's top_k).  ok marks finite responses > 0."""
    H, W = gray.shape
    g = gray.float()
    ix = 0.5 * (shifted(g, 0, 1) - shifted(g, 0, -1))
    iy = 0.5 * (shifted(g, 1, 0) - shifted(g, -1, 0))
    sxx = _gauss_blur(ix * ix)
    syy = _gauss_blur(iy * iy)
    sxy = _gauss_blur(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    R = det - k * tr * tr
    R = torch.where(valid, R, torch.tensor(float("-inf"), device=R.device))

    Hc, Wc = H // nms_cell, W // nms_cell
    Rc = R[:Hc * nms_cell, :Wc * nms_cell].reshape(
        Hc, nms_cell, Wc, nms_cell).permute(0, 2, 1, 3).reshape(
        Hc, Wc, nms_cell * nms_cell)
    best, arg = Rc.max(dim=-1)           # the first maximum of each cell
    cy = torch.arange(Hc, device=R.device)[:, None] * nms_cell + arg // nms_cell
    cx = torch.arange(Wc, device=R.device)[None, :] * nms_cell + arg % nms_cell

    flat_score = best.reshape(-1)
    kk = min(max_features, flat_score.shape[0])
    top, idx = torch.sort(flat_score, descending=True, stable=True)
    top, idx = top[:kk], idx[:kk]
    xy = torch.stack([cx.reshape(-1)[idx], cy.reshape(-1)[idx]], dim=1).float()
    ok = torch.isfinite(top) & (top > 0)
    n_pad = max_features - kk
    if n_pad:
        xy = torch.cat([xy, xy.new_zeros((n_pad, 2))])
        top = torch.cat([top, top.new_zeros(n_pad)])
        ok = torch.cat([ok, ok.new_zeros(n_pad)])
    return Features(xy=xy, score=top, ok=ok)


def describe(img: torch.Tensor, feats: Features, radius: int = 4) -> torch.Tensor:
    """Normalized window descriptors at the feature locations, (N, K)."""
    desc_map, _ = window_descriptors(img if img.ndim == 3 else img[..., None],
                                     radius)
    xi = feats.xy[:, 0].to(torch.int64).clamp(0, desc_map.shape[1] - 1)
    yi = feats.xy[:, 1].to(torch.int64).clamp(0, desc_map.shape[0] - 1)
    return desc_map[yi, xi]
