"""Iterative subpixel photometric disparity refinement, the Beeler-2010
core loop (counterpart of `reconstruction_tpu/stereo/refine.py`).

The 3x3 NCC cost of every pixel at every shift near its band's
disparities is built once into a banded cost volume (kernel K3), then
30 + 30*level Jacobi sweeps read three costs per pixel from it (kernel
K2), blending the parabolic subpixel estimate with an anisotropic
neighbour average.  Semantics are the reference's mini-CV path
(`_refine_minicv`): costs come from a 32-slot window frozen at the last
extraction, re-extracted once mid-run by default.  The volume is
float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from portbench.reference.config import NOMATCH
from portbench.reference.ops.ncc_sweep import cost_volume
from portbench.reference.ops.refine import refine_sweeps
from portbench.reference.stereo.margins import Margins, inner_box
from portbench.reference.stereo.matching import _centered, ncc_moments

def _band_ranges(disp: torch.Tensor, s_cap: int, band: int, drift: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per band: slot base centered on its disparity range, and the filled
    shift range [lo_b, hi_b] (the band's range plus the drift margin)."""
    H, W = disp.shape
    nb = -(-H // band)
    dp = F.pad(disp, (0, 0, 0, nb * band - H), value=float(NOMATCH))
    db = dp.reshape(nb, band * W)
    vb = db != NOMATCH
    big = torch.tensor(1e9, dtype=torch.float32, device=disp.device)
    bmin = torch.where(vb, db, big).min(dim=1).values
    bmax = torch.where(vb, db, -big).max(dim=1).values
    has = bmin <= bmax
    mid = torch.where(has, (bmin + bmax) * 0.5, torch.zeros_like(bmin))
    base_b = torch.round(mid).to(torch.int32) - s_cap // 2
    lo_need = torch.round(bmin).to(torch.int32) - 2 - drift
    hi_need = torch.round(bmax).to(torch.int32) + 3 + drift
    lo_b = torch.maximum(base_b, lo_need)
    hi_b = torch.minimum(base_b + s_cap - 1, hi_need)
    lo_b = torch.where(has, lo_b.clamp(-(W - 1), W - 1), 0)
    hi_b = torch.where(has, hi_b.clamp(-(W - 1), W - 1), -1)
    return base_b, lo_b.to(torch.int32), hi_b.to(torch.int32)


def _banded_cost_volume(
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    disp: torch.Tensor,
    s_cap: int,
    band: int,
    drift: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """xi(y, j, x) = (1 - NCC3x3(x, x + base(y) + j)) / 2 for j < s_cap,
    0.5 outside each band's filled range.  Returns (cv (H, s_cap, W),
    slot-major, the reference's volume with its last two axes swapped;
    base (H,) int32)."""
    H, W = disp.shape
    base_b, lo_b, hi_b = _band_ranges(disp.float(), s_cap, band, drift)
    cv = band_volume(imgL, imgR, base_b, lo_b, hi_b, s_cap, band)
    base = base_b.repeat_interleave(band)[:H]
    return cv, base


def band_volume(imgL: torch.Tensor, imgR: torch.Tensor, base_b: torch.Tensor,
                lo_b: torch.Tensor, hi_b: torch.Tensor, s_cap: int,
                band: int) -> torch.Tensor:
    """The cost volume (K3) of the images' rows for the given per-band
    slot bases and filled shift ranges (`_band_ranges`)."""
    return cost_volume(*volume_args(imgL, imgR, base_b, lo_b, hi_b, s_cap, band))


def volume_args(imgL: torch.Tensor, imgR: torch.Tensor, base_b: torch.Tensor,
                lo_b: torch.Tensor, hi_b: torch.Tensor, s_cap: int,
                band: int) -> tuple:
    """`cost_volume`'s positional arguments for `band_volume`: the centered
    images, their radius-1 moments and the band ranges."""
    L, R = _centered(imgL), _centered(imgR)
    momL = ncc_moments(L, 1)
    momR = ncc_moments(R, 1)
    return (L, R, (momL.n * momL.mean).contiguous(), momL.inv_norm.contiguous(),
            momR.mean.contiguous(), momR.inv_norm.contiguous(), base_b.contiguous(),
            lo_b.contiguous(), hi_b.contiguous(), s_cap, band)


def resolve_recenter(iterations: int, recenter_every: int, t: int = 6) -> int:
    """-1 (auto) = one mid-run window re-extraction, rounded up to a
    multiple of ``t`` (the reference's T-segment alignment, kept so that
    the re-extraction happens at the same sweep); 0 = never; k > 0 =
    every k sweeps."""
    if recenter_every == -1:
        half = -(-max(iterations // 2, 1) // t) * t
        return half if half < iterations else 0
    return recenter_every


def disparity_refine(
    disp: torch.Tensor,
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    m: Margins,
    iterations: int,
    ws: float = 0.03,
    s_cap: int = 128,
    band: int = 64,
    drift: int = 16,
    recenter_every: int = 0,
) -> torch.Tensor:
    """Run the refinement loop; returns float32 disparity.  NOMATCH pixels
    and pixels outside the margin box inset by one never change."""
    recenter_every = resolve_recenter(iterations, recenter_every)
    H, W = disp.shape
    band = min(band, H)
    disp = disp.float()
    cv, base = _banded_cost_volume(imgL, imgR, disp, s_cap, band, drift=drift)
    inner = inner_box(m, H, W, inset=1)
    return refine_sweeps(disp, cv, base, inner, iterations, ws, recenter_every)
