"""Dense NCC matching: brute-force, coarse-guided and hole rematch
(counterpart of `reconstruction_tpu/stereo/matching.py`).

All three matchers reduce to one primitive, a sweep over uniform
epipolar shifts with a running argmax (`ncc_sweep_match`), which runs as
kernel K1 on the card (`ops/ncc_sweep.py`).  The reference's banded and
tiled sweeps are bit-equal to its unbanded one; K1 gets their economy
from sweeping each warp's own shift union, or only each pixel's own
targets, so the port has one sweep and no `band`, `tile` or `sblock`
knobs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops.ncc_sweep import box_sum as _box_sum
from reconstruction_tpu_torch.ops.ncc_sweep import ncc_sweep
from reconstruction_tpu_torch.stereo.margins import Margins
from reconstruction_tpu_torch.utils.fp import fma32, mul_recip


class NccMoments(NamedTuple):
    """Per-pixel window statistics for the box-filter NCC."""

    mean: torch.Tensor      # (H, W) window mean over (2r+1)^2 * C values
    inv_norm: torch.Tensor  # (H, W) 1 / ||window - mean|| (0 -> 1)
    n: int                  # number of values per window


def ncc_moments(img: torch.Tensor, radius: int) -> NccMoments:
    """Window mean and inverse norm maps for one image ((H, W, C) f32).

    Rounded as the reference compiles: mean = s1 * (1/n) and
    var = fma(-s1, mean, s2) (XLA folds n * (s1 * (1/n)) to s1)."""
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[-1]
    n = (2 * radius + 1) ** 2 * C
    s1 = _box_sum(img.sum(-1), radius)
    s2 = _box_sum((img * img).sum(-1), radius)
    mean = mul_recip(s1, n)
    var = torch.clamp_min(fma32(-s1, mean, s2), 0.0)
    # XLA turns 1/sqrt into rsqrt, which on the reference's inputs equals
    # float32 1/sqrt(var); torch.rsqrt rounds the same way on the CPU.  On
    # CUDA torch.rsqrt is the card's approximate rsqrtf, so the card takes
    # an IEEE sqrt and an IEEE divide instead.
    one = torch.ones_like(var)
    safe = torch.where(var == 0, one, var)
    inv_sqrt = 1.0 / torch.sqrt(safe) if safe.is_cuda else torch.rsqrt(safe)
    inv = torch.where(var == 0, one, inv_sqrt)
    return NccMoments(mean=mean, inv_norm=inv, n=n)


class SweepResult(NamedTuple):
    disparity: torch.Tensor  # (H, W) f32, NOMATCH where unmatched
    score: torch.Tensor      # (H, W) best NCC (-1 where none scored above it)


def _centered(img: torch.Tensor) -> torch.Tensor:
    img = img.float() - 128.0
    return (img if img.ndim == 3 else img[..., None]).contiguous()


def sweep_moments(L: torch.Tensor, R: torch.Tensor, radius: int):
    """The moment arguments of the sweep kernels for centered L, R:
    (n * L's window means, L's inverse norms, R's window means, R's
    inverse norms), contiguous (H, W) float32."""
    momL = ncc_moments(L, radius)
    momR = ncc_moments(R, radius)
    return ((momL.n * momL.mean).contiguous(), momL.inv_norm.contiguous(),
            momR.mean.contiguous(), momR.inv_norm.contiguous())


def ncc_sweep_match(
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    validR: torch.Tensor,
    active: torch.Tensor,
    bound_lo: torch.Tensor,
    bound_hi: torch.Tensor,
    radius: int,
) -> SweepResult:
    """Argmax-NCC match of active left pixels against target columns in
    [bound_lo, bound_hi] (absolute, inclusive, per pixel).

    imgL, imgR: (H, W, C) float32 on the uint8 grid; validR, active:
    (H, W) bool; bound_lo, bound_hi: (H, W) int32.  Returns disparity
    d = t - x (NOMATCH where unmatched) and the best score."""
    H, W = imgL.shape[:2]
    L, R = _centered(imgL), _centered(imgR)
    score, best_t = ncc_sweep(
        L, R, *sweep_moments(L, R, radius),
        validR.bool().contiguous(), active.bool().contiguous(),
        bound_lo.to(torch.int32).contiguous(),
        bound_hi.to(torch.int32).contiguous(), radius)
    x = torch.arange(W, dtype=torch.int32, device=L.device)[None, :]
    disp = torch.where(best_t >= 0, (best_t - x).float(),
                       torch.tensor(float(NOMATCH), device=L.device))
    return SweepResult(disparity=disp, score=score)


def _source_active(validL: torch.Tensor, mL: Margins) -> torch.Tensor:
    H, W = validL.shape
    y = torch.arange(H, dtype=torch.int32, device=validL.device)[:, None]
    x = torch.arange(W, dtype=torch.int32, device=validL.device)[None, :]
    return (validL & (y >= mL.YL) & (y <= mL.YR)
            & (x >= mL.XL) & (x <= mL.XR))


def brute_force_match(
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    validL: torch.Tensor,
    validR: torch.Tensor,
    mL: Margins,
    mR: Margins,
    radius: int,
) -> torch.Tensor:
    """Level-0 exhaustive scanline match: source pixels valid inside the
    source margins, candidates the target view's [XL, XR] span."""
    H, W = validL.shape
    active = _source_active(validL, mL)
    lo = mR.XL.to(torch.int32).expand(H, W).contiguous()
    hi = mR.XR.to(torch.int32).expand(H, W).contiguous()
    return ncc_sweep_match(imgL, imgR, validR, active, lo, hi, radius).disparity


def _forward_fill(values: torch.Tensor, known: torch.Tensor,
                  init: torch.Tensor) -> torch.Tensor:
    """Per-row forward fill along x: value of the latest known column,
    ``init`` before the first known one."""
    W = values.shape[-1]
    idx = torch.arange(W, dtype=torch.int32, device=values.device)[None, :]
    last = torch.cummax(torch.where(known, idx, -1), dim=1).values
    filled = torch.gather(values, 1, last.clamp_min(0).long())
    return torch.where(last >= 0, filled, init)


def guided_search_bounds(
    coarse_disp: torch.Tensor,
    mL: Margins,
    mR: Margins,
    H: int,
    W: int,
    offset: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel target-column bounds of `HighLevelInitialMatch`
    (`CStereoMatching.cpp:259-288`), as the reference computes them:
    valid coarse parents give [x + trunc(2d + 0.5) -+ offset]; holes keep
    the row's running left bound and derive the right bound from the next
    valid coarse disparity along the row."""
    dev = coarse_disp.device
    i32 = torch.int32
    Hc, Wc = coarse_disp.shape
    y = torch.arange(H, dtype=i32, device=dev)[:, None]
    x = torch.arange(W, dtype=i32, device=dev)[None, :]
    cy = torch.clamp((y + 1) // 2, 0, Hc - 1).long()
    cx = torch.clamp((x + 1) // 2, 0, Wc - 1).long()
    s_par = coarse_disp[cy, cx]
    par_valid = s_par != NOMATCH

    XL1 = mR.XL.to(i32)
    XR1 = mR.XR.to(i32)
    d2 = torch.trunc(s_par * 2.0 + 0.5).to(i32)
    lo_v = torch.maximum(x + d2 - offset, XL1)
    hi_v = torch.minimum(x + d2 + offset, XR1)

    ci = torch.arange(Wc, dtype=i32, device=dev)[None, :]
    cvalid = coarse_disp != NOMATCH
    nxt_rev = torch.cummax(
        torch.where(cvalid, Wc - 1 - ci, -1).flip(1), dim=1).values.flip(1)
    nxt = torch.where(nxt_rev >= 0, Wc - 1 - nxt_rev, Wc)
    nxt_after = torch.cat(
        [nxt[:, 1:], torch.full((Hc, 1), Wc, dtype=i32, device=dev)], dim=1)
    i_star = nxt_after[cy, cx]
    i_limit = torch.minimum(mL.XR.to(i32) >> 1, torch.tensor(Wc - 1, device=dev))
    la_exists = i_star <= i_limit
    d_next = torch.where(la_exists,
                         coarse_disp[cy, torch.clamp(i_star, 0, Wc - 1).long()],
                         torch.tensor(0.0, device=dev))
    hi_la = torch.minimum(
        i_star + torch.trunc(d_next * 2.0).to(i32) + offset + 1, XR1)

    in_row = x >= mL.XL
    full_xl = XL1.expand(H, W)
    full_xr = XR1.expand(H, W)
    lo = _forward_fill(torch.where(par_valid, lo_v, 0), par_valid & in_row,
                       full_xl)
    hi_known = (par_valid | la_exists) & in_row
    hi_candidate = torch.where(par_valid, hi_v, hi_la)
    hi = _forward_fill(hi_candidate, hi_known, full_xr)
    return lo.to(i32), hi.to(i32)


def guided_match(
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    validL: torch.Tensor,
    validR: torch.Tensor,
    coarse_disp: torch.Tensor,
    mL: Margins,
    mR: Margins,
    radius: int,
    offset: int = 2,
) -> torch.Tensor:
    """Coarse-to-fine guided match (`CStereoMatching.cpp:231-308`)."""
    H, W = validL.shape
    lo, hi = guided_search_bounds(coarse_disp, mL, mR, H, W, offset)
    active = _source_active(validL, mL)
    return ncc_sweep_match(imgL, imgR, validR, active, lo, hi,
                           radius).disparity


def rematch(
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    validL: torch.Tensor,
    validR: torch.Tensor,
    disparity: torch.Tensor,
    bound_lo: torch.Tensor,
    bound_hi: torch.Tensor,
    mL: Margins,
    radius: int,
) -> torch.Tensor:
    """Hole re-matching within propagated bounds: only NOMATCH pixels with
    a valid mask are re-scanned over [BL, BR]; matched pixels keep theirs."""
    active = _source_active(validL, mL) & (disparity == NOMATCH)
    res = ncc_sweep_match(imgL, imgR, validR, active,
                          bound_lo.to(torch.int32), bound_hi.to(torch.int32),
                          radius)
    return torch.where(active, res.disparity, disparity)
