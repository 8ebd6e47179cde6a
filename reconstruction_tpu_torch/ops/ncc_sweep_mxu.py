"""K5 (the NCC shift sweep on the tensor cores): the wrapper of
`csrc/ncc_sweep_mxu.cu` beside its plain PyTorch version, and the entry
point `ncc_sweep_match_mxu` (counterpart of
`reconstruction_tpu/ops/ncc_sweep_mxu.py`).

K5 computes the function of K1 (`ops/ncc_sweep.ncc_sweep`) with the
TPU kernel's contract: one shift range for the whole image, from the
active pixels' bounds clipped to [-pad_shift, pad_shift - 1] (start) and
[-pad_shift, pad_shift] (end), visited in chunks of 128 shifts in
ascending order from its start (the last chunk runs to its full width),
each pixel gated by its own bounds, the first maximum winning.  The
window dot products run on int8 operands with int32 sums, which is exact
only for images on the integer grid [-128, 127] (centered uint8 values):
on the card the kernel flags any value it reads off that grid and the
wrapper raises; on the CPU the wrapper tests the images first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.ops.ncc_sweep import (_dispatch, _require_cuda,
                                                    check_off_grid,
                                                    sweep_shifts_plain)
from reconstruction_tpu_torch.stereo.matching import (SweepResult, _centered,
                                                      sweep_moments)

CHUNK = 128   # shifts per chunk (the TPU kernel's x-tile width XT)


def shift_range(active: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                pad_shift: int, s_min: Optional[int] = None,
                s_max: Optional[int] = None) -> torch.Tensor:
    """int32 [start, count] of the sweep's shift range on the inputs'
    device (no host synchronisation): from the active pixels' bounds
    unless given, clipped as the TPU kernel clips."""
    dev = lo.device
    if s_min is None or s_max is None:
        W = lo.shape[1]
        x = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        big = torch.tensor(1 << 20, dtype=torch.int32, device=dev)
        any_active = active.any()
        s_min = torch.where(any_active, torch.where(active, lo - x, big).min(), 0)
        s_max = torch.where(any_active, torch.where(active, hi - x, -big).max(), -1)
    s_min = torch.as_tensor(s_min, dtype=torch.int32, device=dev).clamp(
        -pad_shift, pad_shift - 1)
    s_max = torch.as_tensor(s_max, dtype=torch.int32, device=dev).clamp(
        -pad_shift, pad_shift)
    count = (s_max - s_min + 1).clamp_min(0)
    return torch.stack([s_min, count]).to(torch.int32).contiguous()


def _check_integer_grid(*imgs) -> None:
    for img in imgs:
        if not bool(((img == torch.round(img)) & (img >= -128)
                     & (img <= 127)).all()):
            raise ValueError("ncc_sweep_mxu: images must be centered uint8 "
                             "values (integers in [-128, 127]); the int8 "
                             "tensor-core sums are exact only there")


def ncc_sweep_mxu_plain(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                        radius: int, pad_shift: int = 128,
                        s_min: Optional[int] = None,
                        s_max: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain sweep over the shifts K5 visits."""
    start, count = shift_range(active, lo, hi, pad_shift, s_min,
                               s_max).tolist()
    n_chunks = -(-count // CHUNK)
    return sweep_shifts_plain(L, R, nmuL, invL, muR, invR, validR, active,
                              lo, hi, radius, start,
                              start + CHUNK * n_chunks - 1)


def ncc_sweep_mxu(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                  radius: int, pad_shift: int = 128,
                  s_min: Optional[int] = None, s_max: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors, its plain version on CPU tensors.

    The arguments of `ops/ncc_sweep.ncc_sweep` (L, R: (H, W, C) f32
    centered integer images; nmuL = n * mean of L's windows, invL, muR,
    invR: (H, W) f32; validR, active: (H, W) bool; lo, hi: (H, W) int32
    absolute target-column bounds), plus pad_shift and an optional fixed
    shift range.  Returns (best score (H, W) f32, best target column
    (H, W) int32, -1 where nothing scored above -1)."""
    if _dispatch(L):
        _check_integer_grid(L, R)
        return ncc_sweep_mxu_plain(L, R, nmuL, invL, muR, invR, validR,
                                   active, lo, hi, radius, pad_shift, s_min,
                                   s_max)
    H, W, C = L.shape
    f32, i32 = torch.float32, torch.int32
    dev = _require_cuda("ncc_sweep_mxu", [
        (L, f32, (H, W, C)), (R, f32, (H, W, C)), (nmuL, f32, (H, W)),
        (invL, f32, (H, W)), (muR, f32, (H, W)), (invR, f32, (H, W)),
        (validR, torch.bool, (H, W)), (active, torch.bool, (H, W)),
        (lo, i32, (H, W)), (hi, i32, (H, W))])
    srange = shift_range(active, lo, hi, pad_shift, s_min, s_max)
    score = torch.empty((H, W), dtype=f32, device=dev)
    t = torch.empty((H, W), dtype=i32, device=dev)
    off_grid = torch.zeros(1, dtype=i32, device=dev)
    _build.launch("rtt_ncc_sweep_mxu", *[a.data_ptr() for a in (
        L, R, nmuL, invL, muR, invR, validR, active, lo, hi, srange, score,
        t, off_grid)], H, W, C, radius)
    ncc_sweep_mxu.launches += 1
    check_off_grid("ncc_sweep_mxu", off_grid)
    return score, t


ncc_sweep_mxu.launches = 0


def ncc_sweep_match_mxu(
    imgL: torch.Tensor,
    imgR: torch.Tensor,
    validR: torch.Tensor,
    active: torch.Tensor,
    bound_lo: torch.Tensor,
    bound_hi: torch.Tensor,
    radius: int,
    s_min: Optional[int] = None,
    s_max: Optional[int] = None,
    pad_shift: int = 128,
) -> SweepResult:
    """Tensor-core alternative to `stereo/matching.ncc_sweep_match` for
    shift ranges within +-pad_shift: images (H, W, C) or (H, W) on the
    uint8 grid; the same result wherever the range is not clipped."""
    W = imgL.shape[1]
    L, R = _centered(imgL), _centered(imgR)
    score, best_t = ncc_sweep_mxu(
        L, R, *sweep_moments(L, R, radius),
        validR.bool().contiguous(), active.bool().contiguous(),
        bound_lo.to(torch.int32).contiguous(),
        bound_hi.to(torch.int32).contiguous(), radius, pad_shift, s_min, s_max)
    x = torch.arange(W, dtype=torch.int32, device=L.device)[None, :]
    disp = torch.where(best_t >= 0, (best_t - x).float(),
                       torch.tensor(float(NOMATCH), device=L.device))
    return SweepResult(disparity=disp, score=score)
