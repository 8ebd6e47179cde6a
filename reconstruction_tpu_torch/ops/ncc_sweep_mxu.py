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
on the card the kernel's prep pass flags any value off that grid and the
wrapper raises; on the CPU the wrapper tests the images first.

On the card a call is two launches and one read-back: a prep pass packs
the images as int8x4 words and reduces the shift range on the device,
then the sweep multiplies with `mma.sync` (one k32 step per window row,
`mma_operands_plain` builds the same operands) and scores on the
accumulator registers.  `shift_range` is the range's plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.ops.ncc_sweep import (SWEEP_RADII, _dispatch,
                                                    _require_cuda, check_off_grid,
                                                    sweep_shifts_plain)
from reconstruction_tpu_torch.stereo.ncc import shifted
from reconstruction_tpu_torch.stereo.matching import (SweepResult, _centered,
                                                      sweep_moments)

CHUNK = 128   # shifts per chunk (the TPU kernel's x-tile width XT)
MMA_WORDS = 8   # int8x4 words of one m16n8k32 k-step: one window row
KERNELS_PER_CALL = 2   # prep and sweep; `ncc_sweep_mxu.launches` counts calls
_LAYOUT_KEYS = ("scratch_bytes", "warp_rows", "warp_pixels", "tile", "block_rows",
                "block_pixels", "groups", "targets_staged", "max_width")

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


def _words(img: torch.Tensor) -> torch.Tensor:
    """An (H, W, C <= 4) image on the integer grid as its int8x4 words, one
    word a pixel, each as its 4 bytes (channels zero padded): (H, W, 4)
    int64."""
    w = torch.round(img).to(torch.int64)
    return F.pad(w, (0, 4 - w.shape[-1]))


def mma_operands_plain(L: torch.Tensor, R: torch.Tensor, radius: int,
                       shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep kernel's `mma.sync` operands for the pairs (x, x + shift),
    as plain tensors: A and B, each (H, W, 2r+1, 32) int64, one k32 step
    (MMA_WORDS words of 4 bytes) per window row dy.  A's word q of pixel x
    is L's word at (y + dy - r, x - r + q) for q < 2r+1 and zero past the
    window; B's word q is R's word at (y + dy - r, x + shift - r + q) for
    every q, past the window too (the neighbouring pixels, raw, as the
    kernel reads them from its slab); both zero outside the image."""
    wL, wR = _words(L), _words(R)
    d = 2 * radius + 1
    A, B = [], []
    for dy in range(d):
        A.append(torch.cat([shifted(wL, dy - radius, q - radius) if q < d
                            else torch.zeros_like(wL) for q in range(MMA_WORDS)], -1))
        B.append(torch.cat([shifted(wR, dy - radius, shift + q - radius)
                            for q in range(MMA_WORDS)], -1))
    return torch.stack(A, 2), torch.stack(B, 2)


def mma_cross_plain(L: torch.Tensor, R: torch.Tensor, radius: int,
                    shift: int) -> torch.Tensor:
    """The window cross sums of the pairs (x, x + shift) as the kernel's
    integer product of its operands: (H, W) int64."""
    A, B = mma_operands_plain(L, R, radius, shift)
    return (A * B).sum((-1, -2))


def layout(H: int, W: int) -> dict:
    """The sweep kernel's geometry and the scratch bytes of an H x W call, as
    `csrc/ncc_sweep_mxu.cu` defines them (`rtt_ncc_sweep_mxu_layout`; needs
    the built kernels)."""
    out = (ctypes.c_longlong * len(_LAYOUT_KEYS))()
    _build.check(_build.load().rtt_ncc_sweep_mxu_layout(H, W, out),
                 "rtt_ncc_sweep_mxu_layout")
    return dict(zip(_LAYOUT_KEYS, out))


def mma_plan(active, lo, hi, radius: int, pad_shift: int = 128,
             s_min: Optional[int] = None, s_max: Optional[int] = None) -> dict:
    """What the sweep kernel does on these bounds, by its own rule and with
    its geometry (`layout`).  Each block stages its targets [Ta, Tb]: its
    active pixels' bounds in the image, within its columns' shift range, in
    chunks of `targets_staged` (each group of pixels again when there is
    more than one); each warp runs the tiles, aligned to Ta, from its
    pixels' least target to their greatest, every pixel of the warp against
    every target of a tile.  Returns the useful pairs (what the sweep
    scores), the evaluated ones, and the words it copies from device memory
    per pixel: R's (rows +-r, a target's window columns past it), the target
    moments' (two words each) and L's (rows +-r, columns +-r)."""
    H, W = lo.shape
    g = layout(H, W)
    start, count = shift_range(active, lo, hi, pad_shift, s_min, s_max).tolist()
    end = start + CHUNK * -(-count // CHUNK) - 1
    x = torch.arange(W, dtype=torch.int64, device=lo.device)[None, :]
    a0, b0 = lo.long().clamp(min=0), hi.long().clamp(max=W - 1)
    a, b = torch.maximum(a0, x + start), torch.minimum(b0, x + end)
    act = active & (a <= b)
    useful = int(torch.where(act, b - a + 1, 0).sum())
    big = 1 << 40
    by, bx = g["block_rows"], g["block_pixels"]
    wy, wx, tile, tch = g["warp_rows"], g["warp_pixels"], g["tile"], g["targets_staged"]
    ph, pw = -H % by, -W % bx
    pad = lambda m, v: F.pad(m, (0, pw, 0, ph), value=v)
    Hp, Wp = H + ph, W + pw
    blocks = lambda m: m.reshape(Hp // by, by, Wp // bx, bx)
    warps = lambda m: m.reshape(Hp // wy, wy, Wp // wx, wx)
    # A block's targets: its active pixels' bounds in the image (the prep
    # pass's reduction), within its first and last columns' range.
    inb = active & (a0 <= b0)
    xb = torch.arange(0, Wp, bx, device=lo.device)[None, :]
    ta = torch.maximum(blocks(pad(torch.where(inb, a0, big), big)).amin((1, 3)), xb + start)
    tb = torch.minimum(blocks(pad(torch.where(inb, b0, -big), -big)).amax((1, 3)),
                       xb + bx - 1 + end)
    n = (tb - ta + 1).clamp_min(0)
    chunks = torch.div(n + tch - 1, tch, rounding_mode="floor")
    copies = torch.where(chunks > 1, g["groups"], 1)   # each group restages its chunks
    sr = by + 2 * radius
    r_words = int((copies * sr * (n + chunks * (MMA_WORDS - 1))).sum())
    moments = int((copies * 2 * by * n).sum())
    l_words = int((n > 0).sum()) * sr * (bx + 2 * radius)
    a, b = pad(torch.where(act, a, big), big), pad(torch.where(act, b, -big), -big)
    wa, wb = warps(a).amin((1, 3)), warps(b).amax((1, 3))
    ta = ta.repeat_interleave(by // wy, 0).repeat_interleave(bx // wx, 1)
    tiles = torch.where(wa <= wb, torch.div(wb - ta, tile, rounding_mode="floor")
                        - torch.div(wa - ta, tile, rounding_mode="floor") + 1, 0)
    evaluated = int(tiles.sum()) * tile * wx * wy
    px = H * W
    return dict(useful=useful, evaluated=evaluated, r_word_fetches=r_words / px,
                moment_fetches=moments / px, l_word_fetches=l_words / px)


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
    lay = layout(H, W)
    if not (1 <= C <= 4 and radius in SWEEP_RADII and 0 < pad_shift <= 1 << 24
            and W <= lay["max_width"]):
        raise ValueError(f"ncc_sweep_mxu: {C} channels, radius {radius}, pad_shift "
                         f"{pad_shift}, width {W}; the kernel takes 1..4 channels, "
                         f"radii {SWEEP_RADII}, pad_shift 1..2^24 and widths up to "
                         f"{lay['max_width']}")
    fixed = s_min is not None and s_max is not None
    fmin = min(max(int(s_min), -pad_shift), pad_shift - 1) if fixed else 0
    fmax = min(max(int(s_max), -pad_shift), pad_shift) if fixed else 0
    # One scratch allocation: the state the kernels reduce into (the
    # off-grid flag, the shift range, each sweep block's targets; zeroed by
    # the entry point) and the prep pass's packed maps.
    nbytes = lay["scratch_bytes"]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    score = torch.empty((H, W), dtype=f32, device=dev)
    t = torch.empty((H, W), dtype=i32, device=dev)
    _build.launch("rtt_ncc_sweep_mxu", *[a.data_ptr() for a in (
        L, R, nmuL, invL, muR, invR, validR, active, lo, hi, scratch, score, t)],
        H, W, C, radius, pad_shift, int(fixed), fmin, fmax, nbytes)
    ncc_sweep_mxu.launches += 1
    check_off_grid("ncc_sweep_mxu", scratch[:4].view(i32))
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
