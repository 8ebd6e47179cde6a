"""K2 (Jacobi sweeps of the subpixel refine, several per launch): the
wrapper of `csrc/refine.cu` beside its plain PyTorch version, and the
sweep loop with the reference's window re-extraction.

The reference reads its three parabola taps from a 32-slot window of the
banded cost volume, frozen at the anchors of the last extraction (the
TPU could not afford a per-pixel gather).  Here the window is only a
pair of per-pixel integers: ``j0``, the volume slot of window slot 0,
and ``jref``, the anchor trunc(d - 1.5) at extraction.  A tap at window
slot jj reads cv[y, j0 + jj, x] when 0 <= jj < 32 and the slot lies in
the volume, and the neutral 0.5 otherwise, which is exactly what the
reference's select chain returns.  The volume is slot-major,
(H, s_cap, W), so that neighbouring pixels' taps lie side by side.  It is
float32, or bfloat16 (the reference's `cv_dtype="bfloat16"` window: the
taps are widened to float32 exactly before any arithmetic).
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.ops.ncc_sweep import _dispatch, _require_cuda
from reconstruction_tpu_torch.stereo.ncc import shifted
from reconstruction_tpu_torch.utils.fp import exp_xla, fma32

MINI = 32     # window slots (the reference's mini volume)
CENTER = 16   # window slot of the center candidate at extraction
SWEEPS_PER_LAUNCH = 6   # T: sweeps a K2 launch runs (measured on the H100)
# The volume's element types, each with K2's C entry.
SWEEP_ENTRIES = {torch.float32: "rtt_refine_sweeps",
                 torch.bfloat16: "rtt_refine_sweeps_bf16"}


def window_anchors(d: torch.Tensor, base: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(j0, jref) of the window extracted at d's anchors; base: (H,) int32
    per-row slot base of the banded volume."""
    c00 = torch.trunc(d - 1.5)
    j0 = (c00.to(torch.int32) + 2) - base[:, None] - CENTER
    return j0.to(torch.int32).contiguous(), c00.contiguous()


def refine_sweep_plain(d, cv, j0, jref, inner, ws: float) -> torch.Tensor:
    """One sweep in plain PyTorch: the reference's `_refine_math` over
    taps read by direct index, rounded as the reference compiles it (its
    exp, and a fused multiply-add in each of the two blend numerators).
    Taps of a bfloat16 volume are widened to float32 (exactly) first."""
    S = cv.shape[1]
    nm = float(NOMATCH)
    dN = shifted(d, -1, 0, fill=nm)
    dS = shifted(d, 1, 0, fill=nm)
    dW = shifted(d, 0, -1, fill=nm)
    dE = shifted(d, 0, 1, fill=nm)
    mode_x = (dE != nm) & (dW != nm)
    mode_y = (dS != nm) & (dN != nm)
    c0 = torch.trunc(d - 1.5)
    j = (CENTER + (c0 - jref)).to(torch.int32)
    half = torch.full_like(d, 0.5)
    taps = []
    for off in (-1, 0, 1):
        jj = j + off
        k = j0 + jj
        ok = (jj >= 0) & (jj < MINI) & (k >= 0) & (k < S)
        v = torch.gather(cv, 1, k.clamp(0, S - 1).long()[:, None])[:, 0].float()
        taps.append(torch.where(ok, v, half))
    xi0, xi1, xi2 = taps

    idx = (xi0 >= xi1).to(torch.int32)
    xi_at = torch.where(idx == 0, xi0, xi1)
    idx = torch.where(xi_at > xi2, 2, idx)
    denom = (xi0 + xi2) - 2.0 * xi1
    pwp1 = 0.5 * (xi0 + xi2) - xi1
    one = torch.ones_like(d)
    pdp1 = d + (0.5 * (xi0 - xi2)) / torch.where(denom == 0, one, denom)
    pdp1 = torch.where(pwp1 == 0, torch.zeros_like(d), pdp1)
    pwp = torch.where(idx == 0, xi1 - xi0,
                      torch.where(idx == 1, pwp1, xi1 - xi2))
    pdp = torch.where(idx == 0, d - 0.5, torch.where(idx == 1, pdp1, d + 0.5))
    ax = (dE - d).abs() - (dW - d).abs()
    ay = (dS - d).abs() - (dN - d).abs()
    ex = exp_xla(-(ax * ax))
    ey = exp_xla(-(ay * ay))
    wsum = ex + ey
    ds_both = torch.where(
        wsum == 0, (((dE + dW) + dS) + dN) * 0.25,
        fma32(ex, dE + dW, ey * (dN + dS)) / (2.0 * torch.where(wsum == 0, one, wsum)))
    dsv = torch.where(mode_x & mode_y, ds_both,
                      torch.where(mode_x, (dE + dW) * 0.5, (dN + dS) * 0.5))
    blended = fma32(ws, dsv, pdp * pwp) / (pwp + ws)
    new_d = torch.where(mode_x | mode_y, blended, d)
    return torch.where((d != nm) & inner, new_d, d)


def refine_sweeps_fused_plain(d, cv, j0, jref, inner, ws: float,
                              n: int) -> torch.Tensor:
    """n plain sweeps with one window."""
    for _ in range(n):
        d = refine_sweep_plain(d, cv, j0, jref, inner, ws)
    return d


def refine_sweeps_fused(d, cv, j0, jref, inner, ws: float, n: int
                        ) -> torch.Tensor:
    """n sweeps with one window: K2 on CUDA tensors, ceil(n / T) launches of
    at most T = SWEEPS_PER_LAUNCH sweeps each; the plain sweeps on CPU
    tensors.

    d: (H, W) f32; cv: (H, s_cap, W) f32 or bf16 (K2's instance for each,
    its launches counted by C entry in ``launches``); j0: (H, W) int32;
    jref: (H, W) f32; inner: (H, W) bool (valid pixels here update).
    Returns the new (H, W) disparity (d itself when n is 0)."""
    if cv.dtype not in SWEEP_ENTRIES:
        raise TypeError(f"refine_sweeps_fused: a {cv.dtype} volume; the kernel "
                        f"reads {list(SWEEP_ENTRIES)}")
    if _dispatch(d):
        return refine_sweeps_fused_plain(d, cv, j0, jref, inner, ws, n)
    H, W = d.shape
    S = cv.shape[1]
    dev = _require_cuda("refine_sweeps_fused", [
        (d, torch.float32, (H, W)), (cv, cv.dtype, (H, S, W)),
        (j0, torch.int32, (H, W)), (jref, torch.float32, (H, W)),
        (inner, torch.bool, (H, W))])
    bufs = [torch.empty((H, W), dtype=torch.float32, device=dev)
            for _ in range(min(n, 2))]
    done = 0
    while done < n:
        k = min(SWEEPS_PER_LAUNCH, n - done)
        out = bufs[(done // SWEEPS_PER_LAUNCH) % 2]    # never the buffer it reads
        entry = SWEEP_ENTRIES[cv.dtype]
        _build.launch(entry, *[a.data_ptr() for a in (
            d, out, cv, j0, jref, inner)], float(ws), H, W, S, k)
        refine_sweeps_fused.launches[entry] += 1
        d = out
        done += k
    return d


refine_sweeps_fused.launches = collections.Counter()   # by C entry


def refine_sweep(d, cv, j0, jref, inner, ws: float) -> torch.Tensor:
    """One sweep: `refine_sweeps_fused` with n = 1 (one K2 launch on CUDA
    tensors, counted there)."""
    return refine_sweeps_fused(d, cv, j0, jref, inner, ws, 1)


def refine_sweeps(d: torch.Tensor, cv: torch.Tensor, base: torch.Tensor,
                  inner: torch.Tensor, iterations: int, ws: float,
                  recenter_every: int) -> torch.Tensor:
    """``iterations`` sweeps; the window is extracted at the start and
    again every ``recenter_every`` sweeps (0: never), as the reference
    chunks its scan."""
    d = d.contiguous()
    inner = inner.contiguous()
    chunk = recenter_every if recenter_every > 0 else iterations
    done = 0
    while done < iterations:
        j0, jref = window_anchors(d, base)
        n = min(chunk, iterations - done)
        d = refine_sweeps_fused(d, cv, j0, jref, inner, ws, n)
        done += n
    return d
