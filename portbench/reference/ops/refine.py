"""Plain PyTorch refine sweeps (a frozen copy of the port's plain
versions of its sweep kernel, with the sweep driver)."""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.config import NOMATCH
from portbench.reference.stereo.ncc import shifted
from portbench.reference.utils.fp import exp_xla, fma32


MINI = 32     # window slots (the reference's mini volume)



CENTER = 16   # window slot of the center candidate at extraction



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
    exp, and a fused multiply-add in each of the two blend numerators)."""
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



refine_sweeps_fused = refine_sweeps_fused_plain
