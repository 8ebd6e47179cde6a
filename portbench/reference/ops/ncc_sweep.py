"""Plain PyTorch sweeps of the pair path: the NCC shift sweep with a
running argmax and the banded 3x3 cost volume (a frozen copy of the port's
plain versions; the benchmark's reference runs them where the port runs its
kernels)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from portbench.reference.stereo.ncc import shifted
from portbench.reference.utils.fp import fma32


def box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable (2r+1)^2 zero-padded box sum, in the reference's order:
    x, +x[.+d], +x[.-d] along columns, then the same along rows."""
    out = x
    for d in range(1, radius + 1):
        out = out + shifted(x, 0, d) + shifted(x, 0, -d)
    acc = out
    for d in range(1, radius + 1):
        out = out + shifted(acc, d, 0) + shifted(acc, -d, 0)
    return out



def _channel_dot(L: torch.Tensor, Rs: torch.Tensor) -> torch.Tensor:
    """sum_c L*R, channel 0 first (the kernels' order)."""
    acc = L[..., 0] * Rs[..., 0]
    for c in range(1, L.shape[-1]):
        acc = acc + L[..., c] * Rs[..., c]
    return acc



def ncc_sweep_plain(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                    radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch sweep over the shifts of all active pixels' bounds
    (the reference's unbanded `ncc_sweep_match` loop).

    Returns (best score (H, W) f32, best target column (H, W) int32, -1
    where nothing scored above -1)."""
    W = L.shape[1]
    if not bool(active.any()):
        s_min, s_max = 0, -1
    else:
        x = torch.arange(W, dtype=torch.int32, device=L.device)[None, :]
        s_min = int(torch.where(active, lo - x, 1 << 20).min())
        s_max = int(torch.where(active, hi - x, -(1 << 20)).max())
    return sweep_shifts_plain(L, R, nmuL, invL, muR, invR, validR, active,
                              lo, hi, radius, s_min, s_max)



def sweep_shifts_plain(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                       radius: int, s_min: int, s_max: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain sweep over the shifts s_min..s_max (ascending, clipped to
    +-(W-1)), each pixel gated by its own bounds."""
    H, W, C = L.shape
    dev = L.device
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    best = torch.full((H, W), -1.0, dtype=torch.float32, device=dev)
    bt = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    s_min = min(max(s_min, -(W - 1)), W - 1)
    s_max = min(max(s_max, -(W - 1)), W - 1)
    Rp = F.pad(R, (0, 0, W, W))
    muRp = F.pad(muR, (W, W))
    invRp = F.pad(invR, (W, W), value=1.0)
    vRp = F.pad(validR.to(torch.uint8), (W, W))
    for s in range(s_min, s_max + 1):
        cols = slice(W + s, 2 * W + s)
        cross = box_sum(_channel_dot(L, Rp[:, cols]), radius)
        sc = fma32(-nmuL, muRp[:, cols], cross) * invL * invRp[:, cols]
        t = x + s
        ok = active & (vRp[:, cols] != 0) & (t >= lo) & (t <= hi)
        sc = torch.where(ok, sc, -2.0)
        upd = sc > best
        best = torch.where(upd, sc, best)
        bt = torch.where(upd, t, bt)
    return best, bt



def cost_volume_plain(L, R, nmuL, invL, muR, invR, base_b, lo_b, hi_b,
                      s_cap: int, band: int) -> torch.Tensor:
    """Plain PyTorch banded 3x3 cost volume.

    cv[y, j, x] = (1 - NCC3x3(x, x + s)) / 2 for s = base_b[y // band] + j
    inside [lo_b, hi_b] of that band, 0.5 elsewhere.  Shifts are written in
    ascending order at slot clamp(s - base, 0, s_cap - 1), as the
    reference's clamped `dynamic_update_slice`: a band whose range lies
    wholly past its slots (|disparity| beyond the image width) leaves its
    last shift in the edge slot."""
    H, W, C = L.shape
    dev = L.device
    cv = torch.full((H, s_cap, W), 0.5, dtype=torch.float32, device=dev)
    rows = torch.arange(H, device=dev)
    base = base_b.long()[rows // band]
    lo = lo_b.long()[rows // band]
    hi = hi_b.long()[rows // band]
    if not bool((lo <= hi).any()):
        return cv
    s_lo = int(lo[lo <= hi].min())
    s_hi = int(hi[lo <= hi].max())
    Rp = F.pad(R, (0, 0, W, W))
    muRp = F.pad(muR, (W, W))
    invRp = F.pad(invR, (W, W), value=1.0)
    xs = torch.arange(W, device=dev)[None, :]
    for s in range(s_lo, s_hi + 1):
        sel = torch.nonzero((lo <= s) & (s <= hi)).flatten()
        if sel.numel() == 0:
            continue
        cols = slice(W + s, 2 * W + s)
        cross = box_sum(_channel_dot(L, Rp[:, cols]), 1)
        a = fma32(-nmuL, muRp[:, cols], cross) * invL
        xi = fma32(-(a * 0.5), invRp[:, cols], 0.5)
        slot = (s - base[sel]).clamp(0, s_cap - 1)
        cv[sel[:, None], slot[:, None], xs] = xi[sel]
    return cv



ncc_sweep = ncc_sweep_plain
cost_volume = cost_volume_plain
