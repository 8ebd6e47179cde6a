"""K1 (NCC shift sweep with running argmax) and K3 (banded 3x3 NCC cost
volume): the wrappers of `csrc/ncc_sweep.cu`, each beside its plain
PyTorch version.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each
wrapper counts its launches in its `.launches` attribute: K1's a plain
integer, K3's a Counter keyed by the C entry (one for each volume type).

Layouts are the reference's: images (H, W, C) float32, centered on the
uint8 grid (value - 128); per-pixel maps (H, W).  The cost volume is
slot-major, (H, s_cap, W) (the reference's is (H, W, s_cap)): the refine
sweep (K2) reads one slot of neighbouring pixels from neighbouring
addresses, and K3 writes it along x.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch
import torch.nn.functional as F

from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.stereo.ncc import shifted
from reconstruction_tpu_torch.utils.fp import fma32


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


def _require_cuda(name: str, specs) -> torch.device:
    """Check (tensor, dtype, shape) triples for a kernel launch."""
    dev = specs[0][0].device
    for i, (t, dtype, shape) in enumerate(specs):
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: argument {i} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
    return dev


def _dispatch(t: torch.Tensor) -> bool:
    """True for the plain path (CPU tensors); False for a CUDA launch."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# K1: sweep
# ---------------------------------------------------------------------------

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
        sc = torch.where(ok, sc, torch.tensor(-2.0, device=dev))
        upd = sc > best
        best = torch.where(upd, sc, best)
        bt = torch.where(upd, t, bt)
    return best, bt


SWEEP_RADII = (1, 2, 3)   # the window radii K1 is built for

# K1's tiling and mode rule (csrc/ncc_sweep.cu): a block is 2 x 4 warps, a
# warp 2 * (32 - 2 * ceil(r / 2)) output columns by 4 rows.
K1_WARP_ROWS, K1_WARPS_X, K1_WARPS_Y = 4, 2, 4
K1_CAND_RATIO, K1_CAND_SPAN0 = 3, 32


def sweep_plan(active, lo, hi, radius: int) -> dict:
    """What K1 evaluates on these bounds, by the kernel's own rule: per
    block, sweep mode runs each warp's 256 output slots over the warp's
    shift union, and takes as long as its longest warp; candidate mode,
    taken when the union pairs counted at that length (every warp as long
    as the longest, less K1_CAND_SPAN0 shifts) are more than K1_CAND_RATIO
    times the block's useful pairs, scores only those, spread over the
    block's threads.
    Returns the useful and evaluated pairs, the most pairs one block
    evaluates, and the blocks in each mode."""
    H, W = lo.shape
    wout = 2 * (32 - 2 * ((radius + 1) // 2))
    bx, by = K1_WARPS_X * wout, K1_WARPS_Y * K1_WARP_ROWS
    x = torch.arange(W, dtype=torch.int32, device=lo.device)[None, :]
    a, b = lo.clamp(min=0), hi.clamp(max=W - 1)
    act = active & (a <= b)
    big = 1 << 20
    ph, pw = -H % by, -W % bx
    pad = lambda m, v: F.pad(m, (0, pw, 0, ph), value=v)
    n = pad(torch.where(act, b - a + 1, 0).long(), 0)
    smin = pad(torch.where(act, a - x, big), big)
    smax = pad(torch.where(act, b - x, -big), -big)
    Hp, Wp = H + ph, W + pw
    warps = lambda m: m.reshape(Hp // K1_WARP_ROWS, K1_WARP_ROWS, Wp // wout, wout)
    span = (warps(smax).amax((1, 3)) - warps(smin).amin((1, 3)) + 1).clamp_min(0)
    span = span.long().reshape(Hp // by, K1_WARPS_Y, Wp // bx, K1_WARPS_X)
    slots = 32 * 2 * K1_WARP_ROWS   # output slots of a warp
    sweep = slots * span.sum((1, 3))
    useful = n.reshape(Hp // by, by, Wp // bx, bx).sum((1, 3))
    longest = span.amax((1, 3))
    union = slots * K1_WARPS_X * K1_WARPS_Y * (longest - K1_CAND_SPAN0)
    cand = (useful > 0) & (longest > K1_CAND_SPAN0) & (union > K1_CAND_RATIO * useful)
    work = torch.where(cand, useful, sweep)
    return dict(useful=int(useful.sum()), evaluated=int(work.sum()),
                heaviest_block=int(work.max()),
                candidate_blocks=int(cand.sum()),
                sweep_blocks=int(((useful > 0) & ~cand).sum()),
                blocks=cand.numel())


def check_off_grid(name: str, off_grid: torch.Tensor) -> None:
    """Raise if a kernel flagged an image value off the integer grid (reading
    the flag back waits for the kernel)."""
    if int(off_grid.item()):
        raise ValueError(f"{name}: images must be centered uint8 values "
                         "(integers in [-128, 127]); the kernel's int8 sums "
                         "are exact only there")


def ncc_sweep(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
              radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, the plain sweep on CPU tensors.

    L, R: (H, W, C) f32 centered images; nmuL = n * mean of L's windows,
    invL, muR, invR: (H, W) f32 moments; validR, active: (H, W) bool;
    lo, hi: (H, W) int32 absolute target-column bounds.  The kernel sums
    the window products in int8 x int32, exact for images on the integer
    grid [-128, 127] (centered uint8 values): it flags any value it reads
    off that grid, and the wrapper then raises.  It takes at most 4
    channels and the radii SWEEP_RADII.
    """
    if _dispatch(L):
        return ncc_sweep_plain(L, R, nmuL, invL, muR, invR, validR, active,
                               lo, hi, radius)
    H, W, C = L.shape
    f32, i32 = torch.float32, torch.int32
    dev = _require_cuda("ncc_sweep", [
        (L, f32, (H, W, C)), (R, f32, (H, W, C)), (nmuL, f32, (H, W)),
        (invL, f32, (H, W)), (muR, f32, (H, W)), (invR, f32, (H, W)),
        (validR, torch.bool, (H, W)), (active, torch.bool, (H, W)),
        (lo, i32, (H, W)), (hi, i32, (H, W))])
    if not (1 <= C <= 4 and radius in SWEEP_RADII):
        raise ValueError(f"ncc_sweep: {C} channels, radius {radius}; the "
                         f"kernel takes 1..4 channels and radii {SWEEP_RADII}")
    score = torch.empty((H, W), dtype=f32, device=dev)
    t = torch.empty((H, W), dtype=i32, device=dev)
    off_grid = torch.zeros(1, dtype=i32, device=dev)
    _build.launch("rtt_ncc_sweep", *[a.data_ptr() for a in (
        L, R, nmuL, invL, muR, invR, validR, active, lo, hi, score, t,
        off_grid)], H, W, C, radius)
    ncc_sweep.launches += 1
    check_off_grid("ncc_sweep", off_grid)
    return score, t


ncc_sweep.launches = 0


# ---------------------------------------------------------------------------
# K3: banded cost volume
# ---------------------------------------------------------------------------

def cost_volume_plain(L, R, nmuL, invL, muR, invR, base_b, lo_b, hi_b,
                      s_cap: int, band: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch banded 3x3 cost volume.

    cv[y, j, x] = (1 - NCC3x3(x, x + s)) / 2 for s = base_b[y // band] + j
    inside [lo_b, hi_b] of that band, 0.5 elsewhere.  Shifts are written in
    ascending order at slot clamp(s - base, 0, s_cap - 1), as the
    reference's clamped `dynamic_update_slice`: a band whose range lies
    wholly past its slots (|disparity| beyond the image width) leaves its
    last shift in the edge slot.  ``dtype`` bfloat16: the float32 volume
    rounded to nearest even (the TPU refine's bfloat16 window)."""
    if dtype != torch.float32:
        return cost_volume_plain(L, R, nmuL, invL, muR, invR, base_b, lo_b,
                                 hi_b, s_cap, band).to(dtype)
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


MAX_SLOTS = 128   # K3 keeps a band's filled range (at most s_cap shifts) in shared memory
# The volume's element types, each with K3's C entry.
VOLUME_ENTRIES = {torch.float32: "rtt_cost_volume",
                  torch.bfloat16: "rtt_cost_volume_bf16"}


def cost_volume(L, R, nmuL, invL, muR, invR, base_b, lo_b, hi_b,
                s_cap: int, band: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3 on CUDA tensors, the plain volume on CPU tensors.

    L, R: (H, W, C) f32 centered images; nmuL, invL, muR, invR: (H, W)
    radius-1 moments (nmuL = 9C * mean); base_b, lo_b, hi_b: (nb,) int32
    per-band slot base and filled shift range.  Returns (H, s_cap, W) of
    ``dtype``: float32, or bfloat16, which K3 rounds from the float32
    scores as it stores them.
    The kernel sums the window products in int8 x int32, exact for images
    on the integer grid [-128, 127] (centered uint8 values); it flags any
    value it reads off that grid, and the wrapper then raises (reading the
    flag back waits for the kernel).  It takes at most 4 channels and
    MAX_SLOTS slots.
    """
    if dtype not in VOLUME_ENTRIES:
        raise TypeError(f"cost_volume: a {dtype} volume; the kernel writes "
                        f"{list(VOLUME_ENTRIES)}")
    if _dispatch(L):
        return cost_volume_plain(L, R, nmuL, invL, muR, invR, base_b, lo_b,
                                 hi_b, s_cap, band, dtype)
    H, W, C = L.shape
    nb = -(-H // band)
    f32, i32 = torch.float32, torch.int32
    dev = _require_cuda("cost_volume", [
        (L, f32, (H, W, C)), (R, f32, (H, W, C)), (nmuL, f32, (H, W)),
        (invL, f32, (H, W)), (muR, f32, (H, W)), (invR, f32, (H, W)),
        (base_b, i32, (nb,)), (lo_b, i32, (nb,)), (hi_b, i32, (nb,))])
    if not (1 <= C <= 4 and 1 <= s_cap <= MAX_SLOTS):
        raise ValueError(f"cost_volume: {C} channels, {s_cap} slots; the "
                         f"kernel takes 1..4 and 1..{MAX_SLOTS}")
    cv = torch.empty((H, s_cap, W), dtype=dtype, device=dev)
    off_grid = torch.zeros(1, dtype=i32, device=dev)
    entry = VOLUME_ENTRIES[dtype]
    _build.launch(entry, *[a.data_ptr() for a in (
        L, R, nmuL, invL, muR, invR, base_b, lo_b, hi_b, cv, off_grid)],
        H, W, C, s_cap, band)
    cost_volume.launches[entry] += 1
    check_off_grid("cost_volume", off_grid)
    return cv


cost_volume.launches = collections.Counter()   # by C entry
