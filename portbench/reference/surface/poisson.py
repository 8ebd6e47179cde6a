"""Poisson surface reconstruction on a dense grid (counterpart of
`reconstruction_tpu/surface/poisson.py`).

Replaces the reference's external PoissonRecon (`Demo/mesh.bat:1`) and
meshlab's global Poisson (`Demo/meshlab/script1.mlx`) with a dense
regular grid on the points' device:

  1. trilinear splat of the oriented normals -> vector field V, plus a
     sample-density grid for the trim,
  2. f = div V (central differences),
  3. the periodic 7-point Laplacian solved exactly by one rfftn / irfftn
     round trip (cuFFT on the card); the padded border is "outside", so
     the wrap is benign,
  4. isovalue = density-weighted mean of chi at the samples.

With point_weight > 0 (screened) a fixed-point loop re-uses the spectral
solve.  The splat's scatter-adds run in a fixed order on every device
(the deterministic path of `index_put_`), so two runs give the same grid.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

import torch


class PoissonResult(NamedTuple):
    chi: torch.Tensor        # (R, R, R) implicit function
    iso: torch.Tensor        # scalar isovalue
    density: torch.Tensor    # (R, R, R) splat density (for trimming)
    origin: torch.Tensor     # (3,) world coords of voxel (0, 0, 0)
    spacing: torch.Tensor    # scalar voxel size


@contextmanager
def _deterministic():
    """PyTorch's fixed-order (sorted) paths for accumulating scatters,
    restoring the caller's mode on exit."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _splat3(grid: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """Trilinear scatter-add of vals (N, C) at fractional idx (N, 3) into
    grid (R, R, R, C), corner by corner.  Each corner's adds run through
    the deterministic `index_put_`, which sums a voxel's updates in point
    order (CUDA atomics would not)."""
    i0 = torch.floor(idx)
    f = idx - i0
    i0 = i0.to(torch.int64)
    R = grid.shape[0]
    with _deterministic():
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    ii = torch.clamp(i0 + torch.tensor([dx, dy, dz], device=i0.device),
                                     0, R - 1)
                    wq = ((f[:, 0] if dx else 1 - f[:, 0])
                          * (f[:, 1] if dy else 1 - f[:, 1])
                          * (f[:, 2] if dz else 1 - f[:, 2])) * w
                    grid.index_put_((ii[:, 0], ii[:, 1], ii[:, 2]),
                                    wq[:, None] * vals, accumulate=True)
    return grid


def _shift3(a: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """Zero-padded shift along one axis: out[i] = a[i + d]."""
    out = torch.zeros_like(a)
    n = a.shape[axis]
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if d >= 0:
        src[axis], dst[axis] = slice(d, n), slice(0, n - d)
    else:
        src[axis], dst[axis] = slice(0, n + d), slice(-d, n)
    out[tuple(dst)] = a[tuple(src)]
    return out


# The dense multigrid V-cycle of the reference (`_laplacian` ... `_vcycle`,
# `reconstruction_tpu/surface/poisson.py:81-141`).  `poisson_reconstruct`
# solves spectrally; the z-sharded solver (`parallel/poisson_sharded.py`)
# is held to this one.

def _laplacian(x: torch.Tensor) -> torch.Tensor:
    out = -6.0 * x
    for ax in range(3):
        out = out + _shift3(x, ax, 1) + _shift3(x, ax, -1)
    return out


def _jacobi(x: torch.Tensor, f: torch.Tensor, screen: torch.Tensor,
            n_iter: int) -> torch.Tensor:
    """Weighted Jacobi for (Delta - screen) x = f."""
    omega = 2.0 / 3.0
    diag = -6.0 - screen
    for _ in range(n_iter):
        nb = torch.zeros_like(x)
        for ax in range(3):
            nb = nb + _shift3(x, ax, 1) + _shift3(x, ax, -1)
        x_new = (f - nb) / diag
        x = x + omega * (x_new - x)
    return x


def _restrict(x: torch.Tensor) -> torch.Tensor:
    """Full-weighting 2x restriction (trilinear average of 8 children)."""
    R = x.shape[0]
    return x.reshape(R // 2, 2, R // 2, 2, R // 2, 2).mean(dim=(1, 3, 5))


def _prolong(x: torch.Tensor) -> torch.Tensor:
    """Cell-centered trilinear prolongation: fine sample 2i gets
    0.75 c_i + 0.25 c_{i-1}, fine 2i+1 gets 0.75 c_i + 0.25 c_{i+1}
    (separable per axis; zero beyond the boundary)."""
    for ax in range(3):
        lo = 0.75 * x + 0.25 * _shift3_nd(x, ax, -1)
        hi = 0.75 * x + 0.25 * _shift3_nd(x, ax, 1)
        x = _interleave(lo, hi, ax)
    return x


def _shift3_nd(a: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    return _shift3(a, axis, d) if a.ndim == 3 else a


def _interleave(lo: torch.Tensor, hi: torch.Tensor, axis: int) -> torch.Tensor:
    stacked = torch.stack([lo, hi], dim=axis + 1)
    shape = list(lo.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _vcycle(x, f, screen, levels: int, pre: int, post: int) -> torch.Tensor:
    if levels == 0 or x.shape[0] <= 4:
        return _jacobi(x, f, screen, 40)
    x = _jacobi(x, f, screen, pre)
    r = f - (_laplacian(x) - screen * x)
    r2 = _restrict(r) * 4.0  # h^2 scaling: coarse h = 2h
    e2 = torch.zeros_like(r2)
    e2 = _vcycle(e2, r2, _restrict(screen) * 4.0, levels - 1, pre, post)
    x = x + _prolong(e2)
    x = _jacobi(x, f, screen, post)
    return x


def _spectral_inv_laplacian(f: torch.Tensor) -> torch.Tensor:
    """Exact solve of the periodic 7-point Laplacian: chi = Delta^-1 f,
    zero-mean convention (the k = 0 mode dropped)."""
    R = f.shape[0]
    fh = torch.fft.rfftn(f)
    k = torch.arange(R, dtype=torch.float32, device=f.device)
    lam1 = 2.0 * torch.cos(2.0 * math.pi * k / R) - 2.0
    kr = torch.arange(R // 2 + 1, dtype=torch.float32, device=f.device)
    lam_r = 2.0 * torch.cos(2.0 * math.pi * kr / R) - 2.0
    lam = lam1[:, None, None] + lam1[None, :, None] + lam_r[None, None, :]
    neg = lam < -1e-12
    inv = torch.where(neg, 1.0 / torch.where(neg, lam, 1.0), 0.0)
    return torch.fft.irfftn(fh * inv, s=f.shape)


def poisson_reconstruct(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    resolution: int = 128,
    cycles: int = 8,
    point_weight: float = 0.0,
    pad_frac: float = 0.1,
) -> PoissonResult:
    """Solve for the implicit function on a resolution^3 grid on the
    points' device (the reference's multigrid smoothing counts, ``pre``
    and ``post``, have no use in the spectral solve and are not taken)."""
    R = resolution
    pts = points.float()
    big = 1e30
    mn = torch.where(valid[:, None], pts, big).amin(0)
    mx = torch.where(valid[:, None], pts, -big).amax(0)
    ext = (mx - mn).max()
    pad = ext * pad_frac
    origin = mn - pad
    spacing = (ext + 2 * pad) / (R - 1)
    gp = (pts - origin) / spacing
    w = valid.float()

    # Normal field (3 channels) and density (1) in one splat.
    nrm = torch.where(valid[:, None], normals.float(), 0.0)
    vals = torch.cat([nrm, torch.ones_like(w)[:, None]], 1)
    grid = _splat3(torch.zeros((R, R, R, 4), device=pts.device), gp, w, vals)
    density = grid[..., 3].contiguous()

    # Divergence (central differences).
    f = torch.zeros((R, R, R), device=pts.device)
    for ax in range(3):
        V = grid[..., ax]
        f = f + 0.5 * (_shift3(V, ax, 1) - _shift3(V, ax, -1))
    del grid

    x = _spectral_inv_laplacian(f)
    if point_weight != 0.0:
        # Screened: (Delta - w D) chi = f; fixed point
        # chi <- Delta^-1 (f + w D chi), seeded by the unscreened solve.
        screen = float(point_weight) * density
        for _ in range(cycles):
            x = _spectral_inv_laplacian(f + screen * x)

    # Isovalue: density-weighted mean of chi at the samples.
    gi = torch.clamp(torch.round(gp).to(torch.int64), 0, R - 1)
    chi_at = x[gi[:, 0], gi[:, 1], gi[:, 2]]
    iso = (chi_at * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return PoissonResult(chi=x, iso=iso, density=density, origin=origin,
                         spacing=spacing)
