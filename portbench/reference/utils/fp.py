"""float32 arithmetic that reproduces the reference's compiled rounding.

XLA:CPU compiles the JAX package with mul+add contraction: wherever a
product feeds an add or subtract inside one fusion it emits one fused
multiply-add, which rounds once.  It also rewrites a division by a
constant into a multiplication by the constant's reciprocal.  The port
states those few places explicitly (`fma32` here, `__fmaf_rn` in the
CUDA kernels) so that its float32 results equal the reference's bit for
bit, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch


def _f32(t, dev):
    """A float32 tensor on ``dev``, or for a Python number the float32
    value it rounds to, as a Python float (exact in float64)."""
    if isinstance(t, torch.Tensor):
        return t.to(device=dev, dtype=torch.float32)
    return float(torch.tensor(t, dtype=torch.float32))


def _f64(t):
    return t.double() if isinstance(t, torch.Tensor) else t


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, like fmaf).

    The float64 product of two float32 values is exact.  The float64 sum
    is rounded to odd (TwoSum gives its exact error; an inexact sum keeps
    an odd last bit), so the final rounding to float32 is the only one
    that counts (Boldo and Melquiond: round-to-odd in at least 2p+2 bits,
    then round-to-nearest in p bits, equals one rounding to nearest).
    Python numbers stay Python floats (their float32 values), so that no
    constant is copied to the device.
    """
    dev = next((t.device for t in (a, b, c) if isinstance(t, torch.Tensor)
                and t.device.type != "cpu"), torch.device("cpu"))
    a, b, c = (_f32(t, dev) for t in (a, b, c))
    if not any(isinstance(t, torch.Tensor) for t in (a, b, c)):
        a = torch.tensor(a, dtype=torch.float32, device=dev)
    p = _f64(a) * _f64(b)
    cd = _f64(c)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.contiguous().view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# XLA:CPU's float32 exp: Cephes range reduction and polynomial, evaluated
# with fused multiply-adds, results below the smallest normal flushed to
# zero (XLA:CPU runs with denormals flushed).  csrc/refine.cu has the same.
EXP_LOG2E = 1.44269504088896341
EXP_C1 = 0.693359375
EXP_C2 = -2.12194440e-4
EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
            4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 exp rounded exactly as the reference's compiled exp."""
    xx = torch.clamp(x.float(), -88.0, 88.0)
    n = torch.floor(fma32(xx, EXP_LOG2E, 0.5))
    r = fma32(-n, EXP_C1, xx)
    r = fma32(-n, EXP_C2, r)
    z = r * r
    y = torch.full_like(r, EXP_POLY[0])
    for p in EXP_POLY[1:]:
        y = fma32(y, r, p)
    y = fma32(y, z, r) + 1.0
    out = (y.double() * torch.exp2(n.double())).float()
    return torch.where(out.abs() < _F32_TINY, torch.zeros_like(out), out)


def mul_recip(x: torch.Tensor, n: float) -> torch.Tensor:
    """``x / n`` as XLA compiles it for a constant ``n``: ``x * (1/n)``
    with the reciprocal rounded to float32 first."""
    recip = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(n), dtype=torch.float32)
    return x * recip.to(x.device)
