"""Seeded fixed inputs of the kernel metrics (`metrics/ops.*`), made on the
device, and their timer."""

from __future__ import annotations

import math

import torch

BORDER = 16


def _generator(ctx, salt: int) -> torch.Generator:
    g = torch.Generator(device=ctx.device)
    g.manual_seed((int(ctx.seed) * 1_000_003 + salt) % (1 << 63))
    return g


def images(ctx, H: int, W: int):
    """(left, right (H, W, 3) float32 on the 8-bit grid, valid (H, W) bool:
    every pixel inside a BORDER-pixel frame)."""
    g = _generator(ctx, 1)
    L = torch.randint(0, 256, (H, W, 3), generator=g, device=ctx.device).float()
    R = torch.randint(0, 256, (H, W, 3), generator=g, device=ctx.device).float()
    valid = torch.zeros((H, W), dtype=torch.bool, device=ctx.device)
    valid[BORDER:H - BORDER, BORDER:W - BORDER] = True
    return L, R, valid


def smooth_disparity(ctx, H: int, W: int) -> torch.Tensor:
    """A smooth float32 field of 10..30 pixels with seeded phases."""
    g = _generator(ctx, 2)
    ph = torch.rand(2, generator=g, device=ctx.device) * (2 * math.pi)
    y = torch.arange(H, device=ctx.device, dtype=torch.float32)[:, None]
    x = torch.arange(W, device=ctx.device, dtype=torch.float32)[None, :]
    return 20.0 + 10.0 * torch.sin(2 * math.pi * x / W + ph[0]) * torch.cos(2 * math.pi * y / H + ph[1])


def chained_seconds(ctx, call, n: int) -> float:
    """Seconds a call: one warm call, then ``n`` calls between two CUDA
    events (the host clock on the CPU)."""
    import time
    call()
    ctx.sync()
    if ctx.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        return (time.perf_counter() - t0) / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n
