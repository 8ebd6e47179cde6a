"""Share of its roofline that the NCC sweep (`stereo/matching.
ncc_sweep_match`, kernel K1) reaches on fixed work: the cell's finest-level
shape, seeded images on the 8-bit grid, every pixel inside a 16-pixel
border active, and the guided window's 2 * disparity_offset + 1 shifts
around a smooth disparity field.  CUDA events time chained calls; the
bound is the frozen `costs.ncc_sweep_cost` of the shifts these inputs
span, at the published peaks (`costs.PEAKS`)."""

import torch

from portbench import costs

CALLS = 20


def inputs(ctx):
    from portbench.metrics_inputs import images, smooth_disparity
    W, H = ctx.finest_size
    L, R, valid = images(ctx, H, W)
    off = int(ctx.config["stereo"]["disparity_offset"])
    x = torch.arange(W, dtype=torch.int32, device=ctx.device)[None, :]
    d = smooth_disparity(ctx, H, W).round().to(torch.int32)
    lo = (x + d - off).clamp(0, W - 1).contiguous()
    hi = (x + d + off).clamp(0, W - 1).contiguous()
    return L, R, valid, lo, hi


def collect(ctx):
    if ctx.device.type != "cuda":
        return None              # a device share has no reading on the CPU
    from portbench.metrics_inputs import chained_seconds
    from reconstruction_tpu_torch.stereo.matching import ncc_sweep_match
    L, R, valid, lo, hi = inputs(ctx)
    radius = int(ctx.config["stereo"]["block_radius"])
    H, W = valid.shape
    seconds = chained_seconds(
        ctx, lambda: ncc_sweep_match(L, R, valid, valid, lo, hi, radius).disparity, CALLS)
    shifts = float(((hi - lo + 1).float() * valid).sum()) / (H * W)
    cost = costs.ncc_sweep_cost(H, W, L.shape[-1], radius, 1)
    cost.flops *= shifts
    return {"seconds": seconds, "share_pct": cost.share_pct(seconds),
            "bound_s": cost.bound_s(), "bound_by": cost.bound_by(), "shifts_a_pixel": shifts}


def read(record):
    c = record["collected"].get("ops.sweep_roofline.pairs")
    return None if c is None else c["share_pct"]
