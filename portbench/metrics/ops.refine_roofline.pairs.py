"""Share of its roofline that the subpixel refine (`stereo/refine.
disparity_refine`: the banded cost volume, kernel K3, then the sweeps,
kernel K2) reaches on fixed work: the cell's finest-level shape, seeded
images on the 8-bit grid, a smooth disparity field inside a 16-pixel
border, and the finest level's refine_iters_base + refine_iters_per_level
* (levels - 1) sweeps in the configuration's cost-volume type.  CUDA
events time chained calls; the bound is the frozen `costs.refine_cost`
of the shifts these inputs fill, at the published peaks."""

import torch

from portbench import costs

CALLS = 5
S_CAP, BAND, DRIFT = 128, 64, 16     # disparity_refine's defaults, as match_one_level calls it


def filled_shifts(d, valid, W):
    """Mean over rows of the shifts a band's volume fills (the band's
    disparity range with the drift margin, inside its slots)."""
    H = d.shape[0]
    rows = torch.where(valid, d, torch.full_like(d, float("nan")))
    total = 0.0
    for b0 in range(0, H, BAND):
        blk = rows[b0:b0 + BAND]
        ok = ~torch.isnan(blk)
        if not bool(ok.any()):
            continue
        lo_v, hi_v = float(blk[ok].min()), float(blk[ok].max())
        base = round((lo_v + hi_v) * 0.5) - S_CAP // 2
        lo = max(base, round(lo_v) - 2 - DRIFT, -(W - 1))
        hi = min(base + S_CAP - 1, round(hi_v) + 3 + DRIFT, W - 1)
        total += max(hi - lo + 1, 0) * blk.shape[0]
    return total / H


def collect(ctx):
    if ctx.device.type != "cuda":
        return None              # a device share has no reading on the CPU
    from portbench.metrics_inputs import chained_seconds, images, smooth_disparity
    from reconstruction_tpu_torch.config import NOMATCH
    from reconstruction_tpu_torch.stereo.margins import find_margin
    from reconstruction_tpu_torch.stereo.refine import disparity_refine
    W, H = ctx.finest_size
    L, R, valid = images(ctx, H, W)
    st = ctx.config["stereo"]
    iters = int(st["refine_iters_base"]) + int(st["refine_iters_per_level"]) * (
        int(ctx.config["pyramid_levels"]) - 1)
    d = torch.where(valid, smooth_disparity(ctx, H, W), float(NOMATCH)).float()
    m = find_margin(valid, int(st["block_radius"]))
    seconds = chained_seconds(ctx, lambda: disparity_refine(
        d, L, R, m, iters, float(st["refine_ws"]), S_CAP, BAND, DRIFT,
        recenter_every=int(st["refine_recenter_every"]), cv_dtype=st["refine_cv_dtype"]),
        CALLS)
    shifts = filled_shifts(d, valid, W)
    cost = costs.refine_cost(H, W, iters, shifts)
    return {"seconds": seconds, "share_pct": cost.share_pct(seconds),
            "bound_s": cost.bound_s(), "bound_by": cost.bound_by(),
            "filled_shifts": shifts, "sweeps": iters}


def read(record):
    c = record["collected"].get("ops.refine_roofline.pairs")
    return None if c is None else c["share_pct"]
