"""Closed loop, one client: the configuration's pairs through the port's
`stereo/pipeline.match_pair`, one after the other, cycling through them,
from raw views to the triangulated cloud.

Set-up renders the cameras the pairs name (one seeded take) and warms the
path up with the first pair.  The comparison takes the traffic's
`check_requests` finished pairs drawn from the seed and runs the
reference's pair path once for each pair index among them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from portbench import compare, scene


@dataclass
class State:
    pairs: List[scene.PairViews]
    refs: Dict[int, object]


def _match(ctx, p):
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    return match_pair(ctx.program_cfg, p.image0, p.image1, p.mask0, p.mask1,
                      p.K0, p.Rt0, p.K1, p.Rt1, device=ctx.device)


def setup(ctx) -> State:
    cfg = ctx.config
    params = scene.draw_params(np.random.default_rng(ctx.seed), cfg["rig"]["num_cameras"])
    pairs = scene.make_take(cfg["rig"], ctx.finest_size, cfg["cam_pairs"], params, ctx.device)
    for _ in range(int(ctx.traffic.get("warmup_requests", 1))):
        _match(ctx, pairs[0])
    ctx.sync()
    return State(pairs=pairs, refs={})


def serve(ctx, state: State, i: int):
    """Request ``i``: (its record, what the comparison keeps of it)."""
    pi = i % len(state.pairs)
    res = _match(ctx, state.pairs[pi])
    ctx.sync()
    rec = {"pairs": 1, "views": 2, "pair": pi, "level_ms": res.level_ms}
    return rec, (pi, res.disparity, res.cloud)


def check(ctx, state: State, kept: list) -> Dict[str, float]:
    from portbench.reference.stereo.pipeline import match_pair as ref_match
    rows = []
    for _, (pi, disp, cloud) in kept:
        if pi not in state.refs:
            p = state.pairs[pi]
            state.refs[pi] = ref_match(ctx.reference_cfg, p.image0, p.image1, p.mask0,
                                       p.mask1, p.K0, p.Rt0, p.K1, p.Rt1, device=ctx.device)
        rows.append(compare.pair_numbers(disp, cloud, state.refs[pi]))
    return compare.worst(rows)
