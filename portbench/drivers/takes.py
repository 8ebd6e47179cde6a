"""Closed loop, one client: whole takes through the port's
`pipeline/reconstruct.reconstruct`, from every pair's raw views to the
textured mesh, back to back, cycling through the traffic's `takes` seeded
takes.

Set-up renders every take's cameras and warms the path up with the first
take.  The comparison takes the traffic's `check_requests` finished takes
drawn from the seed and runs the reference's whole take on each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from portbench import compare, scene


@dataclass
class State:
    takes: List[List[scene.PairViews]]
    refs: Dict[int, object]


def _reconstruct(ctx, pairs):
    from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct
    return reconstruct(ctx.program_cfg, pairs, device=ctx.device)


def setup(ctx) -> State:
    cfg = ctx.config
    rng = np.random.default_rng(ctx.seed)
    takes = []
    for _ in range(int(ctx.traffic["takes"])):
        params = scene.draw_params(rng, cfg["rig"]["num_cameras"])
        takes.append(scene.make_take(cfg["rig"], ctx.finest_size, cfg["cam_pairs"],
                                     params, ctx.device))
    for i in range(int(ctx.traffic.get("warmup_requests", 1))):
        _reconstruct(ctx, takes[i % len(takes)])
    ctx.sync()
    return State(takes=takes, refs={})


def serve(ctx, state: State, i: int):
    """Request ``i``: (its record, what the comparison keeps of it)."""
    ti = i % len(state.takes)
    rec = _reconstruct(ctx, state.takes[ti])
    ctx.sync()
    pairs = [(r.disparity, r.cloud) for r in rec.pair_results]
    mesh = {"vertices": rec.vertices, "colors": rec.colors, "cloud_xyz": rec.cloud_xyz}
    record = {"takes": 1, "pairs": len(pairs), "views": 2 * len(pairs),
              "take": ti, "spans": dict(rec.timer.spans)}
    return record, (ti, pairs, mesh)


def check(ctx, state: State, kept: list) -> Dict[str, float]:
    from portbench.reference.take import reconstruct_take
    rows = []
    for _, (ti, pairs, mesh) in kept:
        if ti not in state.refs:
            state.refs[ti] = reconstruct_take(ctx.reference_cfg, state.takes[ti], ctx.device)
        rows.append(compare.take_numbers(pairs, mesh, state.refs[ti]))
    return compare.worst(rows)
