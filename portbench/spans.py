"""The program's own spans (`reconstruction_tpu_torch.utils.timing.span`),
read for the per-layer metrics of a traced run.

The port records its spans while a torch.profiler session is active, so
the records in its log when the first metric's `collect` runs are the
window's: set-up and warm-up ran with no session.  `table(ctx)` reads them
once a run, before anything else records:

  window   for each span name, its count and its host seconds over the
           window; and how much of the `match_pair` spans their direct
           children cover.

In the pair cells (on a CUDA device) it then runs a sample of its own: the
first `sample_pairs` pairs of the configuration, rendered again from the
seed as `drivers/pairs.py` renders them, one pair to lead in and then each
of them once more, under a profiler session that records the device's
activity only.  The spans and the device events share one clock (Unix
nanoseconds), so each stretch of a sampled pair is attributed to the
innermost span the host was in:

  sample   per pair and span path (below `match_pair`; `self` is the pair
           time no child covers): host seconds in that innermost span, the
           device's busy and idle seconds meanwhile, and the kernel and
           memset launches and device-to-host copies the host issued in it
           (by the launch's host time, from the CUDA runtime's record of
           it); and the longest idle gaps, each with the span the host
           spent most of it in.

A program that keeps no span log (an older tree) gives no table, and every
metric that reads it nothing.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import scene

# The sample's size: as many pairs as fit in this many finest-level pixels
# (4 myself pairs at 1920x1280, 2 dome pairs at 3840x2160), at least one.
SAMPLE_PIXELS = 20e6
_KEY = "_portbench_span_table"


def _program_log():
    """The port's span log module, or None where it keeps none."""
    try:
        from reconstruction_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "span_records") else None


def table(ctx) -> Optional[Dict]:
    """The run's table (module docstring), computed on the first call and
    kept on the run's context; None where the program keeps no span log."""
    if _KEY not in ctx.__dict__:
        ctx.__dict__[_KEY] = _table(ctx)
    return ctx.__dict__[_KEY]


def _table(ctx) -> Optional[Dict]:
    timing = _program_log()
    if timing is None:
        return None
    out = {"window": window_summary(timing.span_records(0))}
    if ctx.traffic.get("driver") == "pairs" and ctx.device.type == "cuda":
        out["sample"] = sample(ctx, timing)
    return out


def window_summary(records) -> Dict:
    """Count and host seconds of each span name, and the share of the
    `match_pair` spans' host time that their direct children cover."""
    spans: Dict[str, Dict] = {}
    for r in records:
        s = spans.setdefault(r.name, {"n": 0, "s": 0.0})
        s["n"] += 1
        s["s"] += (r.end_ns - r.start_ns) / 1e9
    roots = [r for r in records if r.name == "match_pair"]
    kids = sorted((r.thread, r.start_ns, r.end_ns) for r in records if r.parent == "match_pair")
    covered = 0
    for root in roots:
        i = bisect.bisect_left(kids, (root.thread, root.start_ns, 0))
        while i < len(kids) and kids[i][0] == root.thread and kids[i][2] <= root.end_ns:
            covered += kids[i][2] - kids[i][1]
            i += 1
    total = sum(r.end_ns - r.start_ns for r in roots)
    return {"spans": spans,
            "match_pair_children_share": covered / total if total else None}


def per_unit(ctx, name: str, unit: str) -> Optional[float]:
    """The window's seconds in span ``name`` per span ``unit`` (one a pair
    or a take); None where either is missing."""
    t = table(ctx)
    if t is None:
        return None
    spans = t["window"]["spans"]
    if name not in spans or unit not in spans:
        return None
    return spans[name]["s"] / spans[unit]["n"]


def sample_pairs(config: dict) -> int:
    w, h = config["lowest_level_size"]
    pixels = w * h * 4 ** (int(config["pyramid_levels"]) - 1)
    return max(1, min(len(config["cam_pairs"]), int(SAMPLE_PIXELS // pixels)))


def sample(ctx, timing) -> Dict:
    """Run the sample (module docstring) and attribute it."""
    from reconstruction_tpu_torch.stereo.pipeline import match_pair

    t0 = time.perf_counter()
    cfg = ctx.config
    n = sample_pairs(cfg)
    params = scene.draw_params(np.random.default_rng(ctx.seed), cfg["rig"]["num_cameras"])
    pairs = scene.make_take(cfg["rig"], ctx.finest_size, cfg["cam_pairs"][:n], params,
                            ctx.device)
    ctx.sync()
    mark = timing.span_mark()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for p in [pairs[0]] + pairs:        # the first pair leads in and is not read
            match_pair(ctx.program_cfg, p.image0, p.image1, p.mask0, p.mask1,
                       p.K0, p.Rt0, p.K1, p.Rt1, device=ctx.device)
            ctx.sync()
    records = timing.span_records(mark)
    cuda = torch.autograd.DeviceType.CUDA
    device, launched = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.correlation_id()))
        elif e.correlation_id():
            launched[e.correlation_id()] = e.start_ns()
    del prof
    roots = sorted((r for r in records if r.name == "match_pair"), key=lambda r: r.start_ns)[1:]
    out = attribute(roots, records, device, launched)
    out["seconds"] = time.perf_counter() - t0
    return out


def segments(root, records) -> List[tuple]:
    """(start_ns, end_ns, path) of the stretches of ``root`` by the
    innermost span open on its thread, the path from below the root
    ("self" where only the root is open)."""
    # Outer spans first; of two with the same interval the later record, the
    # parent (a span is logged when it ends, after its children).
    inside = [r for _, _, _, r in sorted(
        (r.start_ns, -r.end_ns, -i, r) for i, r in enumerate(records)
        if r.thread == root.thread and r is not root
        and r.start_ns >= root.start_ns and r.end_ns <= root.end_ns)]
    out, stack, cursor = [], [(root.end_ns, "self")], [root.start_ns]

    def upto(t, path):
        if t > cursor[0]:
            out.append((cursor[0], t, path))
            cursor[0] = t

    for r in inside:
        while r.start_ns >= stack[-1][0] and len(stack) > 1:
            upto(*stack.pop())
        upto(r.start_ns, stack[-1][1])
        parent = stack[-1][1]
        stack.append((min(r.end_ns, stack[-1][0]),
                      r.name if parent == "self" else f"{parent}/{r.name}"))
    while stack:
        upto(*stack.pop())
    return out


def idle_gaps(busy, lo: int, hi: int) -> List[tuple]:
    """The stretches of [lo, hi) that the merged, sorted ``busy`` intervals
    leave uncovered."""
    out, cur = [], lo
    for b0, b1 in busy[max(bisect.bisect_right(busy, [lo, float("inf")]) - 1, 0):]:
        if b0 >= hi:
            break
        if b0 > cur:
            out.append((cur, b0))
        cur = max(cur, b1)
    if cur < hi:
        out.append((cur, hi))
    return out


def attribute(roots, records, device, launched, top: int = 8) -> Dict:
    """The sample's table from its `match_pair` spans ``roots``, every span
    record, the device events (start_ns, end_ns, name, correlation) and the
    host start of each runtime call by correlation; with the ``top``
    longest idle gaps, each as (seconds, the path the host spent most of
    it in, that path's share of it)."""
    device = sorted(device)
    busy: List[List[int]] = []
    for s, e, _, _ in device:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    rows: Dict[str, Dict[str, float]] = {}

    def row(path):
        return rows.setdefault(path, {"host_s": 0.0, "busy_s": 0.0, "idle_s": 0.0,
                                      "launches": 0, "readbacks": 0})

    issued, unmatched = [], 0          # (host time of the launch, name), by time
    for s, _, name, corr in device:
        t = launched.get(corr)
        if t is None:
            unmatched += 1
        issued.append((s if t is None else t, name))
    issued.sort()
    longest = []
    for root in roots:
        segs = segments(root, records)
        starts = [s for s, _, _ in segs]
        for g0, g1 in idle_gaps(busy, root.start_ns, root.end_ns):
            by: Dict[str, int] = {}
            for s, e, path in segs[bisect.bisect_right(starts, g0) - 1:]:
                if s >= g1:
                    break
                by[path] = by.get(path, 0) + min(e, g1) - max(s, g0)
                row(path)["idle_s"] += (min(e, g1) - max(s, g0)) / 1e9
            most = max(by, key=by.get)
            longest.append(((g1 - g0) / 1e9, most, by[most] / (g1 - g0)))
        for s, e, path in segs:
            r = row(path)
            r["host_s"] += (e - s) / 1e9
            lo = bisect.bisect_left(issued, (s, ""))
            hi = bisect.bisect_left(issued, (e, ""))
            for _, name in issued[lo:hi]:
                if name.startswith("Memcpy DtoH"):
                    r["readbacks"] += 1
                elif not name.startswith("Memcpy"):
                    r["launches"] += 1
    for r in rows.values():
        r["busy_s"] = r["host_s"] - r["idle_s"]
    n = max(len(roots), 1)
    per_pair = {p: {k: v / n for k, v in r.items()} for p, r in sorted(rows.items())}
    totals = {k: sum(r[k] for r in per_pair.values()) for k in
              ("host_s", "busy_s", "idle_s", "launches", "readbacks")}
    return {"pairs": len(roots), "per_pair": per_pair, "totals": totals,
            "longest_idle_gaps": sorted(longest, reverse=True)[:top],
            "device_events": len(device), "events_with_no_launch_record": unmatched}


def sample_reading(ctx, what: str) -> Optional[float]:
    """``what`` of the sample: "readbacks" a pair, or "idle_in_rectify_map",
    the percent of the sampled pairs' device idle time spent while the host
    was inside a `rectify_map` span; None without a sample."""
    t = table(ctx)
    s = None if t is None else t.get("sample")
    if not s or not s["pairs"] or not s["device_events"]:
        return None
    if what == "readbacks":
        return s["totals"]["readbacks"]
    idle = s["totals"]["idle_s"]
    mine = sum(r["idle_s"] for p, r in s["per_pair"].items()
               if p.split("/")[-1] == "rectify_map")
    return 100.0 * mine / idle if idle else None
