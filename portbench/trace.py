"""The device's side of a traced window: `torch.profiler` over the window,
read raw from its kineto records (wrapping them as `prof.events()` does
takes tens of seconds for a window's hundreds of thousands of events).

  busy_s      the union of the device's kernel, copy and set intervals;
  device_ops  device seconds by operation name, the largest ten;
  idle_gaps   the longest gaps between busy intervals, each named by the
              device operations on either side of it (a gap that ends in a
              host-to-device copy is the host preparing what it uploads).

Only the device's activity is recorded: recording every host operation
as well slows the host's side of the window, and so raises its idle
share.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def profiler():
    """The device's activity (on a machine without one, the host's, which
    holds no device event)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def _events(prof) -> List[tuple]:
    """The device's events as (start_ns, end_ns, name), by start."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns()
            dev.append((start, start + e.duration_ns(), e.name()))
    dev.sort()
    return dev


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    head = name.split("(", 1)[0] if not name.startswith("Memcpy") else name
    return head.split("<", 1)[0].replace("void ", "").strip() or name[:80]


def _merge(intervals: List[tuple]) -> List[List[int]]:
    merged: List[List[int]] = []
    for s, e, _ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, top: int = 10) -> Dict:
    """busy_s, the device operations that took most time and the longest
    idle gaps of a finished session."""
    dev = _events(prof)
    merged = _merge(dev)
    busy_ns = sum(e - s for s, e in merged)
    by_name: Dict[str, int] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    ending = {e: name for _, e, name in dev}       # a gap starts where an event ends
    starting = {st: name for st, _, name in reversed(dev)}
    named = [[f"{_short(ending[g0])} -> {_short(starting[g1])}", length / 1e9]
             for length, g0, g1 in gaps]
    return {"busy_s": busy_ns / 1e9, "device_events": len(dev),
            "device_ops": [[name, ns / 1e9] for name, ns in ops],
            "idle_gaps": named}
