"""Kernel and memset launches a pair that the host issued inside the
`constraints` and `median` spans of its levels (smoothness, ordering,
uniqueness, bound propagation, the masked median), summed over the levels,
from the sampled pairs after the window (`portbench/spans.py`); None
without a sample."""

from portbench import spans


def collect(ctx):
    t = spans.table(ctx)
    s = None if t is None else t.get("sample")
    if not s or not s["pairs"] or not s["device_events"]:
        return None
    return sum(r["launches"] for p, r in s["per_pair"].items()
               if p.split("/")[-1] in ("constraints", "median"))


def read(record):
    return record["collected"].get("stereo.constraints_launches.pairs")
