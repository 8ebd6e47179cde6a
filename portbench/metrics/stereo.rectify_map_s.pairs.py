"""Seconds a pair in the host's rectification maps: the window's
`rectify_map` spans (`core/remap.rectify_map`, both views) per
`match_pair` span.  Its `collect` also returns the run's whole span table
(`portbench/spans.py`), which the run logs."""

from portbench import spans


def collect(ctx):
    return {"value": spans.per_unit(ctx, "rectify_map", "match_pair"),
            "table": spans.table(ctx)}


def read(record):
    c = record["collected"].get("stereo.rectify_map_s.pairs")
    return None if c is None else c["value"]
