"""Percent of the device's idle time in the sampled pairs
(`portbench/spans.py`) during which the host was inside a `rectify_map`
span: the card waiting for the host's rectification maps."""

from portbench import spans


def collect(ctx):
    return spans.sample_reading(ctx, "idle_in_rectify_map")


def read(record):
    return record["collected"].get("device.idle_in_rectify_map.pairs")
