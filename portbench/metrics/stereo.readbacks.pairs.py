"""Device-to-host copies a pair: those the profiler records in the
sampled pairs after the window (`portbench/spans.py`), per pair."""

from portbench import spans


def collect(ctx):
    return spans.sample_reading(ctx, "readbacks")


def read(record):
    return record["collected"].get("stereo.readbacks.pairs")
