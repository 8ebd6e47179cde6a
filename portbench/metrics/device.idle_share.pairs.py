"""Percent of the traced window in which no kernel, copy or set ran on the
device (the profiler's device intervals, merged)."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / record["window_s"])
