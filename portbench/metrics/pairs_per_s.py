"""Pairs finished (raw views to the triangulated cloud) a second, over the
whole window."""


def read(record):
    return sum(r["pairs"] for r in record["requests"]) / record["window_s"]
