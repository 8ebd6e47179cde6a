"""The 90th percentile of the latency of every pair in the window (linear
interpolation between order statistics)."""

import numpy as np


def read(record):
    walls = [r["wall_s"] for r in record["requests"] if r.get("takes") is None]
    return float(np.percentile(walls, 90)) if walls else None
