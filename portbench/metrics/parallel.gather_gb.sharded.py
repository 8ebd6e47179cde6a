"""Gigabytes that rank 0's collectives sent a request (`mesh.COMM` over
its `match_pairs_sharded` call), averaged over the window's requests."""


def read(record):
    vals = [r["comm_bytes"] for r in record["requests"] if r.get("comm_bytes") is not None]
    return sum(vals) / len(vals) / 1e9 if vals else None
