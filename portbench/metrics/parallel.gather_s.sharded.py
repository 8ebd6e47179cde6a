"""Seconds a request in rank 0's gather of every pair's result: its
`gather` `Timer` span in `match_pairs_sharded`, the wait for the slowest
rank included, averaged over the window's requests."""


def read(record):
    vals = [r["gather_s"] for r in record["requests"] if r.get("gather_s") is not None]
    return sum(vals) / len(vals) if vals else None
