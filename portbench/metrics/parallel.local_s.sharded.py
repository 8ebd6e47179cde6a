"""Seconds a request on rank 0's own pairs: its `local` `Timer` span in
`match_pairs_sharded`, averaged over the window's requests."""


def read(record):
    vals = [r["local_s"] for r in record["requests"] if r.get("local_s") is not None]
    return sum(vals) / len(vals) if vals else None
