"""Seconds a take in the pair driver: its `pairN/stereo` spans."""


def read(record):
    takes = [r for r in record["requests"] if "spans" in r]
    if not takes:
        return None
    return sum(sum(v for k, v in r["spans"].items() if k.endswith("/stereo"))
               for r in takes) / len(takes)
