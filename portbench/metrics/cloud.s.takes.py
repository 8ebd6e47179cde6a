"""Seconds a take in the cloud stages: the `pairN/filter` spans (SOR and
normals) and the `mls` and `dedup` spans."""


def read(record):
    takes = [r for r in record["requests"] if "spans" in r]
    if not takes:
        return None
    return sum(sum(v for k, v in r["spans"].items()
                   if k.endswith("/filter") or k in ("mls", "dedup"))
               for r in takes) / len(takes)
