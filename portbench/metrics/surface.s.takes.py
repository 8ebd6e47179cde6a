"""Seconds a take in the surface stages: the `poisson`, `marching`,
`mesh_cleanup` and `texture` spans."""

SPANS = ("poisson", "marching", "mesh_cleanup", "texture")


def read(record):
    takes = [r for r in record["requests"] if "spans" in r]
    if not takes:
        return None
    return sum(sum(r["spans"].get(k, 0.0) for k in SPANS) for r in takes) / len(takes)
