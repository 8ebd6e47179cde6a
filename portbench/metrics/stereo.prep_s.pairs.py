"""Seconds a pair outside pyramid matching: the pair's wall time less its
levels' (rectification maps, remap, erosion, pyramids, triangulation)."""


def read(record):
    pairs = [r for r in record["requests"] if r.get("level_ms")]
    if not pairs:
        return None
    return sum(r["wall_s"] - sum(r["level_ms"]) / 1e3 for r in pairs) / len(pairs)
