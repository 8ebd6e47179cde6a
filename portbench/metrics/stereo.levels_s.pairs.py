"""Seconds a pair in pyramid matching: the sum of `PairResult.level_ms`,
CUDA events recorded at the level boundaries (none on the CPU)."""


def read(record):
    pairs = [r for r in record["requests"] if r.get("level_ms")]
    if not pairs:
        return None
    return sum(sum(r["level_ms"]) for r in pairs) / 1e3 / len(pairs)
