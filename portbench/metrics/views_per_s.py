"""Views fused into finished textured meshes a second, over the whole
window (a pair fuses 2 views)."""


def read(record):
    return sum(r["views"] for r in record["requests"]) / record["window_s"]
