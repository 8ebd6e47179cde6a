"""The orchestrator's own seconds a take: the harness's clock around
`reconstruct` less the sum of its `Timer` spans (each span synchronizes
the card at both ends, so the spans hold all the device work)."""


def read(record):
    takes = [r for r in record["requests"] if "spans" in r]
    if not takes:
        return None
    return sum(r["wall_s"] - sum(r["spans"].values()) for r in takes) / len(takes)
