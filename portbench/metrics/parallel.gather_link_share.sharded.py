"""Percent of the link's peak that rank 0's tensor gather reached: the
bytes of the results that rank 0 has to receive (`links.received_bytes`,
from the configuration's shapes) over the seconds of its `gather_tensors`
`Timer` span, over `links.PEAK_BYTES_PER_S`, summed over the window's
requests.  It reads nothing from a program without that span, nor from a
run whose ranks do not talk over NCCL (the link is NVLink)."""

from portbench import links


def collect(ctx):
    return links.received_bytes(ctx.config)


def read(record):
    nbytes = record["collected"].get("parallel.gather_link_share.sharded")
    secs = [r["gather_tensors_s"] for r in record["requests"]
            if r.get("gather_tensors_s") is not None and r.get("backend") == "nccl"]
    if nbytes is None or not secs or sum(secs) <= 0:
        return None
    return 100.0 * nbytes * len(secs) / sum(secs) / links.PEAK_BYTES_PER_S
