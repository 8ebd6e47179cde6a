"""Seconds a pair in the uploads of both views: the window's `upload`
spans (the rectification maps, the view and its mask copied from host
memory to the device) per `match_pair` span."""

from portbench import spans


def collect(ctx):
    return spans.per_unit(ctx, "upload", "match_pair")


def read(record):
    return record["collected"].get("stereo.upload_s.pairs")
