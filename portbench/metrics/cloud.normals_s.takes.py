"""Seconds a take in the normals: the window's `normals` spans
(`cloud/normals.estimate_normals` and the filtered cloud's read-back) per
take (one `mesh_cleanup` span a take)."""

from portbench import spans


def collect(ctx):
    return spans.per_unit(ctx, "normals", "mesh_cleanup")


def read(record):
    return record["collected"].get("cloud.normals_s.takes")
