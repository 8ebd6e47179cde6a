"""Seconds a take in the density trim of the mesh clean-up: the window's
`density_trim` spans (`surface/mesh.density_trim` on the host) per take
(one `mesh_cleanup` span a take), the clean-up step that takes the most
of `mesh_cleanup`."""

from portbench import spans


def collect(ctx):
    return spans.per_unit(ctx, "density_trim", "mesh_cleanup")


def read(record):
    return record["collected"].get("surface.density_trim_s.takes")
