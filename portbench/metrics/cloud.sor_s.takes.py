"""Seconds a take in the statistical outlier filter: the window's `sor`
spans (each pair's cloud read back and `cloud/filters.sor_filter`) per
take (one `mesh_cleanup` span a take).  Its `collect` also returns the
run's whole span table (`portbench/spans.py`), which the run logs."""

from portbench import spans


def collect(ctx):
    return {"value": spans.per_unit(ctx, "sor", "mesh_cleanup"), "table": spans.table(ctx)}


def read(record):
    c = record["collected"].get("cloud.sor_s.takes")
    return None if c is None else c["value"]
