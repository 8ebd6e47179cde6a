"""`portbench/spans.py`: a pair's stretches by innermost span, the device's
busy and idle time, launches and read-backs attributed to them, and the
readings the metrics take from the table."""

import types

from portbench import spans
from reconstruction_tpu_torch.utils.timing import SpanRecord


def rec(name, parent, start, end, thread=1):
    return SpanRecord(name, parent, thread, start, end)


ROOT = rec("match_pair", None, 0, 100)
RECORDS = [rec("rectify_map", "match_pair", 10, 30), rec("upload", "match_pair", 30, 40),
           rec("match", "level0", 45, 60), rec("level0", "levels", 40, 90),
           rec("levels", "match_pair", 40, 90), ROOT,
           rec("elsewhere", None, 20, 80, thread=2)]
# (start, end, name, correlation) on the device; the host launched each at
# `LAUNCHED[correlation]`
DEVICE = [(0, 5, "kernel_a", 1), (35, 50, "kernel_b", 2), (70, 72, "Memcpy DtoH (Device -> Pageable)", 3),
          (80, 81, "Memcpy HtoD (Pageable -> Device)", 4)]
LAUNCHED = {1: 1, 2: 32, 3: 65}


def test_segments_by_innermost_span():
    assert spans.segments(ROOT, RECORDS) == [
        (0, 10, "self"), (10, 30, "rectify_map"), (30, 40, "upload"), (40, 45, "levels/level0"),
        (45, 60, "levels/level0/match"), (60, 90, "levels/level0"), (90, 100, "self")]


def test_attribution():
    t = spans.attribute([ROOT], RECORDS, DEVICE, LAUNCHED)
    rows = t["per_pair"]
    assert round(rows["self"]["busy_s"] * 1e9) == 5 and rows["self"]["launches"] == 1
    assert round(rows["upload"]["busy_s"] * 1e9) == 5 and rows["upload"]["launches"] == 1
    assert round(rows["levels/level0"]["busy_s"] * 1e9) == 5 + 2 + 1
    assert rows["levels/level0"]["readbacks"] == 1
    assert round(rows["levels/level0/match"]["busy_s"] * 1e9) == 5
    assert round(rows["rectify_map"]["idle_s"] * 1e9) == 20 and rows["rectify_map"]["busy_s"] == 0
    assert round(t["totals"]["host_s"] * 1e9) == 100
    assert round((t["totals"]["busy_s"] + t["totals"]["idle_s"]) * 1e9) == 100
    assert t["totals"]["launches"] == 2 and t["totals"]["readbacks"] == 1
    assert t["events_with_no_launch_record"] == 1       # the HtoD copy: by its device time
    # gaps: 5-35 (rectify_map 20 of 30), 50-70 (match 10, level0 10: a tie goes to the
    # first), 72-80 (level0), 81-100 (level0 9, self 10)
    assert [(round(g * 1e9), p, round(share, 3)) for g, p, share in t["longest_idle_gaps"]] == [
        (30, "rectify_map", 0.667), (20, "levels/level0/match", 0.5), (19, "self", 0.526),
        (8, "levels/level0", 1.0)]

    ctx = types.SimpleNamespace()
    ctx.__dict__[spans._KEY] = {"window": {"spans": {}}, "sample": t}
    assert spans.sample_reading(ctx, "readbacks") == 1
    idle = t["totals"]["idle_s"]
    assert abs(spans.sample_reading(ctx, "idle_in_rectify_map") - 100 * 20e-9 / idle) < 1e-9


def test_window_summary_and_readings():
    w = spans.window_summary(RECORDS)
    assert w["spans"]["match_pair"] == {"n": 1, "s": 100e-9}
    assert abs(w["match_pair_children_share"] - 0.8) < 1e-12    # 20 + 10 + 50 of 100
    ctx = types.SimpleNamespace()
    ctx.__dict__[spans._KEY] = {"window": w}
    assert spans.per_unit(ctx, "rectify_map", "match_pair") == 20e-9
    assert spans.per_unit(ctx, "sor", "mesh_cleanup") is None
    assert spans.sample_reading(ctx, "readbacks") is None
    ctx.__dict__[spans._KEY] = None                 # a program with no span log
    assert spans.per_unit(ctx, "rectify_map", "match_pair") is None


def test_sample_size():
    assert spans.sample_pairs({"lowest_level_size": [160, 240], "pyramid_levels": 4,
                               "cam_pairs": [[0, 1]] * 4}) == 4
    assert spans.sample_pairs({"lowest_level_size": [240, 135], "pyramid_levels": 5,
                               "cam_pairs": [[0, 1]] * 16}) == 2
