"""`correct` comes out true for the program as configured and false for
the control (the bfloat16 cost window) and for each fault that a cell's
timed path can have, planted in the port."""

import pytest

from tinycell import run_tiny, tiny_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["tiny.pairs", "tiny.takes"])
def test_control_fails(root, workload):
    line = run_tiny(root, workload, control="bfloat16")
    assert line["correct"] is False
    assert line["check"]["disp_off_share"]["value"] > line["check"]["disp_off_share"]["limit"]


@pytest.mark.parametrize("workload,fault", [
    ("tiny.pairs", "refine_unchanged"),
    ("tiny.pairs", "answer_altered"),
    ("tiny.takes", "refine_unchanged"),
    ("tiny.takes", "answer_altered"),
    ("tiny.takes", "half_the_pairs"),
])
def test_fault_fails(root, workload, fault):
    line = run_tiny(root, workload, fault=fault)
    assert line["correct"] is False
    failed = [k for k, c in line["check"].items() if not c["value"] <= c["limit"]]
    assert failed, line["check"]
