"""The result line: the contract's keys, in order, for both mixes, traced
and not; and no result without a card."""

import json
import os
import subprocess
import sys

import pytest

from tinycell import REPO, run_tiny, tiny_copy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload,trace", [("tiny.pairs", False), ("tiny.pairs", True),
                                            ("tiny.takes", False)])
def test_line_keys(root, workload, trace):
    line = run_tiny(root, workload, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == want
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind] if workload in m.get("workloads", [workload])}
    # kernel and device metrics have nothing to read on the CPU and are left out
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["check"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "myself.pairs",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_needs_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits non-zero and prints nothing."""
    import shutil
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "myself.pairs",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
