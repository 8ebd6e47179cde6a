"""The sharded cell (`dome32x4.sharded`, `drivers/sharded.py`): its files
load by name; at a tiny size on the CPU over 2 gloo ranks
(`shardedcell.sharded_copy`) a run is correct, traced and not, and is not
with the bfloat16 control (which the workers run too) or with a received
result altered on rank 0; a worker killed in the window ends the run
non-zero within the process group's timeout; `links.py` counts the tensor
bytes of a real PairResult; the ranks' CPU blocks are whole cores, on
their devices' NUMA nodes where the counts allow; and on a host with four cards the cell itself
comes out correct."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from shardedcell import CELL, TIMEOUT_S, sharded_copy
from tinycell import REPO, run_tiny

METRICS = ["parallel.local_s.sharded", "parallel.gather_s.sharded",
           "parallel.gather_gb.sharded", "parallel.gather_link_share.sharded"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return sharded_copy(str(tmp_path_factory.mktemp("bench")))


def test_files_load():
    from portbench import spec
    cell = spec.load_cell("dome32x4.sharded", REPO)
    assert cell.chips == 4 and cell.traffic_name == "sharded"
    assert cell.config["mesh"] == {"frame": 1, "pair": 4, "tile": 1}
    assert cell.config["backend"] == "nccl"
    assert [m.name for m in cell.end_to_end] == ["pairs_per_s", "setup_s"]
    assert [m.name for m in cell.per_layer] == METRICS
    assert cell.limits == {"disp_off_share": 0.006, "cloud_off_share": 0.006,
                           "gather_mismatch_pairs": 0}
    with open(os.path.join(REPO, "portbench", "configs", "dome32.json")) as f:
        dome = json.load(f)
    same = {k for k in dome if k not in ("name", "source", "guarantees", "assumed")}
    assert {k: cell.config[k] for k in same} == {k: dome[k] for k in same}
    assert cell.config["reduced"] == []


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(root, trace):
    line = run_tiny(root, CELL, trace=trace)
    assert line["correct"] is True, line["check"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["check"]["gather_mismatch_pairs"]["value"] == 0
    if trace:
        # the link share reads only an NCCL run's gather
        assert sorted(line["metrics"]) == sorted(METRICS[:3])
        assert line["metrics"]["parallel.gather_gb.sharded"]["value"] > 0
    else:
        assert sorted(line["metrics"]) == ["pairs_per_s", "setup_s"]


# A received result altered on rank 0 (the run's own process): one pixel
# of each pair that came by the gather.
ALTERED = """
import reconstruction_tpu_torch.parallel.production as PR
_orig = PR.gather_results
def _altered(local, group, device, timer=None):
    out = _orig(local, group, device, timer)
    for r in out[len(local):]:
        r.disparity[r.disparity.shape[0] // 2, r.disparity.shape[1] // 2] += 1.0
    return out
PR.gather_results = _altered
"""


def test_control_fails(root):
    line = run_tiny(root, CELL, control="bfloat16")
    assert line["correct"] is False
    assert line["check"]["disp_off_share"]["value"] > line["check"]["disp_off_share"]["limit"]


def test_altered_result_fails(root, monkeypatch):
    import tinycell
    monkeypatch.setitem(tinycell.FAULTS, "received_altered", ALTERED)
    line = run_tiny(root, CELL, fault="received_altered")
    assert line["correct"] is False
    assert line["check"]["gather_mismatch_pairs"]["value"] == 1


def test_killed_worker_ends_the_run(root):
    """A worker killed in the window ends the run with a non-zero code and
    no result line, within the process group's timeout."""
    code = f"""
import json
from portbench import run
line = run.run_cell({CELL!r}, {2**31 + 21}, 600.0, False, device="cpu", root={root!r})
print(json.dumps(line))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]), OMP_NUM_THREADS="4")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        pids, seen = None, []
        for line in proc.stderr:
            seen.append(line)
            m = re.search(r"ranks 1-1 started: pids \[(\d+)\]", line)
            if m:
                pids = [int(m.group(1))]
            if re.search(r"\] set-up [\d.]+ s", line):
                break
        assert pids, "".join(seen[-20:])
        time.sleep(1.0)                 # inside the window
        os.kill(pids[0], signal.SIGKILL)
        t0 = time.monotonic()
        out, err = proc.communicate(timeout=TIMEOUT_S + 30)
        assert proc.returncode != 0
        assert out.strip() == ""
        assert time.monotonic() - t0 < TIMEOUT_S
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _driver():
    from portbench import spec
    return spec.load_module(os.path.join(REPO, "portbench", "drivers", "sharded.py"))


@pytest.mark.parametrize("nodes, want", [
    # two nodes of 4 two-CPU cores; devices 0-1 on node 0, 2-3 on node 1
    ([0, 0, 1, 1], [[0, 16, 1, 17], [2, 18, 3, 19], [8, 24, 9, 25], [10, 26, 11, 27]]),
    # devices' nodes the other way round: ranks 0-1 take node 1's cores
    ([1, 1, 0, 0], [[8, 24, 9, 25], [10, 26, 11, 27], [0, 16, 1, 17], [2, 18, 3, 19]]),
    # nodes unknown: in rank order
    ([-1, -1, -1, -1], [[0, 16, 1, 17], [2, 18, 3, 19], [8, 24, 9, 25], [10, 26, 11, 27]]),
])
def test_cpu_blocks_split_whole_cores_by_node(nodes, want):
    cores = [[c, c + 16] for c in (0, 1, 2, 3, 8, 9, 10, 11)]
    assert _driver().cpu_blocks(cores, nodes) == want


def test_cpu_blocks_need_a_core_a_rank():
    d = _driver()
    assert d.cpu_blocks([[0, 1], [2, 3]], [-1, -1, -1, -1]) is None
    # an odd core over is left out rather than split
    assert d.cpu_blocks([[0], [1], [2]], [-1, -1]) == [[0], [1]]


def test_host_cores_cover_each_cpu_once():
    cpus = os.sched_getaffinity(0)
    cores = _driver().host_cores(cpus)
    assert sorted(c for core in cores for c in core) == sorted(cpus)
    assert all(core == sorted(core) for core in cores)


def test_links_count_a_pair_result():
    import torch
    from portbench import links, scene
    from portbench.spec import build_config
    from reconstruction_tpu_torch import config as program_config
    from reconstruction_tpu_torch.parallel.production import _map_leaves
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from tinycell import TINY
    cfg = dict(TINY, mesh={"frame": 1, "pair": 2, "tile": 1}, cam_pairs=[[0, 1], [2, 3], [1, 2]])
    c = program_config.preset("tiny")
    cfg.update(stereo=dataclasses.asdict(c.stereo), cloud=dataclasses.asdict(c.cloud),
               surface=dataclasses.asdict(c.surface))
    w, h = cfg["lowest_level_size"]
    size = (w << (cfg["pyramid_levels"] - 1), h << (cfg["pyramid_levels"] - 1))
    params = scene.draw_params(np.random.default_rng(5), cfg["rig"]["num_cameras"])
    p = scene.make_take(cfg["rig"], size, cfg["cam_pairs"][:1], params, "cpu")[0]
    res = match_pair(build_config(program_config, cfg), p.image0, p.image1, p.mask0, p.mask1,
                     p.K0, p.Rt0, p.K1, p.Rt1, device="cpu")
    tensors = []
    _map_leaves(res, torch.is_tensor, tensors.append)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    assert links.pair_bytes(cfg) == nbytes
    assert links.owned_pairs(cfg, 0) == [0, 1] and links.owned_pairs(cfg, 1) == [2]
    assert links.received_bytes(cfg, 0) == nbytes and links.sent_bytes(cfg, 0) == 2 * nbytes


@pytest.mark.cuda
def test_sharded_cell_on_four_cards(card):
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip(f"the cell asks for 4 CUDA devices; {torch.cuda.device_count()} found")
    from portbench import run
    line = run.run_cell("dome32x4.sharded", 2**31 + 77, 5.0, False, root=REPO)
    assert line["correct"] is True, line["check"]
