"""A temporary copy of the benchmark with a tiny cell of each traffic mix,
and a subprocess that runs a cell there on the CPU, with a fault planted
in the port where asked."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {
    "name": "tiny",
    "source": "the port's preset('tiny') on a 4-camera rig",
    "precision": "float32",
    "guarantees": ["as myself"],
    "rig": {"num_cameras": 4, "span_deg": 14.0, "radius": 8.0, "focal_per_width": 1.6,
            "scene": "analytic height field"},
    "pyramid_levels": 2,
    "lowest_level_size": [48, 40],
    "cam_pairs": [[0, 1], [2, 3]],
    "reduced": [],
    "assumed": {},
}

# The faults a cell's timed path can have, planted in the port.
FAULTS = {
    # a step that returns its state unchanged: the refine
    "refine_unchanged": """
import reconstruction_tpu_torch.stereo.pipeline as P
P.disparity_refine = lambda disp, *a, **k: disp.float()
""",
    # an answer altered where it is produced: the pair's valid disparities
    # moved by a pixel (a limit above sound float32 rounding lets a few
    # pixels pass)
    "answer_altered": """
import reconstruction_tpu_torch.stereo.pipeline as P
import reconstruction_tpu_torch.pipeline.reconstruct as R
_orig = P.match_pair
def _altered(*a, **k):
    res = _orig(*a, **k)
    ok = res.disparity != -10000
    res.disparity[ok] += 1.0
    return res
P.match_pair = _altered
R.match_pair = _altered
""",
    # half of the batch left out: a take reconstructed from half its pairs
    "half_the_pairs": """
import reconstruction_tpu_torch.pipeline.reconstruct as R
_orig = R.reconstruct
R.reconstruct = lambda cfg, pairs, *a, **k: _orig(cfg, pairs[:max(len(pairs) // 2, 1)], *a, **k)
""",
}


def tiny_copy(dst: str, limits: dict | None = None) -> str:
    """Copy BENCHMARK.json and portbench/ to ``dst`` and add the tiny
    configuration, its two cells and their limits; returns ``dst``."""
    sys.path.insert(0, REPO)
    import dataclasses
    from reconstruction_tpu_torch.config import preset
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "out", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    c = preset("tiny")
    cfg = dict(TINY, stereo=dataclasses.asdict(c.stereo), cloud=dataclasses.asdict(c.cloud),
               surface=dict(dataclasses.asdict(c.surface), grid_resolution=32))
    with open(os.path.join(dst, "portbench", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for mix in ("takes", "pairs"):
        cell = f"tiny.{mix}"
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": mix, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"myself.{mix}" in m.get("workloads", ()):
                m["workloads"].append(cell)
        src = os.path.join(REPO, "portbench", "limits", f"myself.{mix}.json")
        with open(src) as f:
            lim = json.load(f)
        if limits:
            lim["limits"].update(limits)
        with open(os.path.join(dst, "portbench", "limits", f"{cell}.json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dst


def run_tiny(root: str, workload: str, seed: int = 2**31 + 11, seconds: float = 0.1,
             trace: bool = False, control: str | None = None, fault: str | None = None,
             timeout: int = 600) -> dict:
    """The result line of one CPU run of ``workload`` in ``root``."""
    code = (FAULTS[fault] if fault else "") + f"""
import json
from portbench import run
line = run.run_cell({workload!r}, {seed}, {seconds}, {trace}, device="cpu",
                    control={control!r}, root={root!r})
print(json.dumps(line))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]), OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
