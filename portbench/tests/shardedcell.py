"""A temporary copy of the benchmark (`tinycell.tiny_copy`) with a tiny
sharded cell: the tiny configuration's 3 pairs over 2 gloo ranks on the
CPU, the `sharded` mix with a short process-group timeout, and the limits
of `dome32x4.sharded`."""

from __future__ import annotations

import json
import os

from tinycell import REPO, TINY, tiny_copy

CELL = "tinyx2.sharded"
TIMEOUT_S = 30


def sharded_copy(dst: str) -> str:
    root = tiny_copy(dst)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tinyx2", cam_pairs=[[0, 1], [2, 3], [1, 2]],
               mesh={"frame": 1, "pair": 2, "tile": 1}, backend="gloo")
    assert cfg["rig"] == TINY["rig"]
    with open(os.path.join(pb, "configs", "tinyx2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "portbench", "traffic", "sharded.json")) as f:
        mix = json.load(f)
    with open(os.path.join(pb, "traffic", "tinysharded.json"), "w") as f:
        json.dump(dict(mix, timeout_s=TIMEOUT_S), f)
    with open(os.path.join(REPO, "portbench", "limits", "dome32x4.sharded.json")) as f:
        lim = f.read()
    with open(os.path.join(pb, "limits", f"{CELL}.json"), "w") as f:
        f.write(lim)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinyx2", "source": "test", "reduced": [], "why": "test",
                             "file": "portbench/configs/tinyx2.json"})
    bench["workloads"].append({"name": CELL, "config": "tinyx2", "traffic": "tinysharded",
                               "chips": 2, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dome32x4.sharded" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root
