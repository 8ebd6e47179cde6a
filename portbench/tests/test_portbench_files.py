"""A configuration, a traffic mix and a per-layer metric are added as new
files (and entries in BENCHMARK.json) and found by name, with no file that
was there edited."""

import hashlib
import json
import os

from tinycell import run_tiny, tiny_copy


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found(tmp_path):
    root = tiny_copy(str(tmp_path))
    before = _digests(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["lowest_level_size"] = [40, 32]
    with open(os.path.join(pb, "configs", "tinier.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "pairs.json")) as f:
        mix = json.load(f)
    with open(os.path.join(pb, "traffic", "onepair.json"), "w") as f:
        json.dump(dict(mix, check_requests=1), f)
    with open(os.path.join(pb, "metrics", "requests.count.new.py"), "w") as f:
        f.write('"""Requests in the window."""\n\n\ndef read(record):\n'
                '    return float(len(record["requests"]))\n')
    with open(os.path.join(pb, "limits", "tiny.pairs.json")) as f:
        lim = f.read()
    with open(os.path.join(pb, "limits", "tinier.onepair.json"), "w") as f:
        f.write(lim)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinier", "source": "test",
                             "file": "portbench/configs/tinier.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tinier.onepair", "config": "tinier",
                               "traffic": "onepair", "chips": 1, "why": "t"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("pairs_per_s")][
        "workloads"].append("tinier.onepair")
    bench["per_layer"].append({"name": "requests.count.new", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "pairs_per_s",
                               "workloads": ["tinier.onepair"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    line = run_tiny(root, "tinier.onepair", trace=True)
    assert line["correct"] is True, line["check"]
    assert line["metrics"]["requests.count.new"]["value"] >= 1
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
