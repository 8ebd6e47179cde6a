"""What a cell is made of, found by name: its entry in `BENCHMARK.json`,
its configuration (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`, which names its driver, `drivers/<driver>.py`), the
readers of its metrics (`metrics/<metric>.py`) and the limits of its
comparison (`limits/<cell>.json`).  Adding a cell, a configuration, a mix
or a metric adds files; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str, what: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file at ``path`` as a module of its own."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    stem = re.sub(r"\W", "_", os.path.relpath(path, HERE))
    spec = importlib.util.spec_from_file_location(f"portbench_file_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    reader: object            # the module of metrics/<name>.py


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    driver: object
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    limits: Optional[Dict[str, float]] = None


def _reports(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", (cell,))


def load_cell(workload: str, root: str) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json, with the files it
    names under this package."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic_name = _checked(w["traffic"], "traffic")
    traffic = load_json(os.path.join(HERE, "traffic", f"{traffic_name}.json"))
    driver = load_module(os.path.join(HERE, "drivers", f"{_checked(traffic['driver'], 'driver')}.py"))

    def metric(entry):
        name = _checked(entry["name"], "metric")
        return Metric(name=name, unit=entry["unit"],
                      reader=load_module(os.path.join(HERE, "metrics", f"{name}.py")))

    e2e = [metric(m) for m in bench["end_to_end"] if _reports(m, workload)]
    per_layer = [metric(m) for m in bench["per_layer"] if _reports(m, workload)]
    limits_path = os.path.join(HERE, "limits", f"{_checked(workload, 'workload')}.json")
    limits = load_json(limits_path)["limits"] if os.path.exists(limits_path) else None
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=traffic_name, traffic=traffic, driver=driver,
                end_to_end=e2e, per_layer=per_layer, limits=limits)


def build_config(module, config: dict, **stereo_overrides):
    """``module``'s ReconstructionConfig (the port's `config` module or the
    reference's frozen copy) from a configuration file's sizes."""
    stereo = dict(config["stereo"], **stereo_overrides)
    return module.ReconstructionConfig(
        pyramid_levels=int(config["pyramid_levels"]),
        lowest_level_size=tuple(config["lowest_level_size"]),
        cam_pairs=tuple(tuple(p) for p in config["cam_pairs"]),
        stereo=module.StereoParams(**stereo),
        cloud=module.CloudParams(**config["cloud"]),
        surface=module.SurfaceParams(**config["surface"]))
