"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run finds its cell in `BENCHMARK.json` and the files the cell names
(`spec.load_cell`), then:

  1. set-up: imports the port and builds or loads its kernel library
     (cached in `reconstruction_tpu_torch/_build/` inside the checkout),
     renders the cell's inputs on the card from the seed (`scene`), and
     warms the path up with the cell's own shapes (the traffic's driver);
  2. the window: the driver's requests back to back, a closed loop with
     one client, until ``--seconds`` have passed; the window ends at the
     end of the last request.  With ``--trace 1`` the profiler records
     the window (`trace`), and the per-layer metrics' `collect` hooks run
     after it;
  3. the peak device memory is read, what the program made is freed but
     for a sample of the window's answers drawn from the seed, and the
     driver's `check` runs the plain reference (`reference/`) on the
     sample (`compare`);
  4. the line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
     cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
     each read by `metrics/<name>.py`), ``device``, with ``--trace 1``
     ``breakdown``, and last ``check``, every compared number beside its
     limit (also the last lines on standard error).

It exits non-zero, printing no line, without a CUDA device or with fewer
than the cell asks for, and when the JAX package or JAX itself has been
loaded.  ``--control bfloat16`` runs the program with its bfloat16 cost
window, the lower precision that the comparison has to refuse.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import resource
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch


def _process_seconds() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


_T0 = time.perf_counter()
_AGE0 = _process_seconds() or 0.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "reconstruction_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def since_start() -> float:
    return _AGE0 + (time.perf_counter() - _T0)


def host_reading() -> Dict[str, float]:
    """This process's CPU seconds, page faults and context switches, and
    the machine's CPU time stolen by its host (jiffies, /proc/stat)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "minor_faults": ru.ru_minflt,
           "major_faults": ru.ru_majflt, "voluntary_switches": ru.ru_nvcsw,
           "involuntary_switches": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            jiffies = [float(v) for v in f.readline().split()[1:]]
        out["steal_jiffies"], out["all_jiffies"] = jiffies[7], sum(jiffies)
    except (OSError, IndexError, ValueError):
        pass
    return out


def host_change(before: Dict[str, float], seconds: float) -> Dict[str, float]:
    """What `host_reading` counted since ``before``, over ``seconds`` of
    wall time: CPU seconds per second, and the share of the machine's
    CPU time that its host stole."""
    now = host_reading()
    out = {k: round(now[k] - before[k], 3) for k in before if k in now}
    out["cpu_per_wall"] = round(out["cpu_s"] / max(seconds, 1e-9), 3)
    if "all_jiffies" in out:
        out["steal_share"] = round(out.pop("steal_jiffies") / max(out.pop("all_jiffies"), 1.0), 4)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a driver sees of the run."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    program_cfg: object
    reference_cfg: object

    @property
    def finest_size(self):
        w, h = self.config["lowest_level_size"]
        s = 1 << (int(self.config["pyramid_levels"]) - 1)
        return (w * s, h * s)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_context(cell, seed: int, device, control: Optional[str] = None) -> Context:
    from reconstruction_tpu_torch import config as program_config
    from portbench.reference import config as reference_config
    from portbench.spec import build_config
    over = {} if control is None else {"refine_cv_dtype": control}
    return Context(config=cell.config, traffic=cell.traffic, seed=seed,
                   device=torch.device(device),
                   program_cfg=build_config(program_config, cell.config, **over),
                   reference_cfg=build_config(reference_config, cell.config))


@contextlib.contextmanager
def float32_reference():
    """The reference computes float32 in float32: no TF32 in its matrix
    products or convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reservoir:
    """A uniform sample of ``k`` of a stream of unknown length, drawn from
    the seed, holding no more than ``k`` items at a time."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng([seed, 0x5eed])

    def offer(self, index: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append((index, item))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (index, item)
        self.seen += 1


def run_window(ctx: Context, driver, state, seconds: float, keep: Reservoir):
    """Requests back to back until ``seconds`` have passed; returns (the
    requests' records, the window's seconds, failures)."""
    records, failed = [], 0
    t_start = time.perf_counter()
    i = 0
    while True:
        t0, c0 = time.perf_counter(), time.thread_time()
        try:
            rec, item = driver.serve(ctx, state, i)
        except Exception as exc:  # a failed request is counted, and the run is not correct
            log(f"request {i} failed: {type(exc).__name__}: {exc}")
            failed += 1
            rec, item = None, None
        t1 = time.perf_counter()
        if rec is not None:
            rec["wall_s"] = t1 - t0
            rec["thread_cpu_s"] = time.thread_time() - c0
            records.append(rec)
            keep.offer(i, item)
        i += 1
        if t1 - t_start >= seconds:
            return records, t1 - t_start, failed


def device_info(chips: int, device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             control: Optional[str] = None, root: str = ROOT) -> Dict:
    """One run of ``workload``; returns the result line as a dict."""
    from portbench import compare, costs, spec
    from portbench import trace as tracing

    cell = spec.load_cell(workload, root)
    dev = torch.device(device)
    log(f"cell {cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, "
        f"seed {seed}, {seconds} s, trace {int(trace)}"
        + (f", control {control}" if control else "")
        + (f", card {costs.card_line()}" if dev.type == "cuda" else "")
        + f", {len(os.sched_getaffinity(0))} cores, {torch.get_num_threads()} torch threads")
    import reconstruction_tpu_torch.pipeline.reconstruct  # noqa: F401  (the port's imports)
    if dev.type == "cuda":
        from reconstruction_tpu_torch.ops import _build
        _build.load()
    ctx = make_context(cell, seed, dev, control)
    state = cell.driver.setup(ctx)
    ctx.sync()
    setup_s = since_start()
    log(f"set-up {setup_s:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    keep = Reservoir(int(cell.traffic["check_requests"]), seed)
    prof = tracing.profiler() if trace else contextlib.nullcontext()
    host0 = host_reading()
    with prof:
        records, window_s, failed = run_window(ctx, cell.driver, state, seconds, keep)
    host = host_change(host0, window_s)
    info = device_info(cell.chips, dev)
    log(f"window {window_s:.3f} s, {len(records)} requests, {failed} failed; "
        f"seconds a request {[round(r['wall_s'], 3) for r in records]}")
    log(f"main thread's CPU seconds a request "
        f"{[round(r['thread_cpu_s'], 3) for r in records]}; host over the window {host}")
    if records and records[0].get("level_ms"):
        log(f"level seconds a request {[round(sum(r['level_ms']) / 1e3, 3) for r in records]}")
    if records and "spans" in records[0]:
        log(f"spans of the last request {records[-1]['spans']}")

    record = {"setup_s": setup_s, "window_s": window_s, "requests": records,
              "trace": None, "collected": {}}
    breakdown = None
    if trace:
        summary = tracing.summarize(prof)
        record["trace"] = summary
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = window_s
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        del prof
        for m in cell.per_layer:
            if hasattr(m.reader, "collect"):
                t0 = time.perf_counter()
                record["collected"][m.name] = m.reader.collect(ctx)
                log(f"{m.name}: {record['collected'][m.name]} "
                    f"({time.perf_counter() - t0:.1f} s)")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with float32_reference():
        numbers = cell.driver.check(ctx, state, keep.items) if keep.items else {}
    log(f"comparison of requests {[i for i, _ in keep.items]}: "
        f"{time.perf_counter() - t0:.1f} s")
    ok, checked = compare.judge(numbers, cell.limits)
    line = {"correct": bool(ok and failed == 0 and records), "attempted": len(records) + failed,
            "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = checked
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bfloat16",), default=None,
                    help="run the program with its bfloat16 cost window")
    args = ap.parse_args(argv)

    from portbench import spec
    chips = spec.load_cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    control=args.control)
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the port must not load: {bad}")
        return 3
    for name, c in line["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
