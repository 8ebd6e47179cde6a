"""The readings that a cell's comparison limits are set from, in one
process per cell so that set-up is paid once:

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 13 ... \
        [--control-seeds 3] [--plain-seeds 1] [--requests 0 7 15] [--out FILE]

For each seed it makes the cell's inputs as a run does, serves the
requests a run compares (``check_requests`` of them, drawn from the seed,
or the request indices ``--requests`` names) and runs the plain reference
once for each.  It reads `compare`'s numbers for up to three sides:

  program  the program as configured (every seed);
  control  the program with its bfloat16 cost window, the precision below
           the configured float32 (the first ``--control-seeds`` seeds);
  plain    the reference itself with float32 rounded as plain PyTorch
           rounds it (each product and sum rounded apart, `torch.exp`, a
           true division) in the program's place: a sound float32 path
           that rounds otherwise (the first ``--plain-seeds`` seeds).

Beside the numbers at the tolerances of `compare` it gives each side's
pair numbers at a ladder of tolerances (``ladder``).  One JSON line a
seed: ``{"seed", "requests", "program": [...], "control": [...], "plain":
[...]}``, each side a list of the requests' numbers.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import numpy as np
import torch

# (disparity pixels, scene units): the tolerances of the ladder
LADDER = ((0.0, 0.0), (1e-4, 1e-6), (1e-3, 1e-5), (1e-2, 1e-4), (0.1, 1e-3),
          (1.0, 1e-2), (float("inf"), float("inf")))
ROUNDED = ("ops.refine", "ops.ncc_sweep", "stereo.matching", "stereo.triangulate",
           "core.remap", "core.pyramid")


def _fma_plain(a, b, c):
    out = a * b + c
    return out.float() if isinstance(out, torch.Tensor) else torch.tensor(out, dtype=torch.float32)


def _exp_plain(x):
    return torch.exp(x.float())


def _div_plain(x, n):
    return x / n


@contextlib.contextmanager
def plain_rounding():
    """The reference's float32 arithmetic rounded as plain PyTorch rounds
    it, in place of its emulation of the JAX package's compiled rounding."""
    saved = []
    for name in ROUNDED:
        mod = importlib.import_module(f"portbench.reference.{name}")
        for attr, fn in (("fma32", _fma_plain), ("exp_xla", _exp_plain),
                         ("mul_recip", _div_plain)):
            if hasattr(mod, attr):
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _reference_item(ctx, state, i: int):
    """Request ``i`` answered by the reference, in the form a driver's
    `serve` keeps it."""
    if hasattr(state, "takes"):
        from portbench.reference.take import reconstruct_take
        ti = i % len(state.takes)
        t = reconstruct_take(ctx.reference_cfg, state.takes[ti], ctx.device)
        return (ti, [(r.disparity, r.cloud) for r in t.pairs],
                {"vertices": t.vertices, "colors": t.colors, "cloud_xyz": t.cloud_xyz})
    from portbench.reference.stereo.pipeline import match_pair
    pi = i % len(state.pairs)
    p = state.pairs[pi]
    r = match_pair(ctx.reference_cfg, p.image0, p.image1, p.mask0, p.mask1,
                   p.K0, p.Rt0, p.K1, p.Rt1, device=ctx.device)
    return (pi, r.disparity, r.cloud)


def _ladder(state, kept) -> dict:
    """Each pair's numbers at each tolerance of LADDER, the worst over the
    kept requests."""
    from portbench import compare
    triples = []
    for _, item in kept:
        if hasattr(state, "takes"):
            ti, pairs, _ = item
            triples += [(d, c, r) for (d, c), r in zip(pairs, state.refs[ti].pairs)]
        else:
            pi, d, c = item
            triples.append((d, c, state.refs[pi]))
    out = {}
    for dt, xt in LADDER:
        row = compare.worst([compare.pair_numbers(d, c, r, dt, xt) for d, c, r in triples])
        out[f"disp_off_share@{dt:g}"] = row["disp_off_share"]
        out[f"cloud_off_share@{xt:g}"] = row["cloud_off_share"]
    return out


def readings(workload: str, seeds, control_seeds: int, plain_seeds: int = 0,
             requests=None, device="cuda", root=None):
    from portbench import run, spec
    cell = spec.load_cell(workload, root or run.ROOT)
    k = int(cell.traffic["check_requests"])
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ctx = run.make_context(cell, seed, device)
        state = cell.driver.setup(ctx)
        if n == 0:
            # later seeds need no warm-up: nothing is left to build
            cell.traffic = dict(cell.traffic, warmup_requests=0)
        count = len(getattr(state, "pairs", None) or getattr(state, "takes"))
        picks = (list(requests) if requests else
                 [int(i) for i in np.random.default_rng([seed, 0x5eed]).integers(0, count, k)])
        out = {"seed": seed, "requests": picks}
        sides = [("program", ctx)]
        if n < control_seeds:
            sides.append(("control", run.make_context(cell, seed, device, "bfloat16")))
        if n < plain_seeds:
            sides.append(("plain", ctx))
        for name, c in sides:
            if name == "plain":
                with plain_rounding():
                    kept = [(i, _reference_item(c, state, i)) for i in picks]
            else:
                kept = [(i, cell.driver.serve(c, state, i)[1]) for i in picks]
            with run.float32_reference():
                out[name] = [dict(cell.driver.check(c, state, [kp]), ladder=_ladder(state, [kp]))
                             for kp in kept]
            del kept
        out["seconds"] = time.perf_counter() - t0
        yield out
        del state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--plain-seeds", type=int, default=0)
    ap.add_argument("--requests", type=int, nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, args.seeds, args.control_seeds,
                            args.plain_seeds, args.requests):
            line = json.dumps(dict(row, workload=args.workload))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
