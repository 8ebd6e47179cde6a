"""Weak-scaling harness of the pair-sharded stereo program over
torch.distributed: the port's counterpart of the JAX package's
`tools/bench_scaling.py`, with its flags, its recipe and its JSON keys.

Workload: weak scaling, one camera pair a rank.  A world of n ranks
matches P = n synthetic rectified pairs (`bench.synth_pair`, seeded: pair
i is the same pair at every count) through the full recipe (brute level
0, guided above, both directions, refine 6+6*level) with
`parallel/sharded.match_level_pairs_sharded`, level by level, on a
(frame, pair, tile) mesh of (1, n, 1) (`--axis frame`: (n, 1, 1)).  Each
rank builds the pyramids of its own pairs and rounds every level to the
uint8 grid (`quantize_u8`), as `match_pair` does: K1 and K3 take only
images on that grid.  On the card every rank runs K1 (`ncc_sweep`), K3
(`cost_volume`) and K2 (`refine_sweeps_fused`).

    python -m reconstruction_tpu_torch.tools.bench_scaling            # the card
    python -m reconstruction_tpu_torch.tools.bench_scaling --device cpu
    python -m reconstruction_tpu_torch.tools.bench_scaling --base 240 160 \\
        --levels 4 --counts 1 2 4 --repeats 2 --json scaling.json

Each world is n local processes (`parallel/launch.run_local`), one rank
each.  One backend serves every count of a run, so that the first count,
which the efficiencies divide by, shares the collective path of the
counts held against it: NCCL where every rank of the largest world has a
card of its own, else gloo (NCCL refuses two ranks on one card);
`--backend` forces either.  A count above the host's cores (one process a
rank) is skipped with its reason.  Ranks that share a card time-slice it, so on one card `wall_s`
is not a scaling figure; on a host with n cards the same invocation
reports true scaling.  What one card can pin is the program: whether the
device work per pair stays the same as the world widens.

Timing, a world at a time: one warm recipe, then ``repeats`` timed ones,
each framed by a barrier and a device synchronize on every rank; a
repeat's wall is its slowest rank's, and the best repeat counts.  One
more recipe runs under torch.profiler on the card.

Prints one JSON line a count (`--json out.json` also writes the list):
the JAX tool's keys, with their meaning (axis, devices, pairs, finest,
levels, wall_s, views_per_sec = 2P / wall, cpu_s_per_pair: the ranks'
summed process CPU seconds over P, wall_eff_vs_host_bound, cpu_eff),
and
  backend, cards, card   the process group's backend, the distinct cards
                         the world used, the card's name and power limit;
  launches_per_pair      K1, K3 and K2 launches, summed over the ranks, over
                         P (on the CPU the calls of their plain versions,
                         which launch nothing: `launches_from`);
  kernel_ms_per_pair     the profiler's device time of those kernels,
                         summed over the ranks, over P (null on the CPU);
  dev_eff                the first count's kernel_ms_per_pair over this
                         one's: the card's counterpart of cpu_eff;
  wall_eff_vs_card_bound the first count's wall x n / min(n, cards) over
                         this wall;
  comm_bytes             bytes the ranks sent in collectives in one recipe
                         (`parallel/mesh.COMM`), summed;
  digest                 one hash a pair of its final disparities (disp0,
                         disp1), in pair order.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from reconstruction_tpu_torch.bench import synth_pair

# The recipe's kernels: the wrapper whose launches count, and a substring
# of the kernel's name as the profiler reports it.
KERNELS = {"ncc_sweep": "ncc_sweep_kernel", "cost_volume": "cost_volume_kernel",
           "refine_sweeps_fused": "refine_sweeps_kernel"}


def _log(msg: str) -> None:
    print(f"[scaling] {msg}", file=sys.stderr, flush=True)


def make_batch(P: int, H: int, W: int):
    """P pairs from a fresh `default_rng(0)`: images (P, H, W, 3) and masks
    (P, H, W), float32 numpy."""
    rng = np.random.default_rng(0)
    pairs = [synth_pair(H, W, rng) for _ in range(P)]
    return tuple(np.stack(a) for a in zip(*pairs))


def host_cores() -> int:
    """Cores this process may run on."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def choose_backend(n: int, device: str, backend: str = "auto") -> str:
    """The process group's backend for a run whose largest world has ``n``
    ranks: NCCL when each of its ranks has a card of its own, else gloo
    (ranks sharing a card, or the CPU).  A forced NCCL world on too few
    cards raises."""
    if backend not in ("auto", "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}; one of auto, gloo, nccl")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices; the CPU runs gloo")
        return "gloo"
    cards = torch.cuda.device_count()
    if backend == "auto":
        return "nccl" if n <= cards else "gloo"
    if backend == "nccl" and n > cards:
        raise ValueError(f"a world of {n} NCCL ranks needs {n} cards; this host "
                         f"has {cards} (NCCL refuses two ranks on one card); "
                         "pass --backend gloo to share them")
    return backend


def pair_digests(state) -> List[str]:
    """One sha256 a pair of its final disparities (disp0, then disp1)."""
    out = []
    for d0, d1 in zip(state.disp0, state.disp1):
        h = hashlib.sha256()
        for d in (d0, d1):
            a = np.ascontiguousarray(d.detach().cpu().numpy(), np.float32)
            h.update(f"{a.shape}".encode() + a.tobytes())
        out.append(h.hexdigest()[:16])
    return out


def level_kw(level: int) -> dict:
    """The JAX tool's options for ``level``: refine 6 + 6 * level, the rest
    `match_one_level`'s defaults."""
    return dict(refine_iters=6 + 6 * level)


def quantized_pyramids(img: torch.Tensor, levels: int) -> list:
    from reconstruction_tpu_torch.ops.pyramid import build_pyramid
    return build_pyramid(img, levels, quantize=True)


def recipe(mesh, axis: str, imgs0, imgs1, masks, levels: int):
    """The full recipe over the mesh's ``axis``; returns the final
    LevelState of all P pairs, on every rank.  A rank builds the pyramids
    of its own block of pairs only: `match_level_pairs_sharded` reads no
    other lane, so the others stay zero."""
    from reconstruction_tpu_torch.parallel.mesh import axis_rank, axis_size, block_lanes
    from reconstruction_tpu_torch.parallel.sharded import match_level_pairs_sharded

    P = imgs0.shape[0]
    lanes, _ = block_lanes(P, axis_size(mesh, axis), axis_rank(mesh, axis))
    stacks = []
    for batch in (imgs0, imgs1, masks):
        mine = {i: quantized_pyramids(batch[i], levels) for i in set(lanes)}
        per_level = []
        for level in range(levels):
            like = mine[lanes[0]][level]
            t = torch.zeros((P,) + tuple(like.shape), dtype=like.dtype, device=like.device)
            for i, pyr in mine.items():
                t[i] = pyr[level]
            per_level.append(t)
        stacks.append(per_level)
    p0, p1, pm = stacks
    state = None
    for level in range(levels):
        state = match_level_pairs_sharded(mesh, p0[level], p1[level], pm[level], pm[level],
                                          state, level, axis=axis, **level_kw(level))
    return state


def reference_digests(P: int, levels: int, base_wh, device="cuda") -> List[str]:
    """`pair_digests` of the recipe as a chain of `match_one_level` calls,
    pair by pair in this process (no mesh): what every world must give."""
    from reconstruction_tpu_torch.stereo.pipeline import LevelState, match_one_level
    W0, H0 = base_wh
    imgs0, imgs1, masks = make_batch(P, H0 << (levels - 1), W0 << (levels - 1))
    finals = []
    for i in range(P):
        p0, p1, pm = (quantized_pyramids(torch.as_tensor(b[i], device=device), levels)
                      for b in (imgs0, imgs1, masks))
        state = None
        for level in range(levels):
            state = match_one_level(p0[level], p1[level], pm[level], pm[level], state,
                                    level, **level_kw(level))
        finals.append(state)
    return pair_digests(LevelState(disp0=torch.stack([s.disp0 for s in finals]),
                                   disp1=torch.stack([s.disp1 for s in finals])))


def _kernel_launches() -> collections.Counter:
    """The three wrappers' launch counters (all element types summed)."""
    from reconstruction_tpu_torch.ops import ncc_sweep as k13
    from reconstruction_tpu_torch.ops import refine as k2
    return collections.Counter(
        ncc_sweep=k13.ncc_sweep.launches,
        cost_volume=sum(k13.cost_volume.launches.values()),
        refine_sweeps_fused=sum(k2.refine_sweeps_fused.launches.values()))


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the three kernels' plain versions while the
    block runs (the wrappers count only launches, and on the CPU they
    launch nothing)."""
    from reconstruction_tpu_torch.ops import ncc_sweep as k13
    from reconstruction_tpu_torch.ops import refine as k2
    counts = collections.Counter()

    def counting(fn, name):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    saved = {}
    for mod, name in ((k13, "ncc_sweep"), (k13, "cost_volume"), (k2, "refine_sweeps_fused")):
        fn = saved[mod, name + "_plain"] = getattr(mod, name + "_plain")
        setattr(mod, name + "_plain", counting(fn, name))
    try:
        yield counts
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _all_ranks(obj) -> list:
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def profiled_kernel_ms(run, launches: dict, sessions: int = 4):
    """Device milliseconds of the recipe's kernels in one ``run``, from
    torch.profiler's CUDA activity: a session runs the recipe twice (the
    profiler on the card's machine drops a session's first events) and
    sums the last ``launches[k]`` kernels of each name it recorded, read
    raw (`utils/profiling.cuda_activity`).  A session that recorded fewer
    runs again, on every rank together (the recipe holds collectives).  Returns (ms, sessions run); ms is None
    after ``sessions`` such sessions."""
    from torch.profiler import ProfilerActivity, profile

    from reconstruction_tpu_torch.utils.profiling import cuda_activity
    for k in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            run()
            torch.cuda.synchronize()
        events = cuda_activity(prof)
        ms = 0.0
        for name, sub in KERNELS.items():
            n = launches.get(name, 0)
            hits = [e for e in events if sub in e.name()][-n:] if n else []
            if len(hits) < n:
                ms = None
                break
            ms += sum(e.duration_ns() for e in hits) / 1e6
        if all(v is not None for v in _all_ranks(ms)):
            return ms, k
    return None, sessions


def _rank(axis: str, P: int, levels: int, H: int, W: int, repeats: int,
          device: str) -> dict:
    """One rank of a world (a `run_local` child): the batch, a warm
    recipe, ``repeats`` timed ones, then one under the profiler."""
    import torch.distributed as dist
    from reconstruction_tpu_torch.parallel.mesh import COMM, make_mesh

    cuda = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    n = dist.get_world_size()
    shape = dict(frame=1, pair=n, tile=1) if axis == "pair" else dict(frame=n, pair=1, tile=1)
    t0 = time.perf_counter()
    mesh = make_mesh(**shape, device=dev.type)
    batch = [torch.as_tensor(a, device=dev) for a in make_batch(P, H, W)]
    seconds = dict(setup=time.perf_counter() - t0)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run():
        return recipe(mesh, axis, *batch, levels)

    t0 = time.perf_counter()
    run()
    sync()
    seconds["warm"] = time.perf_counter() - t0
    walls, cpus = [], []
    for _ in range(repeats):
        dist.barrier()
        sync()
        before, comm0 = _kernel_launches(), COMM.bytes
        with plain_calls() as plain:
            t0, c0 = time.perf_counter(), time.process_time()
            state = run()
            sync()
            walls.append(time.perf_counter() - t0)
            cpus.append(time.process_time() - c0)
        kernels = _kernel_launches() - before
        comm = COMM.bytes - comm0
    launches = dict(kernels) if cuda else dict(plain)
    t0 = time.perf_counter()
    kernel_ms, seconds["sessions"] = profiled_kernel_ms(run, launches) if cuda else (None, 0)
    seconds["profile"] = time.perf_counter() - t0
    return dict(walls=walls, cpus=cpus, launches=launches, comm_bytes=comm,
                kernel_ms=kernel_ms, device=str(dev), digest=pair_digests(state),
                seconds=seconds)


def efficiencies(base: dict, rec: dict, cores: int) -> dict:
    """The four efficiencies of ``rec`` against the first count's record
    ``base``: the JAX tool's two (its formulas) and the card's two."""
    n = rec["devices"]
    out = dict(
        wall_eff_vs_host_bound=base["wall_s"] * n / min(n, cores) / rec["wall_s"],
        cpu_eff=base["cpu_s_per_pair"] / rec["cpu_s_per_pair"],
        wall_eff_vs_card_bound=None, dev_eff=None)
    if rec["cards"]:
        out["wall_eff_vs_card_bound"] = (base["wall_s"] * n / min(n, rec["cards"])
                                         / rec["wall_s"])
    if base["kernel_ms_per_pair"] and rec["kernel_ms_per_pair"]:
        out["dev_eff"] = base["kernel_ms_per_pair"] / rec["kernel_ms_per_pair"]
    return out


def run_axis(axis: str, counts, levels: int, base_wh, repeats: int, device="cuda",
             backend: str = "auto") -> List[dict]:
    """One JSON record a count of ``counts`` (printed as it comes), each
    count a fresh world of that many ranks (`_rank`), all on the backend
    the largest world needs; the efficiencies are against the first count
    that ran."""
    from reconstruction_tpu_torch.parallel.launch import run_local
    # By its importable name: under `python -m` this module is __main__,
    # which a `run_local` child cannot import.
    from reconstruction_tpu_torch.tools.bench_scaling import _rank as rank_fn
    from reconstruction_tpu_torch.utils.profiling import card_line

    if axis not in ("pair", "frame"):
        raise ValueError(f"axis {axis!r}; one of pair, frame")
    if repeats < 1:
        raise ValueError(f"repeats {repeats}; at least 1 timed recipe")
    device = torch.device(device).type
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the scaling harness runs on the card and found no CUDA "
                               "device; pass --device cpu to run it on the CPU")
        from reconstruction_tpu_torch.ops import _build
        _build.load()           # once here, before the ranks load it
    W0, H0 = base_wh
    Wf, Hf = W0 << (levels - 1), H0 << (levels - 1)
    card = card_line(device)
    cores = host_cores()
    for n in counts:
        if n > cores:
            _log(f"count {n} skipped: {n} ranks exceed the host's {cores} cores "
                 f"(one process a rank)")
    counts = [n for n in counts if n <= cores]
    if not counts:
        return []
    be = choose_backend(max(counts), device, backend)
    _log(f"backend {be} at every count (the largest world: {max(counts)} ranks)")
    results = []
    for n in counts:
        P = n       # weak scaling: one pair a rank
        t0 = time.perf_counter()
        ranks = run_local(rank_fn, n, device, axis, P, levels, Hf, Wf, repeats, device,
                          backend=be)
        sec = ranks[0]["seconds"]
        _log(f"count {n}: the world took {time.perf_counter() - t0:.1f} s; rank 0's "
             f"set-up {sec['setup']:.1f} s, warm recipe {sec['warm']:.1f} s, profile "
             f"{sec['profile']:.1f} s in {sec['sessions']} session(s)")
        digest = ranks[0]["digest"]
        if any(r["digest"] != digest for r in ranks):
            raise AssertionError(f"count {n}: the ranks hold different final states")
        wall = min(max(r["walls"][i] for r in ranks) for i in range(repeats))
        cpu = min(sum(r["cpus"][i] for r in ranks) for i in range(repeats))
        launches = collections.Counter()
        for r in ranks:
            launches.update(r["launches"])
        kms = [r["kernel_ms"] for r in ranks]
        rec = {"axis": axis, "devices": n, "pairs": P, "finest": [Wf, Hf],
               "levels": levels, "wall_s": wall, "views_per_sec": 2 * P / wall,
               "cpu_s_per_pair": cpu / P, "backend": be,
               "cards": len({r["device"] for r in ranks if r["device"].startswith("cuda")}),
               "card": card,
               "launches_per_pair": {k: launches[k] / P for k in KERNELS},
               "launches_from": "kernels" if device == "cuda" else "plain calls",
               "kernel_ms_per_pair": (None if None in kms else sum(kms) / P),
               "comm_bytes": sum(r["comm_bytes"] for r in ranks),
               "digest": digest}
        rec.update(efficiencies(results[0] if results else rec, rec, cores))
        results.append(rec)
        print(json.dumps(rec), flush=True)
    return results


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=device, choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="auto", choices=["auto", "gloo", "nccl"])
    ap.add_argument("--axis", default="pair", choices=["pair", "frame"])
    ap.add_argument("--both", action="store_true",
                    help="run the pair AND frame axis variants")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--base", type=int, nargs=2, default=(80, 60), metavar=("W", "H"))
    ap.add_argument("--counts", type=int, nargs="+", default=(1, 2, 4, 8))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    axes = ["pair", "frame"] if args.both else [args.axis]
    results = []
    for ax in axes:
        results += run_axis(ax, args.counts, args.levels, tuple(args.base), args.repeats,
                            args.device, args.backend)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
