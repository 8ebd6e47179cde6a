"""Cycles by phase of K6 (ordering) and K7 (bound propagation) on the card,
from clock64 marks that this script adds to a copy of
`csrc/constraints.cu` (the kernels themselves carry none).

    python3 reconstruction_tpu_torch/tools/k67_phase_clocks.py [--package DIR]

DIR is a directory that holds a `reconstruction_tpu_torch` package (default:
the one beside this script).  The marks fit both designs of the kernels:
the sequential one (K6: O(V^2) initial counts, a block-wide greedy loop;
K7: a thread walks a column, two threads a row) and the segment design (K6: a merge
count, the greedy loop over the crossing points alone; K7: max-plus
segment functions folded, scanned and replayed), so an unpacked earlier tree is
measured with the same script.  The copy goes to this package's
`_build/k67_clocks/` (ignored by git), is built, and runs on the inputs
that one `match_pair` gives K6 and K7 at its finest level, both
directions, for the `myself` preset (1920x1280) and the `dome32` preset's
pair (0, 1) (2160x3840).  Thread 0 of each block adds the cycles since its
previous mark (after a barrier of the block, so a phase holds the slowest
thread's time up to it; the redesigned row pass has no block barrier, so
there it is the first warp's own time):

  K6   compact   the row copied, its valid points compacted
       count     the initial crossing counts
       greedy    the greedy loop, to its end (also its steps and V)
  K7   columns   sequential: down, up (a column's chains);
                 segments: fold, scan, replay
       rows      sequential: stage, chains, store;
                 segments: stage, fold, scan, replay, store

Each phase is printed as its mean and largest cycles a block and its share
of all blocks' cycles.  K6 is read twice: as launched (several blocks an
SM, whose phases then hold the waits for issue slots that their
neighbours take) and with its shared memory raised so that one block runs
on an SM (each phase its own latency).  Needs a CUDA device and nvcc, like
the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
OUT = PKG / "_build" / "k67_clocks"
NBLK = 8192
SLOTS = 8
KERNELS = ("k6", "k7c", "k7r")
PHASES = {
    "sequential": {"k6": ("compact", "count", "greedy"), "k7c": ("down", "up"),
             "k7r": ("stage", "chains", "store")},
    "segments": {"k6": ("compact", "count", "greedy"), "k7c": ("fold", "scan", "replay"),
                 "k7r": ("stage", "fold", "scan", "replay", "store")},
}

_HEAD = ("namespace {\n",
         "".join(f"__device__ long long {k}_dbg[{NBLK} * {SLOTS}];\n" for k in KERNELS)
         + "namespace {\n")


def _mark(kernel: str, sync: str, tid: str) -> str:
    """Thread ``tid`` of the block keeps the phases in registers and writes
    them once, at ``flush``; ``mark`` runs ``sync`` first."""
    return (f"  long long k67_tick = clock64(), k67_ph[{SLOTS}] = {{0}};\n"
            f"  auto mark = [&](int k) {{\n    {sync}\n"
            f"    if ({tid} == 0) {{ const long long n = clock64(); k67_ph[k] += n - k67_tick;"
            " k67_tick = n; }\n  };\n"
            "  auto flush = [&](long long a, long long b) {\n"
            f"    if ({tid} == 0 && blockIdx.x < {NBLK}) {{\n"
            f"      long long* o = {kernel}_dbg + (size_t)blockIdx.x * {SLOTS};\n"
            f"      for (int k = 0; k < {SLOTS} - 2; ++k) o[k] = k67_ph[k];\n"
            f"      o[{SLOTS} - 2] = a; o[{SLOTS} - 1] = b;\n    }}\n  }};\n")


# K6's dynamic shared memory is raised to ALONE_SMEM bytes for the "one
# block an SM" reading (rtt_k67_alone), so that its blocks' phases are
# their own and not their SM neighbours' issue slots.
ALONE_SMEM = 120 * 1024
_ENTRY = ("RTT_API int rtt_ordering(",
          "RTT_API int rtt_k67_clocks(int which, void* host) {\n"
          + "".join(f"  if (which == {i}) return (int)cudaMemcpyFromSymbol(host, {k}_dbg, "
                    f"sizeof(long long) * {NBLK} * {SLOTS});\n" for i, k in enumerate(KERNELS))
          + "  return (int)cudaErrorInvalidValue;\n}\n\n"
          "RTT_API int rtt_k67_reset() {\n"
          + "".join(f"  {{ static long long z[{NBLK} * {SLOTS}];\n"
                    f"    cudaError_t e = cudaMemcpyToSymbol({k}_dbg, z, sizeof(z));\n"
                    "    if (e != cudaSuccess) return (int)e; }\n" for k in KERNELS)
          + "  return 0;\n}\n\n"
          "static size_t k67_min_smem = 0;\n"
          "RTT_API int rtt_k67_alone(int bytes) {\n  k67_min_smem = (size_t)bytes;\n"
          "  return 0;\n}\n\nRTT_API int rtt_ordering(")


def _smem_floor(line: str) -> tuple:
    """K6's launch asks for at least k67_min_smem bytes."""
    lhs, rhs = line.split(" = ", 1)
    rhs = rhs.rstrip(";\n")
    return (line, f"{lhs} = ({rhs}) > k67_min_smem ? ({rhs}) : k67_min_smem;\n")


_K6_START = ("  float* orow = out + (size_t)y * W;\n",
             "  float* orow = out + (size_t)y * W;\n" + _mark("k6", "__syncthreads();", "tid"))
_K6_COMPACT = ("  if (V == 0) return;\n", "  mark(0);\n  if (V == 0) { flush(0, 0); return; }\n")
_K6_COUNT = ("  // The greedy loop:", "  mark(1);\n  // The greedy loop:")
_K7R_START = ("  const size_t row = (size_t)y * W;\n", "  const size_t row = (size_t)y * W;\n")
def _k7r_end(k: int, b: str, end: str) -> tuple:
    """The row pass's last lines ``end``, then mark ``k`` and the flush."""
    return (end, end[:-2] + f"  mark({k});\n  flush(W, {b});\n}}\n")

# (anchor, replacement) pairs of each design.
MARKS = {
    "sequential": [
        _HEAD, _K6_START, _K6_COMPACT, _K6_COUNT,
        ("    if (key < 0x10000) break;",
         "    if (key < 0x10000) { mark(2); flush(step, V); break; }"),
        _smem_floor("  const size_t smem = (size_t)W * (sizeof(float) + sizeof(int) + "
                    "sizeof(unsigned short));\n"),
        # K7's column pass: a warp a block, thread 0 walks its column.
        ("  const bool in_col = box.col(x);\n",
         "  const bool in_col = box.col(x);\n" + _mark("k7c", "", "threadIdx.x")),
        ("  // Up: combined", "  mark(0);\n  // Up: combined"),
        ("        BR[p] = fminf(dn_hi[u], up_hi);\n      }\n"
         "      const K7Vertical s = k7_vertical(d[u], mask, MD);\n"
         "      c_lo = fmaxf(__fadd_rn(c_lo, s.s_lo), s.m_lo);\n"
         "      c_hi = fminf(__fadd_rn(c_hi, s.s_hi), s.m_hi);\n    }\n  }\n",
         "        BR[p] = fminf(dn_hi[u], up_hi);\n      }\n"
         "      const K7Vertical s = k7_vertical(d[u], mask, MD);\n"
         "      c_lo = fmaxf(__fadd_rn(c_lo, s.s_lo), s.m_lo);\n"
         "      c_hi = fminf(__fadd_rn(c_hi, s.s_hi), s.m_hi);\n    }\n  }\n"
         "  mark(1);\n  flush(H, 1);\n"),
        # K7's row pass: a block a row.
        (_K7R_START[0], _K7R_START[1] + _mark("k7r", "__syncthreads();", "threadIdx.x")),
        ("    mk[x] = valid[row + x] && box.row(y) && box.col(x);\n  }\n  __syncthreads();\n",
         "    mk[x] = valid[row + x] && box.row(y) && box.col(x);\n  }\n  mark(0);\n"),
        ("    k7_row_chains<false>(br, mk, MD, 1.0f, (float)*ptXR, W);\n  __syncthreads();\n",
         "    k7_row_chains<false>(br, mk, MD, 1.0f, (float)*ptXR, W);\n  mark(1);\n"),
        _k7r_end(2, "1", "    BR[row + x] = br[x];\n  }\n}\n"),
        _ENTRY,
    ],
    "segments": [
        _HEAD, _K6_START, _K6_COMPACT, _K6_COUNT,
        ("  if (NA == 0) return;\n", "  if (NA == 0) { mark(2); flush(0, V); return; }\n"),
        ("    if (key < 0x10000) break;",
         "    if (key < 0x10000) { mark(2); flush(step, V); break; }"),
        _smem_floor("  const size_t smem = (size_t)W * K6_BYTES_PER_COLUMN;\n"),
        # K7's column pass: thread 0 of the block, at the block's barriers.
        ("    return k7_vertical(d, v && in_col && box.row(y), MD);\n  };\n",
         "    return k7_vertical(d, v && in_col && box.row(y), MD);\n  };\n"
         + _mark("k7c", "__syncthreads();", "threadIdx.x")),
        ("  sfn[3][c][seg] = uh;\n  __syncthreads();\n", "  sfn[3][c][seg] = uh;\n  mark(0);\n"),
        ("    else k7_segment_carries<false, true>(f, lane);\n  }\n  __syncthreads();\n",
         "    else k7_segment_carries<false, true>(f, lane);\n  }\n  mark(1);\n"),
        ("      const K7Vertical s = k7_vertical(d[u], mask[u], MD);\n"
         "      c_lo = k7_apply<true>(s.lo, c_lo);\n"
         "      c_hi = k7_apply<false>(s.hi, c_hi);\n    }\n  }\n}\n",
         "      const K7Vertical s = k7_vertical(d[u], mask[u], MD);\n"
         "      c_lo = k7_apply<true>(s.lo, c_lo);\n"
         "      c_hi = k7_apply<false>(s.hi, c_hi);\n    }\n  }\n"
         "  mark(2);\n  flush(L, K7C_SEGS);\n}\n"),
        # K7's row pass: warp 0 of the block (its row), lane 0.
        (_K7R_START[0], _K7R_START[1] + _mark("k7r", "__syncwarp();", "threadIdx.x")),
        ("  __syncwarp();\n  const int x0 = min(lane * run, W)",
         "  mark(0);\n  const int x0 = min(lane * run, W)"),
        ("  float cl = k7_lane_carry<true, false>(fl, lane);\n",
         "  mark(1);\n  float cl = k7_lane_carry<true, false>(fl, lane);\n"),
        ("  Fn gl = k7_ident<true>(), gh = k7_ident<false>();\n",
         "  mark(2);\n  Fn gl = k7_ident<true>(), gh = k7_ident<false>();\n"),
        ("  cl = k7_lane_carry<true, true>(gl, lane);\n  ch = k7_lane_carry<false, true>(gh, lane);\n",
         "  mark(3);\n  cl = k7_lane_carry<true, true>(gl, lane);\n"
         "  ch = k7_lane_carry<false, true>(gh, lane);\n  mark(2);\n"),
        ("  __syncwarp();\n#pragma unroll 8\n  for (int x = lane; x < W; x += 32) {\n"
         "    BL[row + x] = bl[x];",
         "  mark(3);\n#pragma unroll 8\n  for (int x = lane; x < W; x += 32) {\n"
         "    BL[row + x] = bl[x];"),
        _k7r_end(4, "run", "    BR[row + x] = br[x];\n  }\n}\n"),
        _ENTRY,
    ],
}


def keep_constraint_calls(run, shape):
    """``run()`` with the pair path's `ordering_constraint` and
    `propagate_bounds` wrapped so that their calls on an (H, W) = ``shape``
    disparity (the finest level, both directions) are kept, inputs and
    output: returns (``run()``, {name: [(args, output), ...]})."""
    from reconstruction_tpu_torch.stereo import pipeline
    names = ("ordering_constraint", "propagate_bounds")
    real = {n: getattr(pipeline, n) for n in names}
    kept = {n: [] for n in names}

    def keeping(name):
        def call(*args):
            out = real[name](*args)
            if tuple(args[0].shape) == shape:
                kept[name].append((args, out))
            return out
        return call

    for n in names:
        setattr(pipeline, n, keeping(n))
    try:
        res = run()
    finally:
        for n, fn in real.items():
            setattr(pipeline, n, fn)
    if not all(len(v) == 2 for v in kept.values()):
        raise AssertionError(f"expected two calls of each pass on a {shape} disparity, "
                             f"kept {[len(v) for v in kept.values()]}")
    return res, kept


def design_of(src: str) -> str:
    return "sequential" if "k7_row_chains" in src else "segments"


def instrument(src: str) -> tuple:
    """``src`` (a `csrc/constraints.cu`) with the marks of its design in K6
    and K7; returns (instrumented source, design)."""
    design = design_of(src)
    for old, new in MARKS[design]:
        if src.count(old) != 1:
            raise RuntimeError(f"k67_phase_clocks: anchor not found once in the {design} "
                               f"kernels: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src, design


def instrumented_copy(package_root: Path) -> tuple:
    """The package under ``package_root`` copied to _build/ with the marks
    of its design in K6 and K7; returns (copy root, design)."""
    root = OUT / ("this" if package_root == PKG.parent else "other")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(package_root / PKG.name, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "csrc" / "constraints.cu"
    s, design = instrument(src.read_text())
    src.write_text(s)
    return root, design


def read(lib, which: int) -> np.ndarray:
    buf = np.zeros(NBLK * SLOTS, np.int64)
    if lib.rtt_k67_clocks(which, buf.ctypes.data) != 0:
        raise RuntimeError("k67_phase_clocks: reading the clocks failed")
    return buf.reshape(NBLK, SLOTS)


def phase_lines(b: np.ndarray, names) -> list:
    """Mean and largest cycles a block and share of all, by phase, over the
    blocks that recorded anything."""
    n = len(names)
    b = b[b[:, :n].sum(1) > 0]
    allc = max(int(b[:, :n].sum()), 1)
    lines = [f"    {len(b)} blocks; cycles a block: mean {b[:, :n].sum(1).mean():.0f}, "
             f"max {int(b[:, :n].sum(1).max())}"]
    for k, name in enumerate(names):
        lines.append(f"    {name:8s} mean {b[:, k].mean():10.0f}  max {int(b[:, k].max()):9d}"
                     f"  {100 * b[:, k].sum() / allc:5.1f}% of all")
    return lines


def measure(lib, design: str, label: str, kept) -> None:
    """K6 as launched and with one block an SM, then K7, on each kept call."""
    import torch
    from reconstruction_tpu_torch.ops import constraints as K67

    def clocked(fn):
        fn()
        torch.cuda.synchronize()
        lib.rtt_k67_reset()
        fn()
        torch.cuda.synchronize()

    for i, ((d, m), _) in enumerate(kept["ordering_constraint"]):
        for alone in (0, ALONE_SMEM):
            lib.rtt_k67_alone(alone)
            clocked(lambda: K67.ordering(d, m))
            b = read(lib, 0)
            rows = b[b[:, :3].sum(1) > 0]
            how = "one block an SM" if alone else "as launched"
            print(f"K6 ordering, {label}, direction {i} ({tuple(d.shape)}), {how}: greedy "
                  f"steps a row mean {rows[:, SLOTS - 2].mean():.2f}, max "
                  f"{int(rows[:, SLOTS - 2].max())}; valid points a row mean "
                  f"{rows[:, SLOTS - 1].mean():.1f}, max {int(rows[:, SLOTS - 1].max())}")
            print("\n".join(phase_lines(b, PHASES[design]["k6"])))
        lib.rtt_k67_alone(0)
    for i, ((d, v, ms, mt, *rest), _) in enumerate(kept["propagate_bounds"]):
        clocked(lambda: K67.propagate_bounds(d, v, ms, mt, *rest))
        print(f"K7 propagate_bounds, {label}, direction {i} ({tuple(d.shape)}):")
        for which, pas in ((1, "k7c"), (2, "k7r")):
            b = read(lib, which)
            print(f"  {'column' if pas == 'k7c' else 'row'} pass:")
            print("\n".join(phase_lines(b, PHASES[design][pas])))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", type=Path, default=PKG.parent,
                    help="directory holding the reconstruction_tpu_torch to measure")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k67_phase_clocks: needs a CUDA device", file=sys.stderr)
        return 2
    root, design = instrumented_copy(opts.package.resolve())
    sys.path.insert(0, str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == PKG.name]:
        del sys.modules[name]
    from reconstruction_tpu_torch.ops import _build
    assert Path(_build.__file__).is_relative_to(root)
    lib = _build.load()
    lib.rtt_k67_clocks.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.rtt_k67_clocks.restype = ctypes.c_int
    lib.rtt_k67_reset.argtypes = []
    lib.rtt_k67_reset.restype = ctypes.c_int
    lib.rtt_k67_alone.argtypes = [ctypes.c_int]
    lib.rtt_k67_alone.restype = ctypes.c_int
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.tools.pair_stages import scene_args
    print(f"K6/K7 design: {design} ({opts.package})")
    for scene in ("myself", "dome"):
        args = scene_args(scene)
        cfg = args[0]
        shape = (cfg.finest_size[1], cfg.finest_size[0])
        _, kept = keep_constraint_calls(lambda: match_pair(*args, device="cuda"), shape)
        measure(lib, design, f"{scene} finest level", kept)
        del kept, args
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
