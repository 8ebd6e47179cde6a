"""K5's block geometry, measured: builds copies of the package whose
`csrc/ncc_sweep_mxu.cu` differs only in the warp and block shape (rows a
warp, warps side by side and stacked, blocks an SM in the launch bounds,
the tile loop's unroll, the pixel groups a block walks), checks each
bit-equal to the plain version and times it on `chip_smoke.py`'s 64-shift
cell and 256-shift case (1920x1280x3, r = 2).  The wrapper reads the
geometry from the source (`ops/ncc_sweep_mxu.layout`), so only the `.cu`
is edited.  "gated" tests every pair against its pixel's range, also in
the tiles that lie inside every pixel's range of a warp (a result equal to
the sweep's).  Two ablations, timed only (their results are not the
sweep's): "no-epilogue" replaces each pair's score, gate and compare by
one add of the product, and "no-tiles" skips the tile loop, which leaves
what a block costs around its products and scores.

    python3 reconstruction_tpu_torch/tools/k5_variants.py [NAME ...]

The copies go to `_build/k5_variants/` (ignored by git) and build in
parallel, one process each.  Times are profiler device time per call (the
prep and sweep launches summed, and the sweep alone), the mean of the last
10 of 20 calls; the variants run in the order given and then the first one
again, so its two rows show the drift within the call.  Needs a CUDA device
and nvcc, like the kernels.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
OUT = PKG / "_build" / "k5_variants"

# name: (rows a warp, warps side by side, warps stacked, blocks an SM,
# tiles a warp's loop takes per step (`#pragma unroll` of the tile loop),
# groups of pixels a block's warps walk)
VARIANTS = {
    "g4": (2, 4, 2, 2, 2, 4),   # the committed shape: 256 pixels x 4 rows
    "g2": (2, 4, 2, 2, 2, 2),
    "g1": (2, 4, 2, 2, 2, 1),
    "g4-u1": (2, 4, 2, 2, 1, 4),
    "g4-1r-b3": (1, 4, 2, 3, 2, 4),
    "g4-2x4": (2, 2, 4, 2, 2, 4),
    "no-epilogue": (2, 4, 2, 2, 2, 4),
    "no-tiles": (2, 4, 2, 2, 2, 4),
    "gated": (2, 4, 2, 2, 2, 4),
}
ABLATIONS = {
    "no-epilogue": (
        "  const float sc = rtt_ncc_score(cross, nmu, mu, invl, inv);\n"
        "  if ((!GATE || (unsigned)(t - a) <= w) && sc > best) {  // strict: the first maximum wins\n"
        "    best = sc;\n    bt = t;\n  }\n",
        "  best += cross;\n"),
    "no-tiles": ("    if (ja <= jb) {\n", "    if (ja <= jb && W < 0) {\n"),
    "gated": ("      if (ia <= ib && i0 <= i1) {\n", "      if (ia <= ib && i0 <= i1 && W < 0) {\n"),
}


def make_copy(name: str) -> Path:
    wr, nwx, nwy, minb, unroll, groups = VARIANTS[name]
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "csrc" / "ncc_sweep_mxu.cu"
    s = src.read_text()
    for old, new in ((r"constexpr int K5_WR = \d+;", f"constexpr int K5_WR = {wr};"),
                     (r"constexpr int K5_NWX = \d+;", f"constexpr int K5_NWX = {nwx};"),
                     (r"constexpr int K5_NWY = \d+;", f"constexpr int K5_NWY = {nwy};"),
                     (r"constexpr int K5_GROUPS = \d+;", f"constexpr int K5_GROUPS = {groups};"),
                     (r"__launch_bounds__\(K5_THREADS, \d+\)",
                      f"__launch_bounds__(K5_THREADS, {minb})"),
                     (r"(#pragma unroll \d+\n)?( +)(for \(int j = j0; j <= j1;)",
                      rf"\2#pragma unroll {unroll}\n\2\3")):
        s, n = re.subn(old, new, s)
        if n != 1:
            raise RuntimeError(f"k5_variants: {old!r} not found once")
    if name in ABLATIONS:
        old, new = ABLATIONS[name]
        if s.count(old) != 1:
            raise RuntimeError(f"k5_variants: ablation anchor of {name} not found once")
        s = s.replace(old, new)
    src.write_text(s)
    return root


def run_one(root: Path) -> dict:
    """In a process of its own: build (already done) and time the copy."""
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from reconstruction_tpu_torch.ops import _build
    from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
    from reconstruction_tpu_torch.tools.k5_phase_clocks import cases
    assert Path(K5.__file__).is_relative_to(root)
    _build.load()
    res = {}
    for label, args, ps in cases(torch.device("cuda")):
        sk, tk = K5.ncc_sweep_mxu(*args, pad_shift=ps)
        sp, tp = K5.ncc_sweep_mxu_plain(*args, pad_shift=ps)
        equal = bool(torch.equal(sk, sp) and torch.equal(tk, tp))
        del sp, tp
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    K5.ncc_sweep_mxu(*args, pad_shift=ps)
                torch.cuda.synchronize()
            ev = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "ncc_sweep_mxu" in e.name), key=lambda e: e.time_range.start)
            ev = ev[-20:]
            if len(ev) == 20:
                break
        else:
            raise AssertionError(f"the profiler recorded {len(ev)} of K5's launches")
        sweep = [e for e in ev if "prep" not in e.name]
        res[label] = dict(bit_equal=equal,
                          ms=sum(e.time_range.elapsed_us() for e in ev) / 1e4,
                          sweep_ms=sum(e.time_range.elapsed_us() for e in sweep) / 1e3
                          / len(sweep))
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print(json.dumps(run_one(Path(sys.argv[2]))))
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    roots = {n: make_copy(n) for n in names}
    build = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from reconstruction_tpu_torch.ops import _build; _build.load(); "
         "print(_build.build_log)", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in roots.values()]
    ptxas, failed = {}, False
    for n, p in zip(names, build):
        out, _ = p.communicate()
        if p.returncode != 0:
            print(f"{n}: build failed\n{out[-3000:]}", flush=True)
            failed = True
            continue
        # The r = 2 sweep kernel's registers and spill stores.
        m = re.search(r"ncc_sweep_mxu_kernelILi2E[^\n]*\n[^\n]*\n\s*\d+ bytes stack frame, "
                      r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", out)
        ptxas[n] = (int(m.group(2)), int(m.group(1))) if m else (-1, -1)
    print(f"{'variant':14s} regs spill  64 shifts: ms (sweep ms) eq   256 shifts: ms (sweep ms) eq")
    for n in names + names[:1]:
        if n not in ptxas:
            continue
        out = subprocess.run([sys.executable, __file__, "--run", str(roots[n])],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(f"{n}: run failed\n{out.stderr[-3000:]}", flush=True)
            failed = True
            continue
        r = json.loads(out.stdout.strip().splitlines()[-1])
        a, b = r["64-shift cell"], r["256-shift case"]
        print(f"{n:14s} {ptxas[n][0]:4d} {ptxas[n][1]:5d}  {a['ms']:.4f} "
              f"({a['sweep_ms']:.4f}) {a['bit_equal']}   {b['ms']:.4f} ({b['sweep_ms']:.4f}) "
              f"{b['bit_equal']}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
