"""Cycles by phase of K5 (the tensor-core sweep) on the card, and the pairs
it evaluates against the useful ones, from clock64 marks and a pair counter
that this script adds to a copy of `csrc/ncc_sweep_mxu.cu` (the kernel
itself carries none).

    python3 reconstruction_tpu_torch/tools/k5_phase_clocks.py [--package DIR]

DIR is a directory that holds a `reconstruction_tpu_torch` package (default:
the one beside this script); the marks fit both designs of the kernel, the
wmma one (one image row a block, im2col stacks, fragments stored to shared
memory) and the mma one (int8x4 slabs, scores on the accumulators), so an
unpacked earlier tree can be measured with the same script.  The copy goes
to this package's `_build/k5_clocks/` (ignored by git), is built and run on
`chip_smoke.py`'s 64-shift cell and on its 256-shift case (bounds
x-128..x+127, pad_shift 128) at 1920x1280x3, r = 2.  Thread 0 of each
block adds the cycles since its previous mark at the block's barriers, so a
barrier phase holds the slowest thread's time up to it:

  stage     staging the images (wmma: L's slab, then R's slab and the
            moments a chunk; mma: waiting for a unit's cp.async)
  im2col    wmma only: the im2col stacks
  tiles     the products and the epilogue of a chunk (mma: of a unit, a
            group of pixels over a chunk of targets, to its last warp)
  setup     mma only: thread 0's keys and its first copies issued
  end       the last barrier to the output writes

Inside `tiles`, every warp's lane 0 also sums its own cycles in the
products (wmma: the k-steps; mma: the slab loads and mma.sync of a tile,
issued, not retired) and the epilogue (the rest of a fragment or tile), shown
per warp.  Needs a CUDA device and nvcc, like the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
OUT = PKG / "_build" / "k5_clocks"
NBLK = 1 << 15
PHASES = ("stage", "im2col", "tiles", "setup", "products/warp", "epilogue/warp",
          "chunks", "end")
BARRIER_PHASES = (0, 1, 2, 3, 7)

_HEAD = ("namespace {\n",
         f"__device__ unsigned long long k5_dbg[{NBLK} * 8];\n"
         "__device__ unsigned long long k5_pairs;\nnamespace {\n")
# Thread 0 keeps the phases in registers, each warp its own product and
# epilogue cycles and pairs; all are written once at the end, so the marks
# add no memory traffic while the kernel runs.
_MARK = ("  unsigned long long* dbg = k5_dbg + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
         "  long long tick = clock64(), cprod = 0, cepi = 0, npairs = 0, dph[8] = {0};\n"
         "  auto mark = [&](int k) {\n"
         "    if (threadIdx.x == 0) { const long long n = clock64(); dph[k] += n - tick; tick = n; }\n"
         "  };\n")
_FLUSH = ("  __syncthreads();\n  mark(7);\n"
          "  if (threadIdx.x == 0)\n"
          "    for (int k = 0; k < 8; ++k) dbg[k] = (unsigned long long)dph[k];\n"
          "  __syncthreads();\n"
          "  if ((threadIdx.x & 31) == 0) {\n"
          "    atomicAdd(dbg + 4, (unsigned long long)cprod);\n"
          "    atomicAdd(dbg + 5, (unsigned long long)cepi);\n"
          "    atomicAdd(&k5_pairs, (unsigned long long)npairs);\n  }\n")
_ENTRY = ("RTT_API int rtt_ncc_sweep_mxu(",
          "RTT_API int rtt_k5_clocks(void* host, void* pairs) {\n"
          f"  cudaError_t e = cudaMemcpyFromSymbol(host, k5_dbg, sizeof(unsigned long long) * {NBLK} * 8);\n"
          "  if (e != cudaSuccess) return (int)e;\n"
          "  return (int)cudaMemcpyFromSymbol(pairs, k5_pairs, sizeof(unsigned long long));\n}\n\n"
          "RTT_API int rtt_k5_reset() {\n  const unsigned long long z = 0;\n"
          "  return (int)cudaMemcpyToSymbol(k5_pairs, &z, sizeof(z));\n}\n\n"
          "RTT_API int rtt_ncc_sweep_mxu(")

# (anchor, replacement) pairs of each design.
MARKS = {
    "wmma": [
        _HEAD,
        ("  const size_t pix = (size_t)y * W + x;\n",
         "  const size_t pix = (size_t)y * W + x;\n" + _MARK),
        ("  load_slab(sSlabL, L, y, xb0, K5_XB, H, W, C, r, bad);\n  __syncthreads();\n",
         "  load_slab(sSlabL, L, y, xb0, K5_XB, H, W, C, r, bad);\n  __syncthreads();\n"
         "  mark(0);\n"),
        ("  im2col(sWL, sSlabL, sTabL, K5_XB, ksteps, C, 0, K5_XB - 1);\n  __syncthreads();\n",
         "  im2col(sWL, sSlabL, sTabL, K5_XB, ksteps, C, 0, K5_XB - 1);\n  __syncthreads();\n"
         "  mark(1);\n"),
        ("    __syncthreads();\n    // Local col",
         "    __syncthreads();\n    mark(0);\n    // Local col"),
        ("    __syncthreads();\n    // Fragments g",
         "    __syncthreads();\n    mark(1);\n    // Fragments g"),
        ("      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;\n",
         "      long long c0_ = clock64();\n"
         "      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;\n"),
        ("      wmma::store_matrix_sync(cw, acc, K5_LDC, wmma::mem_row_major);\n",
         "      long long c1_ = clock64();\n      cprod += c1_ - c0_;\n"
         "      wmma::store_matrix_sync(cw, acc, K5_LDC, wmma::mem_row_major);\n"),
        ("      __syncwarp();   // cw is rewritten by the next fragment\n",
         "      __syncwarp();   // cw is rewritten by the next fragment\n"
         "      cepi += clock64() - c1_;\n"
         "      npairs += 256;\n"),
        ("    __syncthreads();  // the slab, stack and moments are rewritten next chunk\n",
         "    __syncthreads();  // the slab, stack and moments are rewritten next chunk\n"
         "    mark(2);\n    dph[6] += 1;\n"),
        ("  if (bad) *off_grid = 1;\n}\n", _FLUSH + "  if (bad) *off_grid = 1;\n}\n"),
        _ENTRY,
    ],
    "mma": [
        _HEAD,
        ("  const int yw = by0 + K5_WR * wy;\n",
         "  const int yw = by0 + K5_WR * wy;\n" + _MARK),
        ("  stage(0, 0, true);\n", "  stage(0, 0, true);\n  mark(3);\n"),
        ("    if (u == 0 || nchunk > 1) __syncthreads();\n",
         "    if (u == 0 || nchunk > 1) __syncthreads();\n    mark(0);\n"),
        ("          int acc[K5_WR][4];\n",
         "          long long c0_ = clock64();\n          int acc[K5_WR][4];\n"),
        ("          const int t = T0 + 8 * j + 2 * tig;",
         "          long long c1_ = clock64();\n          cprod += c1_ - c0_;\n"
         "          const int t = T0 + 8 * j + 2 * tig;"),
        ("                          m.w, t + 1, pa[i][1], pw[i][1]);\n          }\n",
         "                          m.w, t + 1, pa[i][1], pw[i][1]);\n          }\n"
         "          cepi += clock64() - c1_;\n"
         "          npairs += 128 * K5_WR;\n"),
        ("      write(grp);\n    }\n", "      write(grp);\n    }\n    __syncthreads();\n"
         "    mark(2);\n    dph[6] += 1;\n"),
        ("    if (nchunk > 1) __syncthreads();   // buffer b is staged again two units on\n"
         "  }\n}\n",
         "    if (nchunk > 1) __syncthreads();   // buffer b is staged again two units on\n"
         "  }\n" + _FLUSH + "}\n"),
        _ENTRY,
    ],
}


def instrumented_copy(package_root: Path) -> tuple:
    """The package under ``package_root`` copied to _build/ with the marks
    of its design in K5; returns (copy root, design)."""
    root = OUT / ("this" if package_root == PKG.parent else "other")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(package_root / PKG.name, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "csrc" / "ncc_sweep_mxu.cu"
    s = src.read_text()
    design = "wmma" if "wmma::" in s else "mma"
    for old, new in MARKS[design]:
        if s.count(old) != 1:
            raise RuntimeError(f"k5_phase_clocks: anchor not found once in the {design} "
                               f"kernel: {old.strip()[:60]!r}")
        s = s.replace(old, new)
    src.write_text(s)
    return root, design


def cases(dev):
    """chip_smoke.py's K5 inputs: (label, sweep arguments, pad_shift)."""
    import torch
    from reconstruction_tpu_torch.stereo.matching import _centered, ncc_moments
    H, W, C, r = 1920, 1280, 3, 2
    gen = torch.Generator(device=dev).manual_seed(7)
    base = torch.randint(0, 256, (H, W + 64, C), generator=gen, device=dev)
    imgL = base[:, 40:W + 40].float().contiguous()
    imgR = torch.clamp(base[:, :W].float() + torch.randint(
        -3, 4, (H, W, C), generator=gen, device=dev), 0, 255).contiguous()
    yy = torch.arange(H, device=dev)[:, None].float()
    xx = torch.arange(W, device=dev)[None, :].float()
    valid = (((yy - H / 2) / (0.45 * H)) ** 2 + ((xx - W / 2) / (0.45 * W)) ** 2) < 1.0
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    L, R = _centered(imgL), _centered(imgR)
    mL, mR = ncc_moments(L, r), ncc_moments(R, r)
    m = (L, R, (mL.n * mL.mean).contiguous(), mL.inv_norm, mR.mean, mR.inv_norm)
    return [("64-shift cell", m + (valid, valid, x.contiguous(),
                                   torch.clamp(x + 63, max=W - 1).contiguous(), r), 128),
            ("256-shift case", m + (valid, valid, (x - 128).contiguous(),
                                    (x + 127).contiguous(), r), 128)]


def report(lib, label: str, args, pad_shift: int) -> None:
    import numpy as np
    import torch
    from reconstruction_tpu_torch.ops import ncc_sweep_mxu as K5
    active, lo, hi = args[7], args[8], args[9]
    W = lo.shape[1]
    useful = float(torch.where(active, (hi.clamp(max=W - 1) - lo.clamp(min=0) + 1)
                               .clamp_min(0), 0).double().sum())
    K5.ncc_sweep_mxu(*args, pad_shift=pad_shift)
    torch.cuda.synchronize()
    if lib.rtt_k5_reset() != 0:
        raise RuntimeError("k5_phase_clocks: resetting the counter failed")
    K5.ncc_sweep_mxu(*args, pad_shift=pad_shift)
    torch.cuda.synchronize()
    buf = np.zeros(NBLK * 8, np.uint64)
    pairs = np.zeros(1, np.uint64)
    if lib.rtt_k5_clocks(buf.ctypes.data, pairs.ctypes.data) != 0:
        raise RuntimeError("k5_phase_clocks: reading the clocks failed")
    b = buf.reshape(NBLK, 8).astype(np.int64)
    b = b[b[:, list(BARRIER_PHASES)].sum(1) > 0]
    nwarps = 8
    tot = b[:, list(BARRIER_PHASES)].sum(1)
    print(f"{label}: {len(b)} blocks; cycles a block: mean {tot.mean():.0f}, "
          f"max {int(tot.max())}; evaluated pairs {int(pairs[0])}, useful {useful:.0f} "
          f"({int(pairs[0]) / max(useful, 1):.3f}x)")
    allc = max(int(tot.sum()), 1)
    for k in BARRIER_PHASES:
        if b[:, k].any():
            print(f"  {PHASES[k]:14s} mean {b[:, k].mean():10.0f} cycles a block, "
                  f"{100 * b[:, k].sum() / allc:5.1f}% of all")
    for k in (4, 5):
        print(f"  {PHASES[k]:14s} mean {b[:, k].mean() / nwarps:10.0f} cycles a warp")
    print(f"  chunks (mma: units) visited a block: mean {b[:, 6].mean():.2f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", type=Path, default=PKG.parent,
                    help="directory holding the reconstruction_tpu_torch to measure")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k5_phase_clocks: needs a CUDA device", file=sys.stderr)
        return 2
    root, design = instrumented_copy(opts.package.resolve())
    sys.path.insert(0, str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == PKG.name]:
        del sys.modules[name]
    from reconstruction_tpu_torch.ops import _build
    assert Path(_build.__file__).is_relative_to(root)
    lib = _build.load()
    lib.rtt_k5_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rtt_k5_clocks.restype = ctypes.c_int
    lib.rtt_k5_reset.argtypes = []
    lib.rtt_k5_reset.restype = ctypes.c_int
    print(f"K5 design: {design} ({opts.package})")
    for label, args, ps in cases(torch.device("cuda")):
        report(lib, label, args, ps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
