"""Cycles by phase of K1's heaviest blocks on the card, from clock64 marks
that this script adds to a copy of `csrc/ncc_sweep.cu` (the kernel itself
carries none).

    python3 reconstruction_tpu_torch/tools/k1_phase_clocks.py

It copies the package into `reconstruction_tpu_torch/_build/phase_clocks/`
(ignored by git), inserts the marks, builds the copy, and runs its K1 on
the launches of one warm `match_pair` at the `myself` preset (the finest
guided launch, a coarse brute one and a mid-level guided one) and on
`chip_smoke.py`'s guided case with four hole rows.  Thread 0 of each block
adds the cycles since its previous mark at each of the kernel's barriers,
so a phase holds the slowest thread's time up to that barrier:

  stats    the block's bounds, shift span and useful pairs, to its mode
  stage    L once, then R per chunk (in sweep mode also the sweep of the
           chunk before)
  count    candidate mode: a chunk's moments staged, its items counted
  items    candidate mode: the items of a chunk
  top      candidate mode: the zero-sign fix-up and the next chunk's barrier
  end      the final writes (in sweep mode also the last chunk's sweep)

Needs a CUDA device and nvcc, like the kernels.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
COPY = PKG / "_build" / "phase_clocks"
PHASES = ("stats", "count", "items", "end", "stage", "top")


def instrumented_copy() -> Path:
    """The package copied under _build/ with clock64 marks in K1."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(PKG, COPY / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = COPY / PKG.name / "csrc" / "ncc_sweep.cu"
    s = src.read_text()
    marks = [
        ("namespace {\n", "__device__ long long k1_dbg[8192 * 8];\nnamespace {\n"),
        ("  const int wx = warp % K1_NWX, wy = warp / K1_NWX;\n",
         "  const int wx = warp % K1_NWX, wy = warp / K1_NWX;\n"
         "  long long* dbg = k1_dbg + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
         "  long long tick = clock64();\n"
         "  auto mark = [&](int k) {\n"
         "    if (tid == 0) { const long long n = clock64(); dbg[k] += n - tick; tick = n; }\n"
         "  };\n"
         "  if (tid == 0) for (int k = 0; k < 8; ++k) dbg[k] = 0;\n"),
        ("  const bool any = s_useful > 0;\n", "  const bool any = s_useful > 0;\n  mark(0);\n"),
        ("        [&](int r, int c, int v) { sR[r * G::RP + k1_sidx<R>(c)] = v; });\n",
         "        [&](int r, int c, int v) { sR[r * G::RP + k1_sidx<R>(c)] = v; });\n"
         "    mark(4);\n"),
        ("      __syncthreads();   // the previous chunk is read (and sL, sKey written)\n",
         "      __syncthreads();   // the previous chunk is read (and sL, sKey written)\n"
         "      mark(5);\n"),
        ("      int off = k1_block_scan(own, s_warp, total);   // synchronises the block\n",
         "      int off = k1_block_scan(own, s_warp, total);   // synchronises the block\n"
         "      mark(1);\n"),
        ("        if (bti >= 0) atomicMax(&sKey[p], k1_key(bs, bti));\n      }\n"
         "      __syncthreads();\n",
         "        if (bti >= 0) atomicMax(&sKey[p], k1_key(bs, bti));\n      }\n"
         "      __syncthreads();\n      mark(2);\n      if (tid == 0) dbg[6] += 1;\n"),
        ("  if (bad) *off_grid = 1;\n}\n",
         "  __syncthreads();\n  mark(3);\n"
         "  if (tid == 0) dbg[7] = cand ? 1 + (long long)s_useful : -(long long)s_span;\n"
         "  if (bad) *off_grid = 1;\n}\n"),
        ("RTT_API const char* rtt_error_string(int err) {",
         "RTT_API int rtt_k1_clocks(void* host) {\n"
         "  return (int)cudaMemcpyFromSymbol(host, k1_dbg, sizeof(long long) * 8192 * 8);\n"
         "}\n\nRTT_API const char* rtt_error_string(int err) {"),
    ]
    for old, new in marks:
        if s.count(old) != 1:
            raise RuntimeError(f"k1_phase_clocks: anchor not found once in "
                               f"ncc_sweep.cu: {old.strip()[:60]!r}")
        s = s.replace(old, new)
    src.write_text(s)
    return COPY


def report(lib, label: str, args, top: int = 4) -> None:
    import numpy as np
    import torch
    from reconstruction_tpu_torch.ops import ncc_sweep as K
    H, W = args[8].shape
    bx = 2 * 2 * (32 - 2 * ((args[10] + 1) // 2))
    nbx, nb = -(-W // bx), -(-W // bx) * -(-H // 16)
    for _ in range(2):
        K.ncc_sweep(*args)
    torch.cuda.synchronize()
    buf = np.zeros(8192 * 8, np.int64)
    if lib.rtt_k1_clocks(buf.ctypes.data) != 0:
        raise RuntimeError("k1_phase_clocks: reading the clocks failed")
    b = buf.reshape(8192, 8)[:nb]
    tot = b[:, :6].sum(1)
    print(f"{label} {H}x{W}: {nb} blocks, {int((b[:, 7] > 0).sum())} in candidate "
          f"mode; cycles a block: max {int(tot.max())}, median {int(np.median(tot))}")
    for i in np.argsort(-tot)[:top]:
        mode = (f"candidate, {int(b[i, 7]) - 1} useful pairs, {int(b[i, 6])} chunks"
                if b[i, 7] > 0 else f"sweep, longest warp {-int(b[i, 7])} shifts")
        phases = ", ".join(f"{p} {int(b[i, k])}" for k, p in enumerate(PHASES) if b[i, k])
        print(f"  block ({i // nbx}, {i % nbx}): {int(tot[i])} cycles ({phases}); {mode}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_phase_clocks: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(instrumented_copy()))
    for name in [m for m in sys.modules if m.split(".")[0] == PKG.name]:
        del sys.modules[name]
    from reconstruction_tpu_torch.config import preset
    from reconstruction_tpu_torch.ops import _build
    from reconstruction_tpu_torch.stereo import matching
    from reconstruction_tpu_torch.stereo.matching import _centered, ncc_moments
    from reconstruction_tpu_torch.stereo.pipeline import match_pair
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene
    assert Path(_build.__file__).is_relative_to(COPY)
    lib = _build.load()
    lib.rtt_k1_clocks.argtypes = [ctypes.c_void_p]
    lib.rtt_k1_clocks.restype = ctypes.c_int

    cfg = preset("myself")
    cams, imgs, masks = make_stereo_scene(image_size=cfg.finest_size, span_deg=7.0,
                                          device="cuda")
    calls, real = [], matching.ncc_sweep

    def capture(*a):
        calls.append(tuple(t.clone() if torch.is_tensor(t) else t for t in a))
        return real(*a)

    matching.ncc_sweep = capture
    try:
        match_pair(cfg, imgs[0], imgs[1], masks[0], masks[1], cams[0].K,
                   cams[0].Rt, cams[1].K, cams[1].Rt)
    finally:
        matching.ncc_sweep = real
    for i, label in ((12, "finest guided launch"), (0, "coarse brute launch"),
                     (8, "level-2 guided launch")):
        report(lib, label, calls[i])

    # chip_smoke.py's guided case: +-2 around d = 40, four hole rows.
    dev = torch.device("cuda")
    H, W, C, r = 1920, 1280, 3, 2
    gen = torch.Generator(device=dev).manual_seed(7)
    base = torch.randint(0, 256, (H, W + 64, C), generator=gen, device=dev)
    imgL = base[:, 40:W + 40].float()
    imgR = torch.clamp(base[:, :W].float() + torch.randint(
        -3, 4, (H, W, C), generator=gen, device=dev), 0, 255)
    yy = torch.arange(H, device=dev)[:, None].float()
    xx = torch.arange(W, device=dev)[None, :].float()
    valid = (((yy - H / 2) / (0.45 * H)) ** 2 + ((xx - W / 2) / (0.45 * W)) ** 2) < 1.0
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    lo = torch.clamp(x + 38, max=W - 1).clone()
    hi = torch.clamp(x + 42, max=W - 1).clone()
    for row in (100, 101, 900, 1500):
        lo[row], hi[row] = 2, W - 3
    L, R = _centered(imgL), _centered(imgR)
    mL, mR = ncc_moments(L, r), ncc_moments(R, r)
    report(lib, "guided case with hole rows",
           (L, R, (mL.n * mL.mean).contiguous(), mL.inv_norm, mR.mean,
            mR.inv_norm, valid, valid, lo.contiguous(), hi.contiguous(), r))
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
