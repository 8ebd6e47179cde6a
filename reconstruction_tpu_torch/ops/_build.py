"""Builds the port's CUDA kernels and loads them with ctypes.

Route: nvcc compiles every `csrc/*.cu` to an object, one process per
source, all started together, and links them into one shared library with
a plain C interface (no PyTorch headers, so a cold build takes seconds),
keyed by a hash of the sources and flags, in `reconstruction_tpu_torch/_build/`.
The build runs at the first CUDA use in a process; a later process with
the same sources loads the library it finds.

    python -c "from reconstruction_tpu_torch.ops import _build; _build.load()"
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "--fmad=false",          # no silent mul+add contraction (see csrc/common.cuh)
    "-Xptxas=-v",            # registers, shared memory and spills per kernel
    "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # None when the library was already built
build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# C entry points: name -> argument types (pointers and the stream are void*).
_SIGNATURES = {
    "rtt_ncc_sweep": [_P] * 13 + [_I] * 4 + [_P],
    "rtt_cost_volume": [_P] * 11 + [_I] * 5 + [_P],
    "rtt_cost_volume_bf16": [_P] * 11 + [_I] * 5 + [_P],
    "rtt_refine_sweeps": [_P] * 6 + [_F] + [_I] * 4 + [_P],
    "rtt_refine_sweeps_bf16": [_P] * 6 + [_F] + [_I] * 4 + [_P],
    "rtt_ba_coupling": [_P] * 3 + [_I] * 4 + [_P],
    "rtt_ncc_sweep_mxu": [_P] * 13 + [_I] * 8 + [_LL, _P],
    "rtt_ncc_sweep_mxu_layout": [_I, _I, _P],
    "rtt_ordering": [_P] * 6 + [_I] * 2 + [_P],
    "rtt_propagate_bounds": [_P] * 10 + [_F] + [_I] * 2 + [_P],
    "rtt_propagate_bounds_layout": [_I, _I, _P],
}


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtt_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


def _run_all(cmds) -> None:
    """Run the commands concurrently; append their output to the build log
    and raise after all have ended if any failed."""
    global build_log
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        build_log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(path: Path) -> None:
    """Compile csrc/*.cu into ``path`` (atomic rename, safe across processes)."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cus]
    build_log = ""
    t0 = time.perf_counter()
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(cus, objs)])
        _run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no build."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().rtt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream and check its error."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    check(getattr(load(), name)(*args, stream), name)
