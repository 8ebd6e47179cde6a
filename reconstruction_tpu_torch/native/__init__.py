"""Native host components: ctypes loader and build (counterpart of
`reconstruction_tpu/native/__init__.py`).

The C++ sources in `native/src/` are copies of the reference's
(`reconstruction_tpu/native/src/`), so the port carries everything it
builds.  g++ compiles them at the first use in a process, with the
reference's Makefile flags, into one shared library keyed by a hash of
the sources, the flags and the CPU model in the git-ignored
`reconstruction_tpu_torch/_build/`;
a later process with the same sources loads the library it finds.  A
failed build raises: no caller falls back to a Python path in silence
(the NumPy versions are separate functions the tests call by name).

    python -c "from reconstruction_tpu_torch import native; native.load()"
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("marching_tets.cpp", "ply_codec.cpp", "cloud_stats.cpp")
# `reconstruction_tpu/native/Makefile:8`.  -march=native: the library is
# built on the machine that runs it.
CXXFLAGS = ("-O3", "-march=native", "-fno-math-errno", "-fPIC", "-fopenmp",
            "-std=c++17", "-Wall")

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # None when the library was already built

_cfp = ctypes.POINTER(ctypes.c_float)
_cup = ctypes.POINTER(ctypes.c_uint8)
_cdp = ctypes.POINTER(ctypes.c_double)
_cip = ctypes.POINTER(ctypes.c_int32)
_L = ctypes.c_long
_F = ctypes.c_float

# C entry points: name -> (restype, argtypes), as the reference declares them.
_SIGNATURES = {
    "mt_count": (_L, [_cfp, _L, _L, _L, _F]),
    "mt_extract": (_L, [_cfp, _L, _L, _L, _F, _cfp, _L]),
    "ply_pack": (_L, [_L, _cfp, _cfp, _cup, ctypes.c_int, _cup]),
    "ply_pack_faces": (None, [_L, _cip, _cup]),
    "cloud_sor_stats": (None, [_cfp, _cup, _L, _F, ctypes.c_int, _cfp, _cup]),
    "cloud_normals": (None, [_cfp, _cup, _L, _F, _cfp, _cfp]),
    "cloud_mls": (None, [_cfp, _cup, _L, _F, _cfp, _cfp, _cfp, _cup]),
    "laplacian_cotan": (None, [_cdp, _L, _cip, _L, ctypes.c_int, ctypes.c_double, _cup]),
}


def _cpu_model() -> str:
    """The host CPU's model name and instruction-set flags: -march=native
    builds for them, so a build from another machine is not reused."""
    keys = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k.strip() in ("model name", "flags"):
                    keys.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    return " ".join(keys.values()) or platform.processor() or platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_cpu_model().encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"librecon_native_{h.hexdigest()[:16]}.so"


def _compilers() -> list:
    """C++ compilers to try, in order: $CXX, g++ on PATH, the system's."""
    out = []
    for c in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
              shutil.which("c++")):
        if c and c not in out:
            out.append(c)
    return out


def build(path: Path) -> None:
    """Compile the sources into ``path`` (atomic rename, safe across
    processes) with the first compiler that builds them with these flags
    (a g++ may lack the OpenMP runtime); raises with every compiler's
    output when none does."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    errors = []
    t0 = time.perf_counter()
    for cxx in _compilers():
        cmd = [cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
               *(str(SRC_DIR / s) for s in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            errors.append(f"{' '.join(cmd)}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, path)
            build_seconds = time.perf_counter() - t0
            return
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}")
    raise RuntimeError("native build failed with every compiler tried:\n"
                       + "\n".join(errors or ["no C++ compiler found (g++ or CXX)"]))


def load() -> ctypes.CDLL:
    """The native library, built first if this source hash has no build."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def _f32p(a):
    return a.ctypes.data_as(_cfp)


def _u8p(a):
    return a.ctypes.data_as(_cup)


def marching_tets_native(chi: np.ndarray, iso: float) -> np.ndarray:
    """Triangle soup (T, 3, 3) in grid coordinates."""
    lib = load()
    chi = np.ascontiguousarray(chi, np.float32)
    rx, ry, rz = chi.shape
    count = lib.mt_count(_f32p(chi), rx, ry, rz, ctypes.c_float(iso))
    out = np.empty((count, 3, 3), np.float32)
    lib.mt_extract(_f32p(chi), rx, ry, rz, ctypes.c_float(iso), _f32p(out), count)
    return out


def pack_vertices(xyz: np.ndarray, normals: Optional[np.ndarray],
                  colors: Optional[np.ndarray], bgr: bool) -> bytes:
    lib = load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    rec = 12 + (12 if normals is not None else 0) + (3 if colors is not None else 0)
    out = np.empty(n * rec, np.uint8)
    nrm_p = (_f32p(np.ascontiguousarray(normals, np.float32))
             if normals is not None else None)
    rgb_p = (_u8p(np.ascontiguousarray(colors, np.uint8))
             if colors is not None else None)
    lib.ply_pack(n, _f32p(xyz), nrm_p, rgb_p, int(bgr), _u8p(out))
    return out.tobytes()


def pack_faces(faces: np.ndarray) -> bytes:
    lib = load()
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty(len(faces) * 13, np.uint8)
    lib.ply_pack_faces(len(faces), faces.ctypes.data_as(_cip), _u8p(out))
    return out.tobytes()


def cloud_sor_stats(pts: np.ndarray, valid: np.ndarray, cell: float,
                    k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact-within-27-cells k-NN mean distance (src/cloud_stats.cpp)."""
    lib = load()
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    n = len(pts)
    mean_d = np.empty(n, np.float32)
    has = np.empty(n, np.uint8)
    lib.cloud_sor_stats(_f32p(pts), _u8p(v), n, ctypes.c_float(cell), int(k),
                        _f32p(mean_d), _u8p(has))
    return mean_d, has.astype(bool)


def cloud_normals(pts: np.ndarray, valid: np.ndarray, radius: float,
                  viewpoint: np.ndarray) -> np.ndarray:
    lib = load()
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    vp = np.ascontiguousarray(viewpoint, np.float32)
    out = np.empty_like(pts)
    lib.cloud_normals(_f32p(pts), _u8p(v), len(pts), ctypes.c_float(radius),
                      _f32p(vp), _f32p(out))
    return out


def cloud_mls(pts: np.ndarray, valid: np.ndarray, radius: float,
              prev_normals: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = load()
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    pn = np.ascontiguousarray(prev_normals, np.float32)
    out_p = np.empty_like(pts)
    out_n = np.empty_like(pts)
    ok = np.empty(len(pts), np.uint8)
    lib.cloud_mls(_f32p(pts), _u8p(v), len(pts), ctypes.c_float(radius),
                  _f32p(pn), _f32p(out_p), _f32p(out_n), _u8p(ok))
    return out_p, out_n, ok.astype(bool)


def laplacian_cotan(verts: np.ndarray, faces: np.ndarray, iterations: int,
                    lam: float, is_bnd: np.ndarray) -> np.ndarray:
    """Cotangent Laplacian smoothing; returns the smoothed float64 vertices."""
    lib = load()
    v = np.ascontiguousarray(verts, np.float64).copy()
    f = np.ascontiguousarray(faces, np.int32)
    bnd = np.ascontiguousarray(is_bnd, np.uint8)
    lib.laplacian_cotan(v.ctypes.data_as(_cdp), len(v), f.ctypes.data_as(_cip),
                        len(f), int(iterations), float(lam), _u8p(bnd))
    return v
