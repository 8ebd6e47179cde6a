"""PLY point-cloud / mesh I/O (a copy of `reconstruction_tpu/io/ply.py`).

Replaces the reference's vendored rply (`CloudOptimization/rply.{h,c}`), the
hand-rolled binary writers (`reconstruction/CStereoMatching.cpp:723-757`,
`Kinect2Cloud/CKinect2Cloud.cpp:74-81`) and the rply-based recolor bridge
(`CloudOptimization/my_ply_interface.cpp`).

NumPy with vectorized struct packing; binary payloads are packed by the
native library (`reconstruction_tpu_torch.native`) unless the caller asks
for the NumPy packing, its plain version.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


@dataclass
class PlyData:
    """Parsed PLY contents.

    vertex_data maps property name -> (N,) array; faces is (F, 3) int32 (or
    None for point clouds).
    """

    vertex_data: Dict[str, np.ndarray] = field(default_factory=dict)
    faces: Optional[np.ndarray] = None

    @property
    def xyz(self) -> np.ndarray:
        return np.stack([self.vertex_data[k] for k in ("x", "y", "z")], axis=1)

    @property
    def normals(self) -> Optional[np.ndarray]:
        if "nx" not in self.vertex_data:
            return None
        return np.stack(
            [self.vertex_data[k] for k in ("nx", "ny", "nz")], axis=1)

    @property
    def colors(self) -> Optional[np.ndarray]:
        for keys in (("red", "green", "blue"), ("r", "g", "b")):
            if keys[0] in self.vertex_data:
                return np.stack([self.vertex_data[k] for k in keys], axis=1)
        return None


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = "ascii"
    elements: List[Tuple[str, int, List[Tuple[str, str, Optional[Tuple[str, str]]]]]] = []
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], "list", (_DTYPES[tok[2]], _DTYPES[tok[3]])))
            else:
                elements[-1][2].append((tok[2], "scalar", (_DTYPES[tok[1]], "")))

    endian = "<" if fmt != "binary_big_endian" else ">"
    out = PlyData()
    offset = 0
    if fmt == "ascii":
        text_rows = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                ncols = len(props)
                arr = np.array(text_rows[pos: pos + count * ncols], np.float64
                               ).reshape(count, ncols)
                pos += count * ncols
                for ci, (pname, kind, (dt, _)) in enumerate(props):
                    out.vertex_data[pname] = arr[:, ci].astype(np.dtype(dt))
            elif name == "face":
                faces = []
                for _ in range(count):
                    n = int(text_rows[pos]); pos += 1
                    faces.append([int(v) for v in text_rows[pos: pos + n]])
                    pos += n
                out.faces = np.asarray(faces, np.int32)
            else:
                for _ in range(count):
                    for pname, kind, _ in props:
                        if kind == "list":
                            n = int(text_rows[pos]); pos += 1 + n
                        else:
                            pos += 1
        return out

    for name, count, props in elements:
        if all(kind == "scalar" for _, kind, _ in props):
            dt = np.dtype([(p, endian + d[0]) for p, _, d in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            if name == "vertex":
                for pname, _, _ in props:
                    out.vertex_data[pname] = np.ascontiguousarray(arr[pname])
        elif name == "face" and len(props) == 1:
            cnt_dt, idx_dt = props[0][2]
            cnt_size = np.dtype(cnt_dt).itemsize
            idx_size = np.dtype(idx_dt).itemsize
            if count == 0:
                out.faces = np.zeros((0, 3), np.int32)
                continue
            # Fast path: assume uniform triangle rows; verify & fall back.
            row = cnt_size + 3 * idx_size
            if offset + row * count <= len(body):
                counts = np.frombuffer(body, dtype=endian + cnt_dt,
                                       count=count, offset=offset)[::1]
                stride_ok = False
                cview = np.frombuffer(
                    body[offset: offset + row * count], dtype=np.uint8
                ).reshape(count, row)
                ccol = cview[:, :cnt_size].copy().view(endian + cnt_dt).ravel()
                stride_ok = bool((ccol == 3).all())
                if stride_ok:
                    idx = cview[:, cnt_size:].copy().view(endian + idx_dt)
                    out.faces = idx.reshape(count, 3).astype(np.int32)
                    offset += row * count
                    continue
            # Irregular polygon sizes: slow path.
            faces = []
            for _ in range(count):
                n = int(np.frombuffer(body, endian + cnt_dt, 1, offset)[0])
                offset += cnt_size
                iv = np.frombuffer(body, endian + idx_dt, n, offset)
                offset += idx_size * n
                if n == 3:
                    faces.append(iv.astype(np.int32))
                else:  # fan-triangulate
                    for k in range(1, n - 1):
                        faces.append(np.array([iv[0], iv[k], iv[k + 1]], np.int32))
            out.faces = np.asarray(faces, np.int32)
        else:
            raise ValueError(f"unsupported PLY element {name!r}")
    return out


def write_ply(
    path: str,
    xyz: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    binary: bool = True,
    color_order: str = "rgb",
    use_native: bool = True,
) -> None:
    """Write a point cloud or mesh.

    ``color_order="bgr"`` reproduces the reference's per-pair cloud files,
    which store blue/green/red properties (`CStereoMatching.cpp:728`).
    ``use_native``: pack binary payloads in the native library (built at
    first use; raises when it cannot be built), else in NumPy.
    """
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    cols: List[Tuple[str, np.ndarray]] = [
        ("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2])]
    if normals is not None:
        nrm = np.asarray(normals, np.float32)
        cols += [("nx", nrm[:, 0]), ("ny", nrm[:, 1]), ("nz", nrm[:, 2])]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(c, 0, 255).astype(np.uint8)
        names = ("blue", "green", "red") if color_order == "bgr" else (
            "red", "green", "blue")
        order = (2, 1, 0) if color_order == "bgr" else (0, 1, 2)
        for nm, ci in zip(names, order):
            cols.append((nm, c[:, ci]))

    buf = _io.BytesIO()
    fmt = "binary_little_endian" if binary else "ascii"
    buf.write(b"ply\n")
    buf.write(f"format {fmt} 1.0\n".encode())
    buf.write(f"element vertex {n}\n".encode())
    for nm, arr in cols:
        buf.write(f"property {_INV_DTYPES[arr.dtype.str[1:]]} {nm}\n".encode())
    if faces is not None:
        buf.write(f"element face {len(faces)}\n".encode())
        buf.write(b"property list uchar int vertex_indices\n")
    buf.write(b"end_header\n")

    if binary:
        packed = None
        # Native path for the standard xyz[+nrm][+rgb] layout
        # (native/src/ply_codec.cpp).
        if use_native:
            from reconstruction_tpu_torch import native
            cref = None
            if colors is not None:
                cref = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
            packed = native.pack_vertices(
                xyz, nrm if normals is not None else None,
                cref, bgr=(color_order == "bgr"))
        if packed is not None:
            buf.write(packed)
        else:
            rec = np.dtype([(nm, "<" + arr.dtype.str[1:]) for nm, arr in cols])
            table = np.empty(n, rec)
            for nm, arr in cols:
                table[nm] = arr
            buf.write(table.tobytes())
        if faces is not None:
            f = np.asarray(faces, np.int32)
            fp = None
            if use_native:
                from reconstruction_tpu_torch import native
                fp = native.pack_faces(f)
            if fp is not None:
                buf.write(fp)
            else:
                frec = np.empty(len(f), np.dtype([("c", "u1"),
                                                  ("v", "<i4", (3,))]))
                frec["c"] = 3
                frec["v"] = f
                buf.write(frec.tobytes())
    else:
        for i in range(n):
            buf.write(" ".join(str(arr[i]) for _, arr in cols).encode() + b"\n")
        if faces is not None:
            for f in np.asarray(faces, np.int64):
                buf.write(f"3 {f[0]} {f[1]} {f[2]}\n".encode())
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
