"""OpenCV FileStorage YAML reader and writer (counterpart of
`reconstruction_tpu/io/opencv_yaml.py`).

The reference's run config and calibration files are `cv::FileStorage`
YAML (`reconstruction/CManageData.cpp:24-66`, written by
`BatchProcess/main.cpp:47-73`).  The port parses that dialect itself, so
it needs no YAML library on any machine:

  * the `%YAML:1.0` header and `---`;
  * top-level `key: scalar` and `key: "string"`; ints, floats (also in e
    notation, `.Nan` and `.Inf` as OpenCV writes them) and bare strings;
  * block lists of `- item` under `key:`, and flow lists `key: [ ... ]`
    of scalars;
  * `!!opencv-matrix` mappings of `rows`, `cols`, `dt` (one of
    u c w s i f d) and `data: [ ... ]`, where `data` may run over several
    lines as OpenCV wraps it.

Anything else raises ValueError naming the file and line.  Matrices come
back as numpy arrays of their `dt`, everything else as Python values.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

import numpy as np

_CV_DTYPES = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
              "i": np.int32, "f": np.float32, "d": np.float64}

_KEY = re.compile(r"^([^\s#:\-][^:]*?):(?:\s+(.*?))?\s*$")
_ITEM = re.compile(r"^\s*-\s+(.*?)\s*$")
_FIELD = re.compile(r"^\s+(rows|cols|dt|data):\s*(.*?)\s*$")
_INT = re.compile(r"^[-+]?\d+$")
_FLOAT = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")
_SPECIAL = {".nan": math.nan, ".inf": math.inf, "+.inf": math.inf,
            "-.inf": -math.inf}
# Bare words that a YAML loader reads as booleans or null: ambiguous here.
_YAML_WORDS = {"true", "false", "yes", "no", "on", "off", "null", "~", "y", "n"}


class _Lines:
    """The file's lines with their numbers, for errors that name them."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.lines = text.splitlines()
        self.i = 0

    def error(self, lineno: int, what: str) -> ValueError:
        line = self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""
        return ValueError(f"{self.path}:{lineno}: {what}: {line!r}")

    def peek(self) -> Tuple[int, str]:
        """(line number, line) of the next line that is not blank or a
        comment, or (0, "") at the end."""
        while self.i < len(self.lines):
            s = self.lines[self.i].strip()
            if s and not s.startswith("#"):
                return self.i + 1, self.lines[self.i]
            self.i += 1
        return 0, ""

    def take(self) -> Tuple[int, str]:
        lineno, line = self.peek()
        self.i += 1
        return lineno, line


def _scalar(src: _Lines, lineno: int, text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return t[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if _INT.match(t):
        return int(t)
    if t.lower() in _SPECIAL:
        return _SPECIAL[t.lower()]
    if _FLOAT.match(t):
        return float(t)
    if not t or t.lower() in _YAML_WORDS or t[0] in "[]{}!&*'\"|>%@`#,":
        raise src.error(lineno, f"unsupported value {t!r}")
    return t


def _flow_items(src: _Lines, lineno: int, first: str) -> List:
    """The scalars of a `[ a, b, ... ]` flow list that starts in ``first``
    and may run over the following lines."""
    text = first
    while "]" not in text:
        n, line = src.take()
        if not n:
            raise src.error(lineno, "unterminated '['")
        text += " " + line.strip()
    body, _, rest = text.strip()[1:].partition("]")
    if rest.strip():
        raise src.error(lineno, "text after ']'")
    parts = [p for p in (s.strip() for s in body.split(",")) if p]
    return [_scalar(src, lineno, p) for p in parts]


def _matrix(src: _Lines, lineno: int) -> np.ndarray:
    fields: Dict[str, Any] = {}
    while True:
        n, line = src.peek()
        m = _FIELD.match(line) if n else None
        if not m:
            break
        src.take()
        name, value = m.groups()
        if name in fields:
            raise src.error(n, f"repeated matrix field {name!r}")
        if name == "data":
            if not value.startswith("["):
                raise src.error(n, "matrix data is not a '[ ... ]' list")
            fields[name] = _flow_items(src, n, value)
        elif name == "dt":
            fields[name] = value.strip('"')
        else:
            if not _INT.match(value):
                raise src.error(n, f"matrix {name} is not an integer")
            fields[name] = int(value)
    for name in ("rows", "cols", "data"):
        if name not in fields:
            raise src.error(lineno, f"matrix without {name!r}")
    dt = fields.get("dt", "d")
    if dt not in _CV_DTYPES:
        raise src.error(lineno, f"unsupported matrix dt {dt!r}")
    rows, cols, data = fields["rows"], fields["cols"], fields["data"]
    if len(data) != rows * cols:
        raise src.error(lineno, f"{len(data)} values for a {rows}x{cols} matrix")
    return np.asarray(data, dtype=_CV_DTYPES[dt]).reshape(rows, cols)


def _block_items(src: _Lines) -> List:
    items = []
    while True:
        n, line = src.peek()
        m = _ITEM.match(line) if n else None
        if not m:
            return items
        src.take()
        items.append(_scalar(src, n, m.group(1)))


def load_opencv_yaml(path: str) -> Dict[str, Any]:
    """Parse an OpenCV FileStorage YAML file into a plain dict.

    Matrix nodes come back as numpy arrays; everything else as native types.
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        src = _Lines(path, f.read())
    n, line = src.peek()
    if n and line.startswith("%YAML"):
        src.take()
        n, line = src.peek()
    if n and line.strip() == "---":
        src.take()
    out: Dict[str, Any] = {}
    while True:
        n, line = src.take()
        if not n or line.strip() == "...":
            return out
        m = _KEY.match(line)
        if not m:
            raise src.error(n, "expected 'key: value' at the start of the line")
        key, rest = m.group(1).strip(), (m.group(2) or "")
        if key in out:
            raise src.error(n, f"repeated key {key!r}")
        if rest == "!!opencv-matrix":
            out[key] = _matrix(src, n)
        elif rest == "":
            items = _block_items(src)
            out[key] = items if items else None
        elif rest.startswith("["):
            out[key] = _flow_items(src, n, rest)
        else:
            out[key] = _scalar(src, n, rest)


def save_opencv_yaml(path: str, data: Dict[str, Any]) -> None:
    """Write a dict in OpenCV FileStorage YAML dialect (matrices tagged)."""
    lines = ["%YAML:1.0", "---"]
    for k, v in data.items():
        if isinstance(v, np.ndarray):
            dt = {v2: k2 for k2, v2 in _CV_DTYPES.items()}[v.dtype.type]
            flat = ", ".join(repr(float(x)) if dt in "fd" else str(int(x))
                             for x in v.ravel())
            lines.append(f"{k}: !!opencv-matrix")
            lines.append(f"   rows: {v.shape[0]}")
            lines.append(f"   cols: {v.shape[1] if v.ndim > 1 else 1}")
            lines.append(f'   dt: {dt}')
            lines.append(f"   data: [ {flat} ]")
        elif isinstance(v, (list, tuple)):
            items = "".join(f'\n   - "{x}"' for x in v)
            lines.append(f"{k}:{items}")
        elif isinstance(v, str):
            lines.append(f'{k}: "{v}"')
        else:
            lines.append(f"{k}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
