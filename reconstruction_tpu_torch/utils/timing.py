"""Wall-clock stage timing (counterpart of `reconstruction_tpu/utils/timing.py`)
and the program's span log.

`Timer` collects named spans into a dict.  On a CUDA device a span starts
and ends with `torch.cuda.synchronize()`, so the work queued inside it is
counted in it and not in the next span.

`span(name)` marks a block of the program in a process-wide log, on the
clock of the profiler's events (`time.time_ns()`, Unix nanoseconds: kineto
converts its host and device timestamps to that base).  It records only
while a `torch.profiler` session is active, read from torch's own flag;
otherwise it returns one shared no-op context, with no clock read.  It
never synchronizes the card and never calls into the profiler.  While on,
`Timer` spans record into the log too, under their own names, so stage
spans and the spans inside them share one clock.  `span_mark()` and
`span_records(mark)` read the records appended since a mark without
clearing them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# The records the log keeps; older ones are dropped (about 40 MB at most).
LOG_CAPACITY = 1 << 18


class SpanRecord(NamedTuple):
    """One finished span: its name, the name of the span open around it on
    the same thread (None at the top), the thread's identifier, and its
    start and end in Unix nanoseconds."""

    name: str
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


_LOG: deque = deque(maxlen=LOG_CAPACITY)
_APPENDED = 0                   # records appended since the process started
_LOCK = threading.Lock()
_OPEN = threading.local()       # .stack: names of the spans open on this thread
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "parent", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _APPENDED
        end = time.time_ns()
        _OPEN.stack.pop()
        rec = SpanRecord(self.name, self.parent, threading.get_ident(), self.start_ns, end)
        with _LOCK:
            _LOG.append(rec)
            _APPENDED += 1
        return False


def span(name: str):
    """A context that records ``name`` in the span log while a
    torch.profiler session is active, and the shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_mark() -> int:
    """The number of records appended so far: a mark for `span_records`."""
    with _LOCK:
        return _APPENDED


def span_records(mark: int = 0) -> List[SpanRecord]:
    """The records appended since ``mark``, oldest first (those the
    bounded log still holds)."""
    with _LOCK:
        n = min(_APPENDED - mark, len(_LOG))
        return list(_LOG)[len(_LOG) - n:] if n > 0 else []


class Timer:
    """Collects named wall-clock spans; a name used twice adds up."""

    def __init__(self, device="cpu") -> None:
        self.spans: Dict[str, float] = {}
        self.sync = torch.device(device).type == "cuda"

    class _Span:
        def __init__(self, timer: "Timer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            if self.timer.sync:
                torch.cuda.synchronize()
            self.logged = span(self.name)
            self.logged.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self.timer.sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - self.t0
            self.logged.__exit__(*exc)
            self.timer.spans[self.name] = self.timer.spans.get(self.name, 0.0) + dt
            return False

    def span(self, name: str) -> "Timer._Span":
        return Timer._Span(self, name)

    def report(self) -> str:
        total = sum(self.spans.values())
        lines = [f"{k:<32s} {v:8.3f}s" for k, v in self.spans.items()]
        lines.append(f"{'total':<32s} {total:8.3f}s")
        return "\n".join(lines)
