"""The port's tracer: host spans, counters and device markers, one per
process, off by default.

* `span(name, tick=None)` times a stretch of host code.  When tracing is
  on it enters `torch.profiler.record_function(name)`, so under a profiler
  the span lies on the same timeline and clock as the card's kernels, and
  it records `(name, tick, parent, t0_ns, t1_ns)` on `time.perf_counter_ns`
  in memory: `parent` is the index of the enclosing open span of the same
  thread (-1 for none), and a span given no tick takes its parent's.
* `count(name, n)` adds to an in-memory counter.  A CUDA graph runs no
  Python when it replays, so utils/capture.py takes the counts its capture
  made (`apart`) and adds them (`add`) at each replay: a count inside a
  captured step describes what every replay of it launches.
* `mark(name, where)` launches the device marker of segment `name`
  (ops/csrc/trace_mark.cu) on the current stream of `where`'s card (a
  tensor or a device), inside a CUDA-graph capture as outside one.  A
  marker survives capture where a host annotation does not: a profile's
  kernels belong to the segment of the last marker before them on the
  stream.  `name` is one of SEGMENTS.
* `drain()` returns what was recorded and clears it; `self_ns(spans)` gives
  each span's time less the part its children cover.

`enable()` / `disable()` switch it.  While it is off `span` returns one
shared null context, and `count` and `mark` return at once: one bool read a
site, nothing allocated, nothing launched.  So a graph captured with
tracing off holds no marker (utils/capture.py keys its graphs on
`enabled()` as well), and a process that never enables tracing never
builds the marker kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# The marker segments, each program's in the order it runs them.  A segment's id
# is its index: it is compiled into the marker kernel's name
# (`lyra_trace_mark<id>`), so append new names and never reorder.
SEGMENTS = (
    "graph.state_copy", "graph.end",
    "dec.wire_unpack", "dec.rvq_decode", "dec.plc",
    "gan.prologue", "gan.core", "gan.epilogue", "dec.gan_select",
    "dec.cng", "dec.crossfade", "dec.noise", "dec.resample", "dec.out",
    "enc.in", "enc.resample", "enc.noise",
    "ss.prologue", "ss.core", "ss.epilogue", "enc.ss_select", "enc.rvq",
    "enc.wire_pack",
)
_SEGMENT_ID = {name: i for i, name in enumerate(SEGMENTS)}
MARK_KERNEL = "lyra_trace_mark"

Span = Tuple[str, Optional[int], int, int, int]

_on = False
_NULL = contextlib.nullcontext()
_spans: List[list] = []
_counts: Dict[str, int] = {}
_local = threading.local()  # .open: [(span list, index)] of open spans


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "tick", "_range", "_rec")

    def __init__(self, name: str, tick: Optional[int]):
        self.name, self.tick = name, tick

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        parent, tick = -1, self.tick
        if stack and stack[-1][0] is _spans:  # not from before a drain
            parent = stack[-1][1]
            if tick is None:
                tick = _spans[parent][1]
        rec = [self.name, tick, parent, time.perf_counter_ns(), 0]
        _spans.append(rec)
        stack.append((_spans, len(_spans) - 1))
        self._rec = rec
        return self

    def __exit__(self, *exc):
        self._rec[4] = time.perf_counter_ns()
        _local.open.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, tick: Optional[int] = None):
    """A context manager timing the code inside it (see the module
    docstring); the shared null context while tracing is off."""
    if not _on:
        return _NULL
    return _Span(name, tick)


def count(name: str, n: int = 1) -> None:
    if _on:
        _counts[name] = _counts.get(name, 0) + int(n)


def add(counts: Dict[str, int]) -> None:
    """Adds every counter of `counts` (what `apart` gathered)."""
    for name, n in counts.items():
        count(name, n)


@contextlib.contextmanager
def apart():
    """Counts made inside go to the dict this yields, not to the
    counters."""
    global _counts
    outer = _counts
    _counts = {}
    try:
        yield _counts
    finally:
        _counts = outer


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """(the spans recorded, the counters) since the last drain; both are
    cleared.  A span still open is dropped, and its children get no
    parent."""
    global _spans, _counts
    spans, counts = _spans, _counts
    _spans, _counts = [], {}
    closed = [i for i, s in enumerate(spans) if s[4]]
    index = {old: new for new, old in enumerate(closed)}
    return [(s[0], s[1], index.get(s[2], -1), s[3], s[4])
            for s in (spans[i] for i in closed)], counts


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's duration less the time its children cover (children of
    one thread do not overlap)."""
    out = [s[4] - s[3] for s in spans]
    for s in spans:
        if s[2] >= 0:
            out[s[2]] -= s[4] - s[3]
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from lyra_tpu_torch.ops import cuda_build

    lib = cuda_build.load("trace_mark.cu")
    lib.lyra_trace_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.lyra_trace_mark_launch.restype = ctypes.c_int
    if len(SEGMENTS) > lib.lyra_trace_max_segments():
        raise RuntimeError("trace_mark.cu has fewer marker kernels than "
                           "SEGMENTS names")
    return lib


def mark(name: str, where) -> None:
    """Segment `name`'s marker on the current stream of `where` (a tensor's
    device, or a device); nothing while tracing is off or off the card."""
    if not _on:
        return
    device = where if isinstance(where, torch.device) else where.device
    if device.type != "cuda":
        return
    from lyra_tpu_torch.ops import cuda_build

    err = _lib().lyra_trace_mark_launch(_SEGMENT_ID[name],
                                        cuda_build.stream_handle(device))
    cuda_build.check(err, f"{MARK_KERNEL}<{_SEGMENT_ID[name]}>")
