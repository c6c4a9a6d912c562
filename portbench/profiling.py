"""Reading a torch.profiler window of served ticks.

`own`, the window retry and the device-event filter are copies of
chip_smoke.py's `_own`, `_recorded` and `_device_events` (d33c86f); the
timeline reading (busy union, idle gaps by what the host was doing) is
the benchmark's own.  A profiler window on the card now and then loses
device records (all of them, or its first few hundred µs): `recorded`
takes windows until two in a row hold the same count of kernels, which a
window of captured ticks repeats exactly, and reads the last.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

import torch

WINDOWS = 5  # at most this many profiler windows per traced run
SPAN = "portbench.profiled"  # the host span around a window's ticks


def own(name: str, event_name: str) -> bool:
    """A kernel's own name in a profiler event name, not a longer one that
    contains it (demangled "ns::conv1d_fwd(" or mangled "10conv1d_fwdE")."""
    return re.search(rf"(?<![A-Za-z_]){name}(?![a-z0-9_])", event_name) \
        is not None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def profile(run_ticks: Callable[[], None], cuda: bool = True):
    """`run_ticks()` under the profiler, inside the host span SPAN, with the
    device idle at both ends (`cuda` False: the host alone, for tests)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        sync()
        with torch.profiler.record_function(SPAN):
            run_ticks()
            sync()
    return prof


def recorded(run_ticks: Callable[[], None], cuda: bool = True):
    """→ (the reading of the last window, windows taken)."""
    last = None
    for window in range(1, WINDOWS + 1):
        reading = read(profile(run_ticks, cuda))
        if last is not None and reading["kernels"] == last["kernels"]:
            return reading, window
        last = reading
    return last, window


def _device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def read(prof) -> Dict:
    """The window's device events: time and count by name, the union of
    their intervals inside the host span, and the idle gaps on the device
    timeline with the innermost host event around each."""
    events = prof.events()
    span = next(e for e in events if e.name == SPAN and not _device(e))
    lo, hi = span.time_range.start, span.time_range.end
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _device(e) and e.name != SPAN]
    # The profiler also puts a host annotation's range (a record_function)
    # on the device's timeline, under the host event's name: not work.
    names = {n for _, _, n in host} | {SPAN}
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if _device(e) and e.name not in names
           and not e.name.startswith("ProfilerStep")]
    by_name: Dict[str, List[float]] = {}
    for a, b, n in dev:
        s = by_name.setdefault(n, [0.0, 0])
        s[0] += (b - a) * 1e-6
        s[1] += 1
    merged: List[List[float]] = []
    for a, b, _ in sorted(dev):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [lo] + [x for m in merged for x in m] + [hi]
    longest = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                      if b > a), reverse=True)[:10]
    gaps = []
    for length, a, b in longest:
        mid = (a + b) / 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        what = min(around, key=lambda h: h[1] - h[0])[2] if around else "none"
        gaps.append((what, length * 1e-6))
    return {
        "by_name": {n: (s, int(c)) for n, (s, c) in by_name.items()},
        "kernels": sum(c for n, (_, c) in by_name.items() if not is_copy(n)),
        "busy_s": busy,
        "window_s": (hi - lo) * 1e-6,
        "gaps": gaps,
    }
