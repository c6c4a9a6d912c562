"""The traced stretch of a `--trace 1` run: the port's tracer
(lyra_tpu_torch/utils/trace.py) on, the cell's async ticks under the
profiler, read by marker segment, by program span and by counter.

The harness frees its servers before it reads the per-layer metrics, so
the first metric that reads this stretch builds the cell's server pair
anew (`harness._pair`, the same programs at the same sizes, a fleet's
churn too), admits every stream, and warms it twice: tracing off, then on
(each mode's graphs captured; utils/capture.py keys its graphs on the
tracer's switch).  Then, on those servers:

  1. the tracer's host cost: `harness.PROFILED_TICKS` ticks and a flush
     timed on the host clock, tracing off and on in turn, ROUNDS times;
  2. profiler windows of the same stretch with tracing on
     (`profiling.profile`, till two hold one kernel count, as
     `profiling.recorded` takes them), the last one read.

The traffic is the cell's mix drawn from a fixed seed: these ticks are
timed and counted, never compared.  The reading is kept in the run's ctx
(ctx["traced"]), so every metric reads the same stretch, and its notes go
to standard error.  A checkout whose port has no tracer gives no reading
(None), and its metrics are left out of the line.

Device time by segment: a kernel or copy belongs to the segment of the
last `lyra_trace_mark<id>` before it on the timeline (the servers' one
stream); what follows a program's `graph.end` marker until the next
program's first marker (the servers' H2D and D2H copies) is
`server.copy`.  Host time by span: each span's self time
(`trace.self_ns`), summed by name over the stretch, per tick.  Idle gaps
of the device go to the innermost program span (a tracer span or a
`portbench.*` one) around their midpoint, else to "none".
"""

from __future__ import annotations

import gc
import re
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import compare, harness, profiling
from portbench.metrics.conv_stack_device_ms import K1_KERNELS
from portbench.traffic import Traffic

SEED = 2**31 + 17
ROUNDS = 3  # untraced / traced host-timed stretches, alternating
COPY = "server.copy"
_MARK = re.compile(r"lyra_trace_mark(?:<|ILi)(\d+)")


def reading(ctx) -> Optional[dict]:
    """The run's traced stretch (measured on the first call), or None."""
    if "traced" not in ctx:
        ctx["traced"] = _measure(ctx)
    return ctx["traced"]


def host_ms(ctx, *names: str) -> Optional[float]:
    """Self ms per tick of the spans `names`, summed; None without a
    reading or where none of them ran."""
    r = reading(ctx)
    if r is None or not any(n in r["host_ms"] for n in names):
        return None
    return sum(r["host_ms"].get(n, 0.0) for n in names)


def device_ms(ctx, *segments: str) -> Optional[float]:
    """Device ms per tick of the marker segments, summed; None where none
    of them was seen (the CPU, or a segment the cell does not run)."""
    r = reading(ctx)
    if r is None or not any(s in r["segments_ms"] for s in segments):
        return None
    return sum(r["segments_ms"].get(s, 0.0) for s in segments)


def _measure(ctx) -> Optional[dict]:
    try:
        from lyra_tpu_torch.utils import trace
    except ImportError:
        return None
    # The harness ran the cell on the card where it used the card at all
    # (a profile's content is no sign: a window can lose its device
    # records).  Device segments the stretch's own windows lost are left
    # out, never read from the CPU.
    cuda = torch.cuda.is_initialized()
    device = torch.device("cuda" if cuda else "cpu")
    cfg, ticks = ctx["config"], ctx["profiled_ticks"]
    traffic = Traffic(ctx["mix"], SEED, int(cfg["sample_rate_hz"]),
                      cfg["hop_ms"], device)
    enc, dec, fleet = harness._pair(cfg, traffic, device, None)
    rec = compare.Record(np.zeros(0, np.int64), None if fleet else
                         -(-traffic.bits // 8), fleet)
    loop = harness._Loop(enc, dec, traffic, rec, cuda, fleet)
    try:
        walls = {False: [], True: []}
        for traced in (False, True):
            (trace.enable if traced else trace.disable)()
            loop.warm_up()
            loop.flush()
        trace.drain()
        for _ in range(ROUNDS):
            for traced in (False, True):
                (trace.enable if traced else trace.disable)()
                harness._sync(cuda)
                t0 = time.perf_counter()
                loop.stretch(ticks)
                harness._sync(cuda)
                walls[traced].append((time.perf_counter() - t0) / ticks)
        trace.enable()
        _, timed = trace.drain()
        last = None
        for window in range(1, profiling.WINDOWS + 1):
            trace.drain()
            prof = profiling.profile(lambda: loop.stretch(ticks), cuda)
            spans, counts = trace.drain()
            agg = profiling.read(prof)
            done = last is not None and agg["kernels"] == last["kernels"]
            last = agg
            if done:
                break
        result = _read(prof, agg, spans, counts, ticks, trace)
    finally:
        trace.disable()
        trace.drain()
        del loop, enc, dec
        if fleet is not None:
            fleet.close()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    result["windows"] = window
    result["captures_timed"] = timed.get("graph.captures", 0)
    result["host_wall_ms"] = {k: statistics.median(v) * 1e3
                              for k, v in walls.items()}
    _notes(result, ctx, ticks)
    return result


def _read(prof, agg, spans, counts, ticks, trace) -> dict:
    events = prof.events()
    span = next(e for e in events if e.name == profiling.SPAN
                and not profiling._device(e))
    lo, hi = span.time_range.start, span.time_range.end
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not profiling._device(e)]
    host_names = {n for _, _, n in host}
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if profiling._device(e)
                 and e.name not in host_names
                 and not e.name.startswith("ProfilerStep"))
    segments: Dict[str, float] = {}
    markers = 0
    k1 = 0.0
    seg = COPY
    for a, b, name in dev:
        m = _MARK.search(name)
        if m:
            markers += 1
            seg = trace.SEGMENTS[int(m.group(1))]
        if b <= lo or a >= hi:
            continue
        us = min(b, hi) - max(a, lo)
        key = COPY if seg == "graph.end" else seg
        segments[key] = segments.get(key, 0.0) + us
        if any(profiling.own(k, name) for k in K1_KERNELS):
            k1 += us
    # Idle gaps by the innermost program span around their midpoint.
    program = {s[0] for s in spans}
    around = [h for h in host if h[2] in program
              or (h[2].startswith("portbench.") and h[2] != profiling.SPAN)]
    merged: List[List[float]] = []
    for a, b, _ in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [lo] + [x for m in merged for x in m] + [hi]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [h for h in around if h[0] <= mid <= h[1]]
        what = min(inside, key=lambda h: h[1] - h[0])[2] if inside \
            else "none"
        idle[what] = idle.get(what, 0.0) + (b - a)
    self_ms: Dict[str, float] = {}
    for s, ns in zip(spans, trace.self_ns(spans)):
        self_ms[s[0]] = self_ms.get(s[0], 0.0) + ns * 1e-6 / ticks
    per_tick = 1e-3 / ticks  # µs in the stretch → ms a tick
    return {
        "segments_ms": {k: v * per_tick for k, v in segments.items()},
        "k1_ms": k1 * per_tick,
        "markers": markers / ticks,
        "busy_ms": agg["busy_s"] * 1e3 / ticks,
        "idle_ms": {k: v * per_tick for k, v in idle.items()},
        "host_ms": self_ms,
        "spans": len(spans) / ticks,
        "counts": counts,
    }


def _notes(r: dict, ctx, ticks: int) -> None:
    """The stretch's tables, to standard error (before the harness's own
    notes)."""
    untraced = ctx["profile"]["busy_s"] * 1e3 / ctx["profiled_ticks"]
    seg = r["segments_ms"]
    lines = [f"traced stretch: {ticks} ticks, profiler windows taken "
             f"{r['windows']}; device busy {r['busy_ms']:.4f} ms a tick "
             f"traced, {untraced:.4f} untraced (the harness's stretch), "
             f"{r['markers']:.1f} markers and {r['spans']:.1f} spans a "
             f"tick; host wall {r['host_wall_ms'][True]:.4f} ms a tick "
             f"traced, {r['host_wall_ms'][False]:.4f} untraced (medians "
             f"of {ROUNDS}); graph.captures in the timed stretches "
             f"{r['captures_timed']}, in the profiled one "
             f"{r['counts'].get('graph.captures', 0)}"]
    if seg:
        total = sum(seg.values())
        core = seg.get("gan.core", 0.0) + seg.get("ss.core", 0.0)
        lines.append(
            f"segments: sum {total:.4f} ms a tick = "
            f"{100 * total / r['busy_ms']:.2f} % of busy; gan.core + "
            f"ss.core {core:.4f} ms, K1 by name {r['k1_ms']:.4f} ms "
            f"({100 * (core / r['k1_ms'] - 1) if r['k1_ms'] else 0:+.2f} %)")
        lines += [f"  segment {k}: {v:.4f} ms a tick"
                  for k, v in sorted(seg.items(), key=lambda x: -x[1])]
    idle = r["idle_ms"]
    total_idle = sum(idle.values())
    lines.append(f"idle by innermost program span: {total_idle:.4f} ms a "
                 f"tick")
    lines += [f"  idle {k}: {v:.4f} ms a tick "
              f"({100 * v / total_idle:.1f} %)"
              for k, v in sorted(idle.items(), key=lambda x: -x[1])
              if total_idle > 0]
    lines += [f"  host {k}: {v:.4f} ms a tick (self)"
              for k, v in sorted(r["host_ms"].items(), key=lambda x: -x[1])]
    lines.append("counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(r["counts"].items())))
    print("\n".join(lines), file=sys.stderr)
