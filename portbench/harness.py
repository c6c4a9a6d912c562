"""One run of one cell: set-up, the measured window, the traced stretches
and the comparison, → the contract's result line.

The window drives the servers of lyra_tpu_torch (tools/stream_server.py)
as a serving host does, without the UDP tier: a closed loop with one tick
in flight.  Tick t hands every stream's PCM to
`EncoderServer.tick_wire_async`, which returns tick t − 1's wire bytes and
sizes; the mix's loss channel drops packets of those on the host; and
`DecoderServer.tick_wire_async` takes them and returns tick t − 2's PCM.
Tick t + 1 starts as soon as tick t's calls return.

A fleet's mix (portbench/fleet.py) drives a ServerPool pair the same way,
and before each tick's submit ends and admits the streams its churn
schedule names.

Everything a cell needs is found by name (portbench/spec.py): the
configuration's file, the mix's file, and one module per per-layer metric
under portbench/metrics.  The configuration names the codec's pieces:
its hop (`hop_ms`), the port's engine classes the servers run
(`engines`), the plain reference the comparison runs (`reference`) and
the class that counts a tick's work (`work`).  After the window every
run profiles a stretch of the same async ticks, from empty pipelines to
drained ones (portbench/profiling.py): the card's own time per tick,
which `card_streams` reads.  A `--trace 1` run measures the same window
(served_streams and tick_mfu_pct read it), reads its per-layer metrics
from that profile and times a stretch of synchronous tick pairs; every
tick of the run, set-up's too, goes to the comparison
(portbench/compare.py), which runs after the program's state is freed.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import compare, profiling, spec
from portbench.fleet import Fleet
from portbench.traffic import CHURN_CYCLE, Traffic, bitrate_of

PROFILED_TICKS = CHURN_CYCLE  # ticks in each profiler window: one churn cycle
SYNC_TICKS = 40  # synchronous tick pairs timed in a traced run
HOST_THREADS = 2  # torch's host threads: the tick's host work is numpy


class _Loop:
    """The server pair, the traffic and what each tick left behind."""

    def __init__(self, enc, dec, traffic: Traffic, rec: compare.Record,
                 cuda: bool, fleet=None):
        self.enc, self.dec, self.traffic, self.rec = enc, dec, traffic, rec
        self.cuda, self.fleet = cuda, fleet
        self.t = 0  # the next tick to submit
        self.enc_pending = self.dec_pending = None  # ticks in the pipelines
        self.submitted: Dict[int, float] = {}
        self.done: Dict[int, float] = {}

    def _decode(self, t, wire, sizes, asynchronous=True):
        self.rec.encoded(t, wire, sizes)
        recv = self.traffic.received(t) & (sizes > 0)
        self.rec.sent(t, recv)
        with torch.profiler.record_function("portbench.decode_tick"):
            if asynchronous:
                return self.dec.tick_wire_async(wire, recv, sizes)
            return self.dec.tick_wire(wire, recv, sizes)

    def _decoded(self, t, wire, sizes) -> None:
        """Tick t's wire into the decoder's pipeline; the tick it held
        before comes out."""
        pcm = self._decode(t, wire, sizes)
        prev, self.dec_pending = self.dec_pending, t
        if prev is not None:
            self.done[prev] = time.perf_counter()
            self.rec.decoded(prev, pcm)

    def _begin(self, setup: bool = False) -> int:
        """The next tick: a fleet's churn, then its PCM goes in."""
        t = self.t
        self.t += 1
        if self.fleet is not None:
            with torch.profiler.record_function("portbench.churn"):
                self.fleet.churn(t, setup)
        self.rec.submitted(t)
        return t

    def warm_up(self) -> None:
        """Set-up's ticks (the mix's `setup_ticks`): every program captured
        from both of its state trees (a fleet's admission programs too:
        its extra churn)."""
        for i in range(self.traffic.setup_ticks):
            self.tick(setup=i == 2)

    def tick(self, setup: bool = False) -> None:
        t = self._begin(setup)
        self.submitted[t] = time.perf_counter()
        with torch.profiler.record_function("portbench.encode_tick"):
            out = self.enc.tick_wire_async(self.traffic.pcm(t))
        prev, self.enc_pending = self.enc_pending, t
        if out is not None:
            self._decoded(prev, *out)

    def flush(self) -> None:
        """Drain both pipelines: every submitted tick decoded."""
        out = self.enc.flush_wire_async()
        if out is not None:
            self._decoded(self.enc_pending, *out)
        self.enc_pending = None
        if self.dec_pending is not None:
            self.rec.decoded(self.dec_pending, self.dec.flush_wire_async())
        self.dec_pending = None

    def stretch(self, ticks: int) -> None:
        """`ticks` ticks from empty pipelines, then both drained: every
        tick's encoder and decoder programs, and nothing else."""
        for _ in range(ticks):
            self.tick()
        self.flush()

    def sync_tick(self) -> float:
        """One synchronous tick pair (the pipelines drained); → its wall s."""
        t = self._begin()
        _sync(self.cuda)
        t0 = time.perf_counter()
        wire, sizes = self.enc.tick_wire(self.traffic.pcm(t))
        pcm = self._decode(t, wire, sizes, asynchronous=False)
        wall = time.perf_counter() - t0
        self.rec.decoded(t, pcm)
        return wall


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def streams_carried(streams: int, ticks: int, hop_s: float,
                    seconds: float) -> float:
    """Streams whose audio `ticks` ticks of `streams` streams carry in
    `seconds`: each tick is one hop of `hop_s` seconds of every stream."""
    return streams * ticks * hop_s / seconds


def _servers(cfg: dict, streams: int, bits: int, device, engine_kwargs):
    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    rate = int(cfg["sample_rate_hz"])
    enc = EncoderServer(streams, engine=spec.engine(
        cfg, "encoder", rate, device, engine_kwargs),
        bitrate=bitrate_of(bits, cfg["hop_ms"]))
    dec = DecoderServer(streams, engine=spec.engine(
        cfg, "decoder", rate, device, engine_kwargs))
    for server in (enc, dec):
        server.add_streams(range(streams))
    return enc, dec


def _bad_packets(dec, fleet) -> int:
    """Packets the decoder has counted bad so far: a fleet's ended
    streams' counts too (an admission resets its slot's counter)."""
    return int(dec.bad_packets.sum()) + (
        fleet.ended_bad_packets if fleet is not None else 0)


def _pair(cfg: dict, traffic: Traffic, device, engine_kwargs):
    """The cell's encoder and decoder: one server pair, or for a fleet's
    mix a ServerPool pair (portbench/fleet.py); → (enc, dec, the fleet or
    None)."""
    if traffic.layout is None:
        return (*_servers(cfg, traffic.streams, traffic.bits, device,
                          engine_kwargs), None)
    fleet = Fleet(cfg, traffic, device, engine_kwargs)
    return fleet.enc, fleet.dec, fleet


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: str = ".", device=None, setup_start: Optional[float] = None,
        engine_kwargs: Optional[dict] = None,
        tf32: Optional[bool] = None) -> tuple:
    """One run of `workload`; → (result dict, [stderr lines]).  `device`
    None is the card; tests pass "cpu".  `engine_kwargs` and `tf32`
    override the configuration's engine arguments and TF32 flag: the
    precision controls' runs, never the benchmark's."""
    setup_start = time.perf_counter() if setup_start is None else setup_start
    torch.set_num_threads(HOST_THREADS)
    cell = spec.load(root, workload)
    cfg, mix = cell.config, cell.mix
    cuda = device is None
    device = torch.device("cuda" if cuda else device)
    tf32 = bool(cfg.get("tf32", False)) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rate = int(cfg["sample_rate_hz"])
    marks = [("process start to the run", time.perf_counter())]
    traffic = Traffic(mix, seed, rate, cfg["hop_ms"], device)
    marks.append(("traffic", time.perf_counter()))
    enc, dec, fleet = _pair(cfg, traffic, device, engine_kwargs)
    if fleet is None:
        rows = compare.sample_rows(traffic.seed, traffic.streams,
                                   traffic.burst_rows)
        rec = compare.Record(rows, -(-traffic.bits // 8))
    else:
        rows = compare.sample_fleet_rows(
            traffic.seed, fleet.owner >= 0, fleet.layout.row_rates(),
            fleet.bits, fleet.layout.row_waves(), traffic.burst_rows,
            compare.CHECK_ROWS)
        rec = compare.Record(rows, None, fleet)
    marks.append(("servers", time.perf_counter()))
    loop = _Loop(enc, dec, traffic, rec, cuda, fleet)
    loop.warm_up()
    _sync(cuda)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - setup_start
    setup_parts = ", ".join(
        f"{name} {b - a:.2f} s" for (_, a), (name, b) in
        zip([("", setup_start)] + marks[:-1], marks))

    # The measured window: a fixed length of closed-loop ticks, with the
    # collector off (a pause would land inside one tick's latency).
    gc.collect()
    gc.disable()
    bad0 = _bad_packets(dec, fleet)
    first = loop.t
    events0 = fleet.events if fleet is not None else 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        loop.tick()
    w1 = time.perf_counter()
    window_s = w1 - w0
    in_window = [t for t in range(first, loop.t) if t in loop.done]
    completed = sum(1 for t, d in loop.done.items() if w0 <= d <= w1)
    latency_ms = np.array([(loop.done[t] - loop.submitted[t]) * 1e3
                           for t in in_window])
    per_s = np.bincount([int(d - w0) for d in loop.done.values()
                         if w0 <= d <= w1], minlength=int(seconds))
    attempted = traffic.streams * (loop.t - first)
    failed = _bad_packets(dec, fleet) - bad0
    failed += traffic.streams * sum(
        1 for t in range(first, loop.t) if t in loop.done
        and t not in rec.pcm)
    loop.flush()
    gc.enable()
    churned = fleet.events - events0 if fleet is not None else 0

    reading, windows = profiling.recorded(
        lambda: loop.stretch(PROFILED_TICKS), cuda)
    if trace:
        window = {"ticks": completed, "window_s": window_s,
                  "streams": traffic.streams, "hop_s": traffic.hop_s}
        walls = [loop.sync_tick() for _ in range(SYNC_TICKS)]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name() if cuda else str(device)
    if fleet is not None:
        fleet.close()
    del enc, dec, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings = compare.judge(rec, traffic, cfg, device)
    ok, checks = compare.verdict(readings, cfg.get("limits", {}))
    notes = [f"set-up {setup_s:.2f} s: {setup_parts}",
             f"compared {int(readings['_streams'])} streams on {len(rows)} "
             f"rows over {int(readings['_ticks'])} "
             f"ticks in {readings['_seconds']:.1f} s; the largest PCM gap: "
             f"{readings['_worst']}"]
    if fleet is not None:
        notes.append(f"churn events in the window {churned}, in the run "
                     f"{fleet.events}; {fleet.summary()}")

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else device.type, "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": int(attempted),
              "failed": int(failed)}
    busy_s = reading["busy_s"]
    if not trace:
        values = {
            "realtime_streams": streams_carried(
                traffic.streams, completed, traffic.hop_s, window_s),
            # Streams whose hops the card's own time per tick carries: the
            # device's busy time (kernels and copies, their union on the
            # profiler's timeline) over whole ticks, whatever the host does.
            "card_streams": streams_carried(
                traffic.streams, PROFILED_TICKS, traffic.hop_s, busy_s)
            if busy_s > 0 else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        notes.append(f"window {window_s:.3f} s, {completed} ticks completed "
                     f"(per second: {per_s.tolist()}), {latency_ms.size} hop "
                     f"latencies, p50 {np.percentile(latency_ms, 50):.3f} ms; "
                     f"card busy {busy_s / PROFILED_TICKS * 1e3:.4f} ms a "
                     f"tick (profiler windows taken {windows})")
    else:
        ctx = {"config": cfg, "mix": mix, "streams": traffic.streams,
               "bits": traffic.bits, "window": window,
               "hop_latency_ms": latency_ms,
               "profile": reading, "profiled_ticks": PROFILED_TICKS,
               "sync_wall_s": walls, "work": spec.named(cfg["work"])(
                   cfg, traffic.streams, traffic.bits if fleet is None
                   else fleet.admitted_bits())}
        for m in cell.per_layer:
            mod = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = mod.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info["busy_s"] = reading["busy_s"]
        device_info["window_s"] = reading["window_s"]
        ops = sorted(((n, s) for n, (s, _) in reading["by_name"].items()),
                     key=lambda x: -x[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in ops],
                               "idle_gaps": [list(g) for g in
                                             reading["gaps"]]}
        notes.append(f"profiler windows taken {windows}; "
                     f"{reading['kernels']} kernels in {PROFILED_TICKS} ticks")
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    return result, notes
