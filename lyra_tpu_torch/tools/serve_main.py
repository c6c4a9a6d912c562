"""Runnable UDP decode server: lyra packets in, int16 PCM out — the port
of lyra_tpu/tools/serve_main.py to PyTorch on one CUDA card.

The reference ships per-file CLIs (encoder_main/decoder_main) and leaves
live serving to the app layer; this is the deployment counterpart as one
command — the full receive stack assembled and ticking:

  UDP datagrams (2 B slot + 4 B seq header + lyra packet)
    → native ingest pump (C++ recvmmsg thread, --ingest=native)
    → native JitterBuffer (reorder/dedup/playout delay)
    → DecoderServer.tick_wire_async (device unpack + decode, PLC/CNG; one
      CUDA-graph replay per tick, utils/capture.py, so the conv-stack
      kernels and, encoding, the RVQ kernel run inside this process)
    → int16 PCM hops, echoed as UDP datagrams to --echo host:port
      (same 6-byte header), or discarded with --echo none (stats only).

Every slot 0..capacity-1 is admitted at startup (the wire header's slot
field IS the stream identity, as in examples/udp_call.py); packets for
slots beyond capacity are counted drops.  One status line prints per
--report_every seconds: datagram/drop counters and tick-time
percentiles against the 20 ms real-time budget.  --stats PATH appends
the same snapshot as machine-readable JSON lines for an operator
(plus a final record at shutdown).

`--mode encode` is the reverse relay (PCM in, packets out) and `--mode
bridge` the conference MCU (tools/conference.py).  The engines take the
default backend ("kernel") in float mode, as the JAX host's do.  The
process runs on the card; `--devices N` shards the stream batch over the
first N attached cards (parallel/sharding.py), and is refused when fewer
are attached. `main(argv, device="cpu")` runs it on the CPU (the tests),
where `--devices N` names the CPU N times; there is no flag for that.
The first ticks capture the CUDA graphs and stall the 20 ms pacer once,
as the JAX host's first jit compile does.

Run:

    python -m lyra_tpu_torch.tools.serve_main --port 5620 --capacity 1024 \
        --seconds 30 --echo 127.0.0.1:5621
"""

from __future__ import annotations

import argparse
import json
import socket
import time

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch import packet as pkt
from lyra_tpu_torch.tools.control_auth import AuthError, Verifier
from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer
from lyra_tpu_torch.tools.stream_server import DecoderServer
from lyra_tpu_torch.utils import trace
from lyra_tpu_torch.utils.device import resolve

_HDR = 6  # 2 B slot + 4 B seq, big-endian (examples/udp_call.py layout)
_PERIOD_S = 0.020  # the tick grid


# Shared with the fleet tier: one JSON snapshot per line + final record.
from lyra_tpu_torch.tools.fleet import StatsSink as _StatsSink  # noqa: E402


class _Control:
    """UDP JSON control endpoint (--control PORT): the fleet-management
    plane of a serving host.  One datagram per command, one JSON reply to
    the sender; commands are handled at tick boundaries so state is never
    touched mid-step:

      {"cmd": "ping"}                      -> {"ok": true, "mode": ...}
      {"cmd": "stats"}                     -> {"ok": true, "stats": {...}}
      {"cmd": "save", "path": P}           -> snapshot, keep serving
      {"cmd": "restore", "path": P}        -> swap in a snapshot mid-flight
                                              (warm-standby handoff)
      {"cmd": "drain", "path": P}          -> snapshot, then stop serving
      {"cmd": "set_bitrate", "slot": N,
       "bitrate": B}                       -> per-stream downlink bitrate
                                              (encode/bridge; a congestion
                                              controller's knob)
      {"cmd": "quit"}                      -> stop serving

    save/restore/drain flush the async pipeline first (enforced by the
    servers — an unflushed tick would be silently lost), which skips one
    downlink hop; PLC covers it on the far end, the same contract as a
    lost packet.  A failed restore validates before mutating (see
    stream_server._server_restore), so the host keeps serving its old
    state and the requester gets the error.  An optional "req" field is
    echoed back so a UDP client can match replies to requests.

    The reference is a single-process codec with no serving tier; this is
    the deployment control surface its checkpoint-less design leaves to
    the app (SURVEY §5 checkpoint/resume).

    Trust boundary (enforced, not just documented): the endpoint binds
    loopback by default and stays keyless there; a routable
    --control_bind REQUIRES --control_key (refused at startup otherwise),
    and with a key every command must carry a valid HMAC + fresh
    timestamp/nonce (tools/control_auth.py — tampered, stale, or spliced
    datagrams are counted auth_rejects, never fatal).  Unlike the data
    sockets (which must be public and harden every wire event into a
    counted drop), the management plane can stop serving or swap engine
    state, so reachability alone must not be authority."""

    def __init__(self, port: int, bind: str = "127.0.0.1", key=None):
        self.auth_rejects = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind, port))
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]
        # A keyed endpoint must know its own identity (the audience the
        # signing clients dial); wildcard binds were refused in main().
        self._verifier = (Verifier(key, audience=f"{bind}:{self.port}")
                          if key is not None else None)

    def poll(self, server, snapshot, transport_save=None,
             transport_restore=None) -> bool:
        """Handle queued commands; True means stop serving (drain/quit).
        `transport_save() -> dict` contributes serving-layer state (the
        playout schedule) to save/drain snapshots; `transport_restore(tr)`
        re-seeds it after a restore (see _transport_state)."""
        stop = False
        while True:
            try:
                data, addr = self._sock.recvfrom(64 * 1024)
            except BlockingIOError:
                break
            except OSError:
                break
            try:
                cmd = json.loads(data.decode())
                if not isinstance(cmd, dict):
                    raise ValueError("command must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                self._reply(addr, {"ok": False, "error": f"bad command: {e}"})
                continue
            if self._verifier is not None:
                try:
                    self._verifier.verify(cmd)
                except AuthError as e:
                    self.auth_rejects += 1  # counted, never fatal
                    self._reply(addr, {"req": cmd.get("req"), "ok": False,
                                       "error": f"auth: {e}"})
                    continue
            reply = {"req": cmd.get("req"), "ok": True}
            name = cmd.get("cmd")
            try:
                if name == "ping":
                    reply["mode"] = snapshot()["mode"]
                elif name == "stats":
                    reply["stats"] = snapshot()
                elif name in ("save", "drain"):
                    server.flush_async()
                    server.save(cmd["path"],
                                transport_save() if transport_save else None)
                    reply["ticks"] = snapshot()["ticks"]
                    stop = stop or name == "drain"
                elif name == "restore":
                    server.flush_async()
                    tr = server.restore(cmd["path"])
                    if transport_restore is not None:
                        transport_restore(tr)
                elif name == "set_bitrate":
                    # Mid-call per-stream rate change (reference:
                    # lyra/lyra_encoder.cc:158-166 set_bitrate) — the knob
                    # an operator's congestion controller turns.  Takes
                    # effect at the next tick; the async wire path
                    # snapshots per-row bits at submit time, so an
                    # in-flight tick still packs with the config its
                    # indices were encoded for.
                    if not hasattr(server, "set_bitrate"):
                        raise RuntimeError(
                            "set_bitrate needs an encoder side (encode or "
                            "bridge mode); decode follows each packet's "
                            "wire size")
                    server.set_bitrate(int(cmd["slot"]),
                                       int(cmd["bitrate"]))
                elif name == "quit":
                    stop = True
                else:
                    reply = {"req": cmd.get("req"), "ok": False,
                             "error": f"unknown cmd {name!r}"}
            except Exception as e:  # keep serving; the requester learns why
                reply = {"req": cmd.get("req"), "ok": False,
                         "error": f"{type(e).__name__}: {e}"}
            self._reply(addr, reply)
        return stop

    def _reply(self, addr, obj) -> None:
        try:
            self._sock.sendto(json.dumps(obj).encode(), addr)
        except OSError:
            pass  # requester vanished; a control reply is best-effort

    def close(self) -> None:
        self._sock.close()


def _transport_state(ingest, adaptive: bool = False) -> dict:
    """Serving-layer state riding a snapshot: the jitter buffer's playout
    schedule (JitterBuffer.heads contract — next sequence per slot, -1
    inactive), plus — on adaptive hosts — each slot's learned playout
    delay and shrink streak (JitterBuffer.adapt_export).  Engine state
    alone is not enough to hand off a live call: without the schedule,
    the restored host re-derives each caller's sequence position from a
    streak of out-of-window drops (60-500 ms of lost audio per caller,
    native/jitter_buffer.cc resync rules); without the adaptive evidence,
    it re-drops from the configured base delay until the decision window
    re-learns — during exactly the burst that made adaptation necessary
    (measured A/B: benchmarks/adaptive_jitter_probe.py --failover)."""
    out = {"jb_heads": ingest.heads().tolist()}
    if adaptive:
        delays, votes = ingest.adapt_export()
        out["adapt_delays"] = delays.tolist()
        out["adapt_votes"] = votes.tolist()
    return out


def _reseed_transport(ingest, transport, capacity: int,
                      playout_delay: int, adaptive: bool = False) -> None:
    """Re-seed the ingest playout schedule from a restored snapshot's
    transport dict.  Slots the snapshot marks inactive (-1) keep their
    local admission state.  On an adaptive host (set_adaptive must be
    configured BEFORE this runs) a snapshot carrying adaptive evidence
    re-seeds each slot's learned delay + shrink streak; a static host, or
    a snapshot from one, keeps the configured base.  A snapshot without
    transport state (pre-schedule format) is left to the jitter buffer's
    streak resync."""
    heads = (transport or {}).get("jb_heads")
    if heads is None:
        return
    if len(heads) != capacity:
        raise ValueError(
            f"snapshot transport jb_heads has {len(heads)} rows; this "
            f"host serves {capacity}")
    delays = (transport or {}).get("adapt_delays")
    votes = (transport or {}).get("adapt_votes")
    carry = adaptive and delays is not None and votes is not None
    if carry and (len(delays) != capacity or len(votes) != capacity):
        raise ValueError(
            f"snapshot adaptive state has {len(delays)} rows; this "
            f"host serves {capacity}")
    for slot, head in enumerate(heads):
        if head >= 0:
            ingest.add_stream(slot, start_seq=int(head),
                              playout_delay=playout_delay)
            if carry and delays[slot] >= 0:
                ingest.adapt_seed(slot, int(delays[slot]),
                                  int(votes[slot]))


class _RedDownlink:
    """Sender-side RED framing for a packet downlink: datagram t carries
    packet t-D alongside packet t ([1B len][cur][1B len][prev],
    packet.build_red_batch), so the far receiver heals one lost datagram
    from its successor's redundant copy instead of concealing it — the
    transport-level shield in FRONT of the PLC machine the reference
    relies on alone (reference: lyra/lyra_decoder.cc:228-315).  Rows
    that emit nothing this tick (inactive slots, DTX noise hops:
    size <= 0) still send nothing, and the redundant block for a tick
    that emitted nothing is empty (len 0 — nothing to heal with; the
    far side's PLC/CNG covers it, same as a plain loss).  Costs one
    extra packet of payload per datagram: bandwidth for robustness,
    the sender twin of UdpIngest.set_red."""

    def __init__(self, offset: int, capacity: int):
        import collections

        self._hist = collections.deque(maxlen=offset)
        self._offset = offset
        self._zero_sizes = np.zeros(capacity, np.int32)

    def frame(self, wire: np.ndarray, sizes: np.ndarray):
        """→ (red_wire, red_sizes) for the egress; records this tick as
        history for the datagram D ticks from now."""
        wire = np.ascontiguousarray(wire)
        sizes = np.asarray(sizes, np.int32)
        if len(self._hist) == self._offset:
            prev, prev_sizes = self._hist[0]
        else:
            prev, prev_sizes = np.zeros_like(wire), self._zero_sizes
        if prev.shape[1] != wire.shape[1]:
            # A mid-call set_bitrate can widen/narrow the wire matrix;
            # frame at the union width so neither tick's packets truncate
            # (sizes bound the real bytes, the tails are padding).
            w = max(prev.shape[1], wire.shape[1])
            wide = np.zeros((wire.shape[0], w), np.uint8)
            wide[:, :wire.shape[1]] = wire
            pwide = np.zeros((prev.shape[0], w), np.uint8)
            pwide[:, :prev.shape[1]] = prev
            wire_f, prev = wide, pwide
        else:
            wire_f = wire
        red, red_sizes = pkt.build_red_batch(wire_f, sizes, prev, prev_sizes)
        red_sizes = np.where(sizes > 0, red_sizes, 0).astype(np.int32)
        self._hist.append((wire.copy(), sizes.copy()))
        return red, red_sizes


def _drain_python_rx(rx, jb, red: int) -> None:
    """Per-datagram python ingest drain (the no-native fallback; shared
    by the decode and bridge loops): parse the 6 B header and file into
    the jitter buffer.  With RED framing the payload splits into a
    primary + a redundant block (the mirror of the native pump's parse);
    junk — a ragged RED payload, a slot past capacity — is dropped,
    never filed and never an exception out of a serving tick."""
    while True:
        try:
            dgram, _ = rx.recvfrom(2048)
        except BlockingIOError:
            break
        slot = int.from_bytes(dgram[:2], "big")
        seq = int.from_bytes(dgram[2:_HDR], "big")
        try:
            if not red:
                jb.insert(slot, seq, dgram[_HDR:])
                continue
            cur, prev = pkt.parse_red(dgram[_HDR:])
            jb.insert(slot, seq, cur)
            if prev and seq >= red:
                jb.insert_red(slot, seq - red, prev)
        except ValueError:
            continue  # malformed-drop class (bad slot / ragged RED)


def _tick_pcts(tick_ms, tail: int | None = 256):
    """(p50, p95) of the recent tick latencies, rounded for reporting."""
    lat = np.array(tick_ms[-tail:] if tail else tick_ms)
    if lat.size == 0:
        lat = np.zeros(1)
    return round(float(np.median(lat)), 3), round(
        float(np.percentile(lat, 95)), 3)


class _PySender:
    """Per-datagram Python fan-out (the --egress=python fallback): same
    send(wire, sizes, seq) contract as tools/udp_egress.py UdpEgress."""

    def __init__(self, dest):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._dest = dest

    def send(self, wire, sizes, seq) -> int:
        w8 = wire.view(np.uint8) if wire.dtype != np.uint8 else wire
        sizes = np.asarray(sizes)
        n = 0
        for slot in np.flatnonzero(sizes > 0):
            self._sock.sendto(
                int(slot).to_bytes(2, "big") + int(seq).to_bytes(4, "big")
                + w8[slot, : sizes[slot]].tobytes(), self._dest)
            n += 1
        return n

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        self._sock.close()


def _make_tx(args, capacity: int, pump=None):
    """The downlink sender for --echo: native sendmmsg egress (zero
    per-packet Python — the send-side twin of --ingest=native) or the
    per-datagram Python loop.  --echo reply routes each slot's downlink
    back to its last uplink source (the real-MCU shape), sending from the
    pump's own socket so NAT'd callers receive it; the flag combination
    is validated at parse time in main()."""
    if args.echo is None:
        return None
    from_pump = args.echo == "reply"
    if from_pump or args.egress == "native":
        from lyra_tpu_torch.tools.udp_egress import (
            MultiEgress, ShardedReplyEgress, UdpEgress)

        if from_pump:
            if hasattr(pump, "num_shards"):  # ingest shard group
                return ShardedReplyEgress(pump)
            return UdpEgress.on_pump(pump, capacity)
        if args.egress_threads > 1:
            return MultiEgress(capacity, threads=args.egress_threads,
                               dest=args.echo)
        return UdpEgress(capacity, dest=args.echo)
    return _PySender(args.echo)


def _shard_devices(device, n_devices: int):
    """The devices of --devices N on `device`'s kind: the first N attached
    cards, refused when fewer are attached; on the CPU (the tests) the
    CPU N times."""
    if device.type != "cuda":
        return [device] * n_devices
    import torch

    attached = torch.cuda.device_count()
    if attached < n_devices:
        raise ValueError(
            f"--devices={n_devices} but only {attached} are attached")
    return [torch.device("cuda", i) for i in range(n_devices)]


def _maybe_shard(engine, n_devices: int):
    """Wrap the engine for stream-axis sharding over the first N devices
    (--devices).  ShardedEngine is a drop-in at every server seam, so the
    serving loop is unchanged; capacity divisibility is checked by the
    engine's init_state."""
    if n_devices <= 1:
        return engine
    from lyra_tpu_torch.parallel.sharding import ShardedEngine, make_mesh

    return ShardedEngine(engine, make_mesh(
        _shard_devices(engine.device, n_devices)))


def _parse_adaptive(spec: str):
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise argparse.ArgumentTypeError(
            f"--adaptive must be MIN:MAX[:WINDOW], got {spec!r}")
    mn, mx = int(parts[0]), int(parts[1])
    window = int(parts[2]) if len(parts) == 3 else 50
    return mn, mx, window


def _parse_echo(spec: str):
    if spec == "none":
        return None
    if spec == "reply":
        return "reply"
    host, _, port = spec.rpartition(":")
    if not host:
        raise argparse.ArgumentTypeError(
            f"--echo must be host:port, 'reply', or 'none', got {spec!r}")
    return host, int(port)


def _pace(next_tick: float) -> float:
    """Sleep until the grid point `next_tick` (the `serve.pace` span); →
    the next one.  A wake-up more than one period behind the grid counts
    one `serve.late_ticks`."""
    with trace.span("serve.pace"):
        while time.perf_counter() < next_tick:
            time.sleep(0.001)
    now = time.perf_counter()
    if now - next_tick > _PERIOD_S:
        trace.count("serve.late_ticks")
    return max(next_tick, now) + _PERIOD_S


def _trace_report() -> dict:
    """The tracer's record since the last report (it is drained): per
    span, the count and the p50 / p95 of its self ms; the counters."""
    spans, counts = trace.drain()
    self_ms: dict = {}
    for s, ns in zip(spans, trace.self_ns(spans)):
        self_ms.setdefault(s[0], []).append(ns * 1e-6)
    return {"spans": {name: {"n": len(v),
                             "p50_ms": float(np.percentile(v, 50)),
                             "p95_ms": float(np.percentile(v, 95))}
                      for name, v in sorted(self_ms.items())},
            "counts": dict(sorted(counts.items()))}


def _serve_encode(args, _on_ready, _stop) -> int:
    """The reverse relay: UDP PCM hops in, lyra packets out.

    Datagrams are 6 B header + one 20 ms hop of int16 samples (640 B at
    16 kHz).  A slot with no fresh PCM for a tick encodes silence and
    counts a pcm_gap — over a real transport, missing mic audio is a loss
    event, unlike the in-process dict tick which refuses it
    (stream_server.py EncoderServer.tick).  --ingest=native drains with
    the C++ PCM pump (udp_pump.cc PcmPump: recvmmsg batches, latest-hop-
    wins by sequence, stale drops + origin resync) — the per-datagram
    Python drain capped the JAX host's relay near ~800 real-time streams
    (its round-3 ingest numbers; not measured for the port), and only the
    pump carries the uplink source
    table that --echo reply routes downlink packets back through."""
    from lyra_tpu_torch.codec.engine import EncoderEngine
    from lyra_tpu_torch.tools.stream_server import EncoderServer

    enc = EncoderServer(
        args.capacity,
        engine=_maybe_shard(
            EncoderEngine(args.sample_rate_hz, model_path=args.model_path,
                          max_bitrate=args.max_bitrate,
                          enable_dtx=args.enable_dtx, device=args._device),
            args.devices),
        bitrate=args.bitrate)
    if args.restore:
        enc.restore(args.restore)  # resume another host's calls mid-stream
    else:
        enc.add_streams(range(args.capacity))
    hop_bytes = enc.hop_samples * 2

    pcm = rx = None
    if args.ingest == "native":
        if args.ingest_shards > 1:
            from lyra_tpu_torch.tools.udp_ingest import ShardedPcmIngest

            pcm = ShardedPcmIngest(args.capacity, hop_bytes,
                                   shards=args.ingest_shards,
                                   port=args.port)
        else:
            from lyra_tpu_torch.tools.udp_ingest import PcmIngest

            pcm = PcmIngest(args.capacity, hop_bytes, args.port)
        port = pcm.port
    else:
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
        rx.bind(("0.0.0.0", args.port))
        rx.setblocking(False)
        port = rx.getsockname()[1]
    tx = _make_tx(args, args.capacity, pcm)
    red_tx = _RedDownlink(args.red, args.capacity) if args.red else None
    sink = _StatsSink(args.stats)
    ctl = (_Control(args.control, args.control_bind, key=args._control_key)
           if args.control is not None else None)

    def _snapshot(tail):
        p50, p95 = _tick_pcts(tick_ms, tail)
        if pcm is not None:
            ingest_stats = pcm.stats()
        else:
            ingest_stats = {"datagrams": datagrams, "malformed": malformed}
        return {"mode": "encode", "ts": round(time.time(), 3),
                "ticks": ticks, "tick_ms_p50": p50, "tick_ms_p95": p95,
                "budget_ms": 20.0, "capacity": args.capacity,
                "occupied": int(fresh.sum()), "active": enc.num_active,
                "pcm_gaps": pcm_gaps,
                "ingest": ingest_stats,
                "egress": (tx.stats() if tx is not None else {}),
                **({"auth_rejects": ctl.auth_rejects}
                   if ctl is not None and ctl._verifier else {}),
                **({"trace": trace_stats} if args.trace else {})}

    print(f"encoding {args.capacity} streams on UDP :{port} "
          f"(bitrate={args.bitrate}, ingest={args.ingest}, "
          f"echo={args.echo or 'none'}"
          + (f", control=:{ctl.port}" if ctl is not None else "") + ")",
          flush=True)
    if _on_ready is not None:
        _on_ready(port)

    audio = np.zeros((args.capacity, enc.hop_samples), np.int16)
    fresh = np.zeros(args.capacity, bool)
    datagrams = malformed = pcm_gaps = 0
    tick_ms = []
    trace_stats: dict = {}
    ticks = 0
    t_end = (time.perf_counter() + args.seconds) if args.seconds else None
    next_tick = time.perf_counter()
    next_report = next_tick + args.report_every
    next_snap = (next_tick + args.snapshot_every
                 if args.snapshot else None)
    try:
        while ((t_end is None or time.perf_counter() < t_end)
               and not (_stop is not None and _stop.is_set())):
            next_tick = _pace(next_tick)
            if ctl is not None and ctl.poll(enc, lambda: _snapshot(256)):
                break  # drained or told to quit
            if (next_snap is not None
                    and time.perf_counter() >= next_snap):
                # Reschedule from NOW, not the missed grid point: after a
                # stall (first-tick compile, slow disk) a grid-based
                # scheduler would emit a catch-up burst of back-to-back
                # snapshots, each skipping a downlink hop; a staleness-
                # bounded snapshot only ever needs the newest state.
                next_snap = time.perf_counter() + args.snapshot_every
                enc.flush_async()  # one hop skips; PLC covers
                enc.save(args.snapshot)
            t0 = time.perf_counter()

            with trace.span("serve.collect"):
                if pcm is not None:
                    fresh = pcm.collect_into(audio)
                else:
                    fresh[:] = False
                    while True:
                        try:
                            dgram, _ = rx.recvfrom(4096)
                        except BlockingIOError:
                            break
                        slot = int.from_bytes(dgram[:2], "big")
                        if (len(dgram) != _HDR + hop_bytes
                                or slot >= args.capacity):
                            malformed += 1  # counted event, never fatal
                            continue
                        audio[slot] = np.frombuffer(dgram[_HDR:], np.int16)
                        fresh[slot] = True
                        datagrams += 1

                audio[~fresh] = 0  # lost mic hops encode as silence
                pcm_gaps += int(args.capacity - fresh.sum())
            with trace.span("serve.tick"):
                out = enc.tick_wire_async(audio)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if out is None:
                continue  # pipeline priming
            wire, sizes = out
            if tx is not None:
                with trace.span("serve.send"):
                    if args.echo == "reply":
                        tx.route_from_pump(pcm)
                    if red_tx is not None:
                        wire, sizes = red_tx.frame(wire, sizes)
                    tx.send(wire, sizes, ticks)
            ticks += 1

            if time.perf_counter() >= next_report:
                next_report += args.report_every
                if args.trace:
                    trace_stats = _trace_report()
                snap = _snapshot(256)
                sink.emit(snap)
                print(f"ticks={ticks} tick_ms p50={snap['tick_ms_p50']:.1f} "
                      f"p95={snap['tick_ms_p95']:.1f} (budget 20.0) "
                      f"ingest={snap['ingest']} pcm_gaps={pcm_gaps}",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        enc.flush_wire_async()
        if args.trace:
            trace_stats = _trace_report()
        snap = {**_snapshot(None), "final": True}
        sink.emit(snap)
        sink.close()
        if ctl is not None:
            ctl.close()
        if tx is not None:
            tx.close()  # before the pump: reply egress borrows its fd
        if pcm is not None:
            pcm.close()
        if rx is not None:
            rx.close()
    print(f"encoded {ticks} ticks; tick_ms p50={snap['tick_ms_p50']:.1f} "
          f"p95={snap['tick_ms_p95']:.1f}", flush=True)
    return 0


def _serve_bridge(args, _on_ready, _stop) -> int:
    """Runnable UDP conference bridge: uplink lyra packets in, per-
    participant downlink lyra packets out (tools/conference.py — decode,
    per-room mix-minus-one, re-encode, PCM device-resident throughout).

    Slots are partitioned into consecutive rooms of --room_size at
    startup (slot // room_size is the room).  Downlink packets go to
    --echo with the same 6 B header; a production deployment would route
    each slot to its participant's transport address instead.  The loop
    uses the pipelined tick (one 20 ms tick of added latency; device
    compute, D2H, and host packet IO overlap — see
    ConferenceBridge.tick_wire_async)."""
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.tools.conference import ConferenceBridge

    if args.devices > 1:
        # Consecutive rooms stay shard-local iff rooms tile the per-shard
        # seat count; refuse up front rather than at the first tick
        # (ConferenceBridge._check_rooms_shard_local), since here the wire
        # header's slot field is the stream identity and re-placing rooms
        # would break it.
        per = args.capacity // args.devices
        if args.capacity % args.devices or per % args.room_size:
            raise ValueError(
                f"--capacity={args.capacity} in rooms of {args.room_size} "
                f"does not tile {args.devices} shards of {per} seats; pick "
                "capacity = devices * k * room_size")
    # Engines are built here (not left to the bridge's defaults) so
    # --max_bitrate caps the captured programs identically at every
    # --devices count.
    dec_e = _maybe_shard(
        DecoderEngine(model_path=args.model_path,
                      max_bitrate=args.max_bitrate,
                      emit_dtype="int16", device=args._device), args.devices)
    enc_e = _maybe_shard(
        EncoderEngine(model_path=args.model_path,
                      max_bitrate=args.max_bitrate, device=args._device),
        args.devices)
    bridge = ConferenceBridge(args.capacity, model_path=args.model_path,
                              bitrate=args.bitrate,
                              dec_engine=dec_e, enc_engine=enc_e)
    restored_transport = None
    if args.restore:
        # Resume another host's rooms mid-call.
        restored_transport = bridge.restore(args.restore)
    else:
        bridge.add_participants(
            {slot: slot // args.room_size for slot in range(args.capacity)})

    ad_max = args.adaptive[1] if args.adaptive else 0
    depth = max(args.playout_delay, ad_max) + 6
    jb = pump = rx = None
    if args.ingest == "native":
        if args.ingest_shards > 1:
            from lyra_tpu_torch.tools.udp_ingest import ShardedUdpIngest

            pump = ShardedUdpIngest(args.capacity, config.packet_size(184),
                                    depth=depth, shards=args.ingest_shards,
                                    port=args.port)
        else:
            from lyra_tpu_torch.tools.udp_ingest import UdpIngest

            jb = JitterBuffer(args.capacity, config.packet_size(184),
                              depth=depth)
            pump = UdpIngest(jb, args.port)
        port = pump.port
    else:
        jb = JitterBuffer(args.capacity, config.packet_size(184),
                          depth=depth)
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
        rx.bind(("0.0.0.0", args.port))
        rx.setblocking(False)
        port = rx.getsockname()[1]
    ingest = pump or jb
    for slot in range(args.capacity):
        ingest.add_stream(slot, playout_delay=args.playout_delay)
    if args.adaptive:
        # Before the reseed: carrying learned delays needs adaptive mode
        # configured on the buffer (adapt_seed refuses otherwise).
        ingest.set_adaptive(*args.adaptive)
    _reseed_transport(ingest, restored_transport, args.capacity,
                      args.playout_delay, adaptive=args.adaptive is not None)
    if args.red and pump is not None:
        pump.set_red(args.red)  # python-jb path parses in the drain loop
    tx = _make_tx(args, args.capacity, pump)
    red_tx = _RedDownlink(args.red, args.capacity) if args.red else None
    sink = _StatsSink(args.stats)
    ctl = (_Control(args.control, args.control_bind, key=args._control_key)
           if args.control is not None else None)

    def _snapshot(tail):
        p50, p95 = _tick_pcts(tick_ms, tail)
        return {"mode": "bridge", "ts": round(time.time(), 3),
                "ticks": ticks, "tick_ms_p50": p50, "tick_ms_p95": p95,
                "budget_ms": 20.0, "capacity": args.capacity,
                "occupied": occupied, "active": bridge.num_active,
                "room_size": args.room_size,
                "ingest": (pump.stats() if pump is not None else {}),
                "jb": (pump.jb_stats() if pump is not None else jb.stats()),
                **({"adapt": (pump or jb).adapt_stats()}
                   if args.adaptive else {}),
                **({"red_heals": (pump or jb).red_heals}
                   if args.red else {}),
                "egress": (tx.stats() if tx is not None else {}),
                **({"auth_rejects": ctl.auth_rejects}
                   if ctl is not None and ctl._verifier else {}),
                "bad_packets": int(bridge.bad_packets.sum()),
                **({"trace": trace_stats} if args.trace else {})}

    print(f"bridging {args.capacity} participants in rooms of "
          f"{args.room_size} on UDP :{port} (ingest={args.ingest}, "
          f"echo={args.echo or 'none'}"
          + (f", control=:{ctl.port}" if ctl is not None else "") + ")",
          flush=True)
    if _on_ready is not None:
        _on_ready(port)

    tick_ms = []
    trace_stats: dict = {}
    ticks = 0
    occupied = 0
    t_end = (time.perf_counter() + args.seconds) if args.seconds else None
    next_tick = time.perf_counter()
    next_report = next_tick + args.report_every
    next_snap = (next_tick + args.snapshot_every
                 if args.snapshot else None)
    try:
        while ((t_end is None or time.perf_counter() < t_end)
               and not (_stop is not None and _stop.is_set())):
            next_tick = _pace(next_tick)
            if ctl is not None and ctl.poll(
                    bridge, lambda: _snapshot(256),
                    transport_save=lambda: _transport_state(
                        ingest, adaptive=args.adaptive is not None),
                    transport_restore=lambda tr: _reseed_transport(
                        ingest, tr, args.capacity, args.playout_delay,
                        adaptive=args.adaptive is not None)):
                break  # drained or told to quit
            if (next_snap is not None
                    and time.perf_counter() >= next_snap):
                # Reschedule from NOW, not the missed grid point: after a
                # stall (first-tick compile, slow disk) a grid-based
                # scheduler would emit a catch-up burst of back-to-back
                # snapshots, each skipping a downlink hop; a staleness-
                # bounded snapshot only ever needs the newest state.
                next_snap = time.perf_counter() + args.snapshot_every
                bridge.flush_async()  # one hop skips; PLC covers
                bridge.save(args.snapshot, _transport_state(
                    ingest, adaptive=args.adaptive is not None))
            t0 = time.perf_counter()

            with trace.span("serve.collect"):
                if pump is None:
                    _drain_python_rx(rx, jb, args.red)
                    pkts, received, sizes = jb.collect()
                else:
                    pkts, received, sizes = pump.collect()
                occupied = int(received.sum())

            with trace.span("serve.tick"):
                out = bridge.tick_wire_async(pkts, received,
                                             sizes.astype(np.int32))
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if out is None:
                continue  # pipeline priming
            wire, out_sizes = out
            if tx is not None:
                with trace.span("serve.send"):
                    if args.echo == "reply":
                        tx.route_from_pump(pump)
                    if red_tx is not None:
                        wire, out_sizes = red_tx.frame(wire, out_sizes)
                    tx.send(wire, out_sizes, ticks)
            ticks += 1

            if time.perf_counter() >= next_report:
                next_report += args.report_every
                if args.trace:
                    trace_stats = _trace_report()
                snap = _snapshot(256)
                sink.emit(snap)
                print(f"ticks={ticks} tick_ms p50={snap['tick_ms_p50']:.1f} "
                      f"p95={snap['tick_ms_p95']:.1f} (budget 20.0) "
                      f"jb={snap['jb']} "
                      f"bad_packets={snap['bad_packets']}",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        bridge.flush_async()
        if args.trace:
            trace_stats = _trace_report()
        snap = {**_snapshot(None), "final": True}
        sink.emit(snap)
        sink.close()
        if ctl is not None:
            ctl.close()
        if tx is not None:
            tx.close()  # before the pump: reply egress borrows its fd
        if pump is not None:
            pump.close()
        if rx is not None:
            rx.close()
    print(f"bridged {ticks} ticks; tick_ms p50={snap['tick_ms_p50']:.1f} "
          f"p95={snap['tick_ms_p95']:.1f}", flush=True)
    return 0


def main(argv=None, _on_ready=None, _stop=None, *, device=None) -> int:
    """_on_ready(port) and _stop (a threading.Event ending the serve loop)
    exist so tests can drive an in-process server; the CLI never sets
    them.  `device` is where the engines run: the card by default
    (utils/device.py), "cpu" for the tests.

    Driven from a thread, the first ticks capture CUDA graphs there, and a
    capture fails if another thread of the process uses the card
    meanwhile: a caller makes its traffic before it starts the server and
    sends it with host code only."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=0,
                   help="UDP port to serve (0 = ephemeral).")
    p.add_argument("--capacity", type=int, default=1024,
                   help="Stream slots (fixed batch; admission is free).")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="How long to serve; 0 = until interrupted.")
    p.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH)
    p.add_argument("--max_bitrate", type=int, default=9200,
                   help="Engine stage cap; packets above it are counted "
                        "drops (3200 compiles the smallest program).")
    p.add_argument("--playout_delay", type=int, default=2,
                   help="Jitter-buffer delay in 20 ms ticks.")
    p.add_argument("--adaptive", type=_parse_adaptive, default=None,
                   metavar="MIN:MAX[:WINDOW]",
                   help="Adaptive jitter-buffer playout delay within "
                        "[MIN, MAX] ticks, deciding every WINDOW ticks "
                        "(default 50): grows on observed lateness, gives "
                        "back sustained excess cushion.  --playout_delay is "
                        "each stream's starting point.  decode/bridge "
                        "modes only (the encode relay's PCM pump is "
                        "latest-wins, no playout queue).")
    p.add_argument("--sample_rate_hz", type=int, default=16000,
                   choices=(8000, 16000, 32000, 48000),
                   help="External PCM rate (decode: emitted hops; encode: "
                        "inbound hops — datagram size follows).  The "
                        "engine resamples to the 16 kHz internal rate on "
                        "device (reference: lyra/lyra_config.h:56-57).  "
                        "Bridge I/O is packets both ways, so only 16000 "
                        "is meaningful there.")
    p.add_argument("--ingest", choices=("native", "python"),
                   default="native",
                   help="native: C++ recvmmsg pump; "
                        "python: per-datagram drain (no native lib needed).")
    p.add_argument("--egress", choices=("native", "python"),
                   default="native",
                   help="native: C++ sendmmsg fan-out of the downlink "
                        "matrix (zero per-packet Python); python: "
                        "per-datagram sendto loop (no native lib needed).")
    p.add_argument("--ingest_shards", type=int, default=1, metavar="N",
                   help="SO_REUSEPORT ingest shard group: N receiver "
                        "threads/sockets on one port, kernel-hashed per "
                        "flow, each riding its own core.  Requires "
                        "--ingest native.")
    p.add_argument("--egress_threads", type=int, default=1, metavar="N",
                   help="Striped multi-core egress for a fixed --echo "
                        "host:port destination (N sockets/send threads, "
                        "disjoint row stripes).  Requires --egress "
                        "native; --echo reply already sends one thread "
                        "per ingest shard.")
    p.add_argument("--echo", type=_parse_echo, default=None,
                   metavar="HOST:PORT|reply|none",
                   help="Where downlink datagrams go (same 6 B header). "
                        "'reply' routes each slot back to its last uplink "
                        "source — the real-MCU shape (any mode, native "
                        "ingest+egress).  Default: none (stats only).")
    p.add_argument("--red", type=int, default=0, metavar="D",
                   help="RED packet redundancy distance: every packet "
                        "datagram for sequence t also carries packet t-D "
                        "([1B len][cur][1B len][prev] framing), so one "
                        "lost datagram is healed by its successor instead "
                        "of concealed — at the cost of ~2x packet payload. "
                        "A wire contract for the whole port: every sender "
                        "must frame the same way (packet.build_red; "
                        "examples/udp_call.py --red).  decode/bridge: "
                        "uplink ingest parses RED (needs --playout_delay "
                        ">= D+1 so the copy arrives before its sequence "
                        "is due); encode/bridge: downlink datagrams are "
                        "RED-framed.  0 = plain framing.")
    p.add_argument("--report_every", type=float, default=1.0)
    p.add_argument("--control", type=int, default=None, metavar="PORT",
                   help="Bind a UDP JSON control endpoint (0 = ephemeral, "
                        "port printed in the startup line): ping / stats / "
                        "save / restore / drain / quit — the fleet "
                        "management plane (tools/fleet.py is the client).")
    p.add_argument("--control_bind", default="127.0.0.1", metavar="ADDR",
                   help="Bind address for --control (default loopback, "
                        "keyless).  A routable bind REQUIRES --control_key "
                        "— the endpoint can stop serving or swap engine "
                        "state, so starting routable without a key is "
                        "refused (DEPLOYMENT.md, Trust boundary).")
    p.add_argument("--control_key", default=None, metavar="FILE",
                   help="Shared HMAC key file for --control (>= 16 bytes; "
                        "e.g. head -c 32 /dev/urandom > key).  Every "
                        "command must then carry a valid mac + fresh "
                        "ts/nonce (tools/control_auth.py); tampered, "
                        "stale, or spliced datagrams are counted "
                        "auth_rejects.  Required when --control_bind is "
                        "routable; the fleet controller signs with the "
                        "same file (fleet_main --key).")
    p.add_argument("--restore", default=None, metavar="PATH",
                   help="Resume from a drained host's snapshot (server "
                        "state + slot table; see --control drain) instead "
                        "of admitting fresh streams.  Capacity, mode, and "
                        "sample rate must match the snapshot.")
    p.add_argument("--snapshot", default=None, metavar="PATH",
                   help="Write a crash-failover snapshot (atomic tmp+"
                        "rename) every --snapshot_every seconds.  A dead "
                        "host's calls resume from its last snapshot on a "
                        "standby (fleet.py FleetRouter.failover); each "
                        "snapshot skips one downlink hop (async flush), "
                        "which PLC conceals.")
    p.add_argument("--snapshot_every", type=float, default=10.0,
                   help="Seconds between --snapshot writes.")
    p.add_argument("--stats", default=None, metavar="PATH",
                   help="Append one JSON line of operator stats per "
                        "--report_every interval (tick-ms percentiles, "
                        "occupancy, drop counters by cause, pump/jitter/"
                        "egress counters) plus a final record "
                        "('final': true) at shutdown.")
    p.add_argument("--mode", choices=("decode", "encode", "bridge"),
                   default="decode",
                   help="decode: lyra packets in, PCM out.  encode: the "
                        "reverse relay — PCM hops in (6 B header + int16 "
                        "samples), lyra packets out to --echo.  bridge: "
                        "conference MCU — uplink packets in, per-"
                        "participant mixed downlink packets out to --echo.")
    p.add_argument("--bitrate", type=int, default=3200,
                   help="encode/bridge modes: downlink wire bitrate.")
    p.add_argument("--enable_dtx", action="store_true",
                   help="encode mode: discontinuous transmission — noise "
                        "hops emit NO datagram (the engine's device-side "
                        "noise estimator decides; reference: "
                        "lyra/lyra_encoder.cc:113-136), so silent callers "
                        "cost zero downlink bandwidth and the far decoder "
                        "fills with comfort noise.")
    p.add_argument("--room_size", type=int, default=4,
                   help="bridge mode: participants per room (slots are "
                        "partitioned consecutively).")
    p.add_argument("--trace", action="store_true",
                   help="Turn the tracer on (utils/trace.py): each stats "
                        "record gains a \"trace\" dict, per span the "
                        "p50/p95 self ms over the report interval "
                        "(serve.collect, serve.tick, serve.send, "
                        "serve.pace and the servers' own), and the "
                        "counters (serve.late_ticks: wake-ups more than "
                        "one 20 ms period behind the grid).")
    p.add_argument("--devices", type=int, default=1,
                   help="Shard the stream batch over the first N attached "
                        "cards (stream-axis mesh, no cross-card traffic "
                        "in the frame path; bridge rooms must tile the "
                        "per-shard seats).  1 = one card.")
    args = p.parse_args(argv)

    # Trust boundary, enforced at startup (before any socket binds):
    # loopback control stays keyless; routable control requires the key.
    args._control_key = None
    if args.control is not None:
        from lyra_tpu_torch.tools.control_auth import (
            load_key, require_key_for_routable)

        require_key_for_routable(args.control_bind, args.control_key,
                                 "serve_main --control")
        if (args.control_key is not None
                and args.control_bind in ("0.0.0.0", "::", "")):
            p.error("--control_key with a wildcard --control_bind: a "
                    "keyed endpoint must know its own identity (the "
                    "audience clients sign for) — bind the specific "
                    "interface address")
        if args.control_key is not None:
            args._control_key = load_key(args.control_key)
    elif args.control_key is not None:
        p.error("--control_key without --control keys nothing; bind the "
                "control endpoint too")

    if args.echo == "reply":
        # Refused before any model/engine construction: the reply route
        # table lives in the native pump (packet pump for decode/bridge,
        # PCM pump for the encode relay) and the downlink must leave from
        # its socket.
        if args.ingest != "native" or args.egress != "native":
            p.error("--echo reply needs --ingest native and --egress "
                    "native (the uplink source table lives in the native "
                    "pump, and downlink must leave from its socket)")
    if args.ingest_shards < 1:
        p.error("--ingest_shards must be >= 1")
    if args.ingest_shards > 1 and args.ingest != "native":
        p.error("--ingest_shards needs --ingest native (the shard group "
                "is N C++ receiver threads on one SO_REUSEPORT port)")
    if args.egress_threads < 1:
        p.error("--egress_threads must be >= 1")
    if args.egress_threads > 1:
        if args.egress != "native":
            p.error("--egress_threads needs --egress native")
        if args.echo == "reply":
            p.error("--egress_threads does not apply to --echo reply "
                    "(reply egress already runs one send thread per "
                    "ingest shard)")
        if args.echo is None:
            p.error("--egress_threads without --echo sends nothing; give "
                    "a destination")
    if args.mode == "bridge" and args.sample_rate_hz != 16000:
        p.error("--sample_rate_hz applies to PCM endpoints; bridge mode "
                "is packets in, packets out (decode/mix/encode run at the "
                "16 kHz internal rate)")
    if args.snapshot is not None and args.snapshot_every <= 0:
        p.error("--snapshot_every must be positive")
    if args.enable_dtx and args.mode != "encode":
        p.error("--enable_dtx applies to the encode relay (decode/bridge "
                "consume packets; DTX is the sender's decision)")
    if args.adaptive is not None:
        mn, mx, window = args.adaptive
        if not (0 <= mn <= mx) or window <= 0:
            p.error("--adaptive needs 0 <= MIN <= MAX and WINDOW > 0")
        if args.mode == "encode":
            p.error("--adaptive applies to the packet jitter buffer; the "
                    "encode relay's PCM pump is latest-wins (no playout "
                    "queue to adapt)")
    if args.red:
        if not 1 <= args.red <= 8:
            p.error("--red must be in 1..8 (ticks of redundancy distance)")
        if args.mode in ("decode", "bridge"):
            if args.playout_delay < args.red + 1:
                p.error(f"--red {args.red} needs --playout_delay >= "
                        f"{args.red + 1}: the redundant copy rides the "
                        "datagram D ticks later and must arrive before "
                        "its sequence is due")
            if args.adaptive is not None and args.adaptive[0] < args.red + 1:
                p.error(f"--red {args.red} needs adaptive MIN >= "
                        f"{args.red + 1} (a shrink below it would play "
                        "sequences before their redundant copy can land)")
    args._device = resolve(device)
    if args.devices > 1:  # refused before any engine is built
        _shard_devices(args._device, args.devices)
    if args.trace:
        trace.enable()
    try:
        serve = {"encode": _serve_encode, "bridge": _serve_bridge,
                 "decode": _serve_decode}[args.mode]
        return serve(args, _on_ready, _stop)
    finally:
        if args.trace:
            trace.disable()
            trace.drain()


def _serve_decode(args, _on_ready, _stop) -> int:
    """The decode server: lyra packets in, int16 PCM out (the module
    docstring)."""
    from lyra_tpu_torch.codec.engine import DecoderEngine

    dec = DecoderServer(args.capacity, engine=_maybe_shard(
        DecoderEngine(args.sample_rate_hz, model_path=args.model_path,
                      emit_dtype="int16",
                      max_bitrate=args.max_bitrate, device=args._device),
        args.devices))
    ad_max = args.adaptive[1] if args.adaptive else 0
    depth = max(args.playout_delay, ad_max) + 6
    jb = pump = rx = None
    if args.ingest == "native":
        if args.ingest_shards > 1:
            from lyra_tpu_torch.tools.udp_ingest import ShardedUdpIngest

            pump = ShardedUdpIngest(args.capacity, config.packet_size(184),
                                    depth=depth, shards=args.ingest_shards,
                                    port=args.port)
        else:
            from lyra_tpu_torch.tools.udp_ingest import UdpIngest

            jb = JitterBuffer(args.capacity, config.packet_size(184),
                              depth=depth)
            pump = UdpIngest(jb, args.port)
        port = pump.port
    else:
        jb = JitterBuffer(args.capacity, config.packet_size(184),
                          depth=depth)
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
        rx.bind(("0.0.0.0", args.port))
        rx.setblocking(False)
        port = rx.getsockname()[1]
    ingest = pump or jb
    restored_transport = None
    if args.restore:
        # Resume another host's calls mid-stream.
        restored_transport = dec.restore(args.restore)
    else:
        dec.add_streams(range(args.capacity))
    for slot in range(args.capacity):
        ingest.add_stream(slot, playout_delay=args.playout_delay)
    if args.adaptive:
        # Before the reseed: carrying learned delays needs adaptive mode
        # configured on the buffer (adapt_seed refuses otherwise).
        ingest.set_adaptive(*args.adaptive)
    # After admission: re-seeding overwrites the fresh schedule with the
    # snapshot's per-slot sequence positions (and, on adaptive hosts,
    # learned delays), so callers lock on at once.
    _reseed_transport(ingest, restored_transport, args.capacity,
                      args.playout_delay, adaptive=args.adaptive is not None)

    if args.red and pump is not None:
        pump.set_red(args.red)  # python-jb path parses in the drain loop

    tx = _make_tx(args, args.capacity, pump)
    pcm_sizes = np.full(args.capacity, dec.hop_samples * 2, np.int32)
    sink = _StatsSink(args.stats)
    ctl = (_Control(args.control, args.control_bind, key=args._control_key)
           if args.control is not None else None)

    def _snapshot(tail):
        p50, p95 = _tick_pcts(tick_ms, tail)
        return {"mode": "decode", "ts": round(time.time(), 3),
                "ticks": ticks, "tick_ms_p50": p50, "tick_ms_p95": p95,
                "budget_ms": 20.0, "capacity": args.capacity,
                "occupied": occupied, "active": dec.num_active,
                "ingest": (pump.stats() if pump is not None else {}),
                "jb": (pump.jb_stats() if pump is not None else jb.stats()),
                **({"adapt": (pump or jb).adapt_stats()}
                   if args.adaptive else {}),
                **({"red_heals": (pump or jb).red_heals}
                   if args.red else {}),
                "egress": (tx.stats() if tx is not None else {}),
                **({"auth_rejects": ctl.auth_rejects}
                   if ctl is not None and ctl._verifier else {}),
                "bad_packets": int(dec.bad_packets.sum()),
                **({"trace": trace_stats} if args.trace else {})}

    print(f"serving {args.capacity} streams on UDP :{port} "
          f"(ingest={args.ingest}, echo={args.echo or 'none'}"
          + (f", control=:{ctl.port}" if ctl is not None else "") + ")",
          flush=True)
    if _on_ready is not None:  # test hook: report the bound port
        _on_ready(port)

    tick_ms = []
    trace_stats: dict = {}
    ticks = 0
    occupied = 0
    t_end = (time.perf_counter() + args.seconds) if args.seconds else None
    next_tick = time.perf_counter()
    next_report = next_tick + args.report_every
    next_snap = (next_tick + args.snapshot_every
                 if args.snapshot else None)
    try:
        while ((t_end is None or time.perf_counter() < t_end)
               and not (_stop is not None and _stop.is_set())):
            next_tick = _pace(next_tick)
            if ctl is not None and ctl.poll(
                    dec, lambda: _snapshot(256),
                    transport_save=lambda: _transport_state(
                        ingest, adaptive=args.adaptive is not None),
                    transport_restore=lambda tr: _reseed_transport(
                        ingest, tr, args.capacity, args.playout_delay,
                        adaptive=args.adaptive is not None)):
                break  # drained or told to quit
            if (next_snap is not None
                    and time.perf_counter() >= next_snap):
                # Reschedule from NOW, not the missed grid point: after a
                # stall (first-tick compile, slow disk) a grid-based
                # scheduler would emit a catch-up burst of back-to-back
                # snapshots, each skipping a downlink hop; a staleness-
                # bounded snapshot only ever needs the newest state.
                next_snap = time.perf_counter() + args.snapshot_every
                dec.flush_async()  # one hop skips; PLC covers
                dec.save(args.snapshot, _transport_state(
                    ingest, adaptive=args.adaptive is not None))
            t0 = time.perf_counter()

            with trace.span("serve.collect"):
                if pump is None:
                    _drain_python_rx(rx, jb, args.red)
                    pkts, received, sizes = jb.collect()
                else:
                    pkts, received, sizes = pump.collect()
                occupied = int(received.sum())

            with trace.span("serve.tick"):
                out = dec.tick_wire_async(pkts, received,
                                          sizes.astype(np.int32))
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if out is None:
                continue  # pipeline priming
            if tx is not None:
                # Every slot ships its hop (PLC/CNG fills inactive gaps);
                # int16 PCM rows reinterpret as bytes on the wire.
                with trace.span("serve.send"):
                    if args.echo == "reply":
                        tx.route_from_pump(pump)
                    tx.send(np.ascontiguousarray(out), pcm_sizes, ticks)
            ticks += 1

            if time.perf_counter() >= next_report:
                next_report += args.report_every
                if args.trace:
                    trace_stats = _trace_report()
                snap = _snapshot(256)
                sink.emit(snap)
                print(f"ticks={ticks} tick_ms p50={snap['tick_ms_p50']:.1f} "
                      f"p95={snap['tick_ms_p95']:.1f} "
                      f"(budget 20.0) ingest={snap['ingest']} "
                      f"jb={snap['jb']} bad_packets={snap['bad_packets']}",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        dec.flush_async()
        if args.trace:
            trace_stats = _trace_report()
        snap = {**_snapshot(None), "final": True}
        sink.emit(snap)
        sink.close()
        if ctl is not None:
            ctl.close()
        if tx is not None:
            tx.close()  # before the pump: reply egress borrows its fd
        if pump is not None:
            pump.close()
        if rx is not None:
            rx.close()
    print(f"served {ticks} ticks; tick_ms p50={snap['tick_ms_p50']:.1f} "
          f"p95={snap['tick_ms_p95']:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
