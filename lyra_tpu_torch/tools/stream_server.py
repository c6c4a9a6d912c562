"""Multi-stream serving runtime over the batched lockstep engines — the
port of lyra_tpu/tools/stream_server.py (DecoderServer, EncoderServer).

Per 20 ms tick a server collects each live stream's packet bytes (or None
on loss), runs the decoder step for all slots at once and hands each
stream its hop of int16 audio; symmetrically for the encode direction.
Admission and eviction mask rows of the engine state back to their
initial values (`reset_rows`), so adding or dropping a call never
re-captures or reshapes the device program: the batch is a fixed-capacity
slot table.

Device programs.  Each tick is one program of the engine, run through
`engine._run` in the server's own graph cache (`engine.own_graphs()`, so
servers sharing an engine never write each other's state): on the card one
CUDA-graph replay (utils/capture.py), the counterpart of the JAX servers'
jitted programs, keyed as they are —
  * DecoderServer.tick / tick_packed: the step + the int16 cast;
  * DecoderServer.tick_wire: unpack on device + the step + the int16 cast,
    per packet bitrate (uniform) or per row width (mixed sizes);
  * EncoderServer.tick / tick_packed: the step (host packs the indices);
  * EncoderServer.tick_wire: the step + `pack_wire_device_mixed`, per the
    fleet's widest bitrate, per-row stage counts as a device input.
Where the engine's `graphs` is None (the CPU, or an eager engine on the
card) the same programs run eagerly, bit for bit the same.

Host side (`_HostIO`).  On the card, tick t stages its host inputs in
pinned buffers of slot t % 2 (so the caller may reuse its arrays at once:
the private copy `_pcm_in` promises), and the program's outputs are copied
into pinned buffers of the same slot right after the replay, on the same
stream, before the next replay can overwrite them; an event marks them
done.  A synchronous tick waits for the event at once; the async ticks
(`tick_*_async`) return the previous tick's outputs after waiting for its
event, so device compute, the copies and host work overlap.  Over a
ShardedEngine (parallel/sharding.py) every seam takes the sharded tree
and outputs: each shard's outputs are copied into its row block of one
pinned buffer, with an event per shard, and a snapshot holds the
unsharded layout.  The
generation counters make a slot that changed hands between submit and
drain drain silence.  The host batch codecs (lyra_tpu_torch/packet.py)
run through the native library when it builds, as the JAX servers' do;
each server builds it in its constructor, not mid-tick.

Tracing (utils/trace.py, off by default).  Each server's submit counter
is its tick id.  `enc.tick` / `dec.tick` span each public tick or flush
call (a flush carries the id of the tick it drains); inside it
`*.stage` spans the host inputs' preparation and pinned staging
(`_pcm_in`, `_HostIO.stage`), `dec.unpack` the decoder's host unpack and
masks (`_unpack_wire`, `_sizes_to_nq`, `_active_mask`), `graph.replay`
the program's launch (utils/capture.py), `*.fetch` the outputs' copies to
the host and their event, `host.wait` every wait on an event (time the
host waits on the card, not host work), and `*.drain` the outputs' copy
out of pinned memory and the masking after it, under the id of the tick
it drains.  Counters: `dec.rows_concealed` (active rows not received and
not in comfort noise), `dec.rows_comfort_noise` (active rows drained in
comfort noise; every such row was not received, so the two add without
overlap) and `enc.rows_dtx` (active rows drained as DTX noise hops); the
decoder's program counts `dec.rows_run` itself (codec/engine.py).

`ServerPool` serves one fleet as waves of equal-capacity servers (the
JAX package's wave schedule), each wave with its own graph cache.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.parallel.sharding import (
    Sharded,
    shard_batch_tree,
    unshard_batch_tree,
)
from lyra_tpu_torch.utils import checkpoint, native, trace
from lyra_tpu_torch.utils.state import state_from_numpy


@dataclasses.dataclass
class _Slot:
    stream_id: object
    active: bool = False


class _SpanNames(NamedTuple):
    """The tracer's span names of one server kind."""
    tick: str
    stage: str
    fetch: str
    drain: str


_ENC = _SpanNames("enc.tick", "enc.stage", "enc.fetch", "enc.drain")
_DEC = _SpanNames("dec.tick", "dec.stage", "dec.fetch", "dec.drain")


class _Fetch(NamedTuple):
    """A tick's outputs on their way to the host."""
    events: List[torch.cuda.Event]  # one per card; none on the CPU
    host: list  # pinned buffers (the card) or the outputs (the CPU)
    tick: int  # the server's id of the tick


def _pcm_in(audio):
    """Host PCM → the engine-upload array: int16 stays int16 (2 B/sample
    over PCIe; the engine casts on device), anything else is float32 (the
    float contract: non-integral int16-scale values are legal).  The
    private copy the async ticks need is made when the tick stages it
    (`_HostIO.stage`).  Device tensors (sharded or not) pass through."""
    if isinstance(audio, Sharded) or (isinstance(audio, torch.Tensor)
                                      and audio.device.type != "cpu"):
        return audio
    a = np.asarray(audio)
    return a if a.dtype == np.int16 else a.astype(np.float32)


class _HostIO:
    """Pinned staging of one server's tick inputs and outputs (see the
    module docstring); on the CPU, private copies and nothing else."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._events: List[List[torch.cuda.Event]] = [[], []]
        self._ticks = 0

    @property
    def next_tick(self) -> int:
        """The id the next submitted tick takes."""
        return self._ticks

    def _buf(self, key, shape, dtype) -> torch.Tensor:
        key = (key, tuple(shape), dtype)
        if key not in self._bufs:
            self._bufs[key] = torch.empty(tuple(shape), dtype=dtype,
                                          pin_memory=True)
        return self._bufs[key]

    def begin(self) -> int:
        """The slot of a new tick, once the tick that used it last is
        done."""
        k = self._ticks % 2
        self._ticks += 1
        if self._events[k]:
            with trace.span("host.wait"):
                for ev in self._events[k]:
                    ev.synchronize()
        self._events[k] = []
        return k

    def stage(self, k: int, i: int, a):
        """Host input i of slot k's tick as a tensor the program copies."""
        if isinstance(a, Sharded):
            return a
        if isinstance(a, torch.Tensor):
            if a.device.type != "cpu":
                return a
            a = a.numpy()
        a = np.asarray(a)
        if not self._cuda:
            return torch.from_numpy(np.array(a))
        buf = self._buf((k, "in", i), a.shape, torch.from_numpy(
            np.empty(0, a.dtype)).dtype)
        buf.numpy()[...] = a
        return buf

    def fetch(self, k: int, outs) -> _Fetch:
        """Enqueue the outputs of slot k's tick (the last begun) for the
        host.  A sharded output's parts land in their row blocks of one
        buffer, each shard's copies followed by an event on its own card's
        stream."""
        tick = self._ticks - 1
        if not self._cuda:
            return _Fetch([], [unshard_batch_tree(t) if isinstance(
                t, Sharded) else t for t in outs], tick)
        host, shards = [], {}
        for j, t in enumerate(outs):
            buf = self._buf((k, "out", j), t.shape, t.dtype)
            parts = t.parts if isinstance(t, Sharded) else (t,)
            lo = 0
            for s, p in enumerate(parts):
                hi = lo + int(p.shape[0])
                buf[lo:hi].copy_(p, non_blocking=True)
                shards[s] = p.device
                lo = hi
            host.append(buf)
        evs = self._events[k] = []
        for dev in shards.values():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            evs.append(ev)
        return _Fetch(evs, host, tick)

    @staticmethod
    def result(fetched: _Fetch) -> List[np.ndarray]:
        """Wait for a fetch; its outputs as private numpy arrays."""
        with trace.span("host.wait", fetched.tick):
            for ev in fetched.events:
                ev.synchronize()
        return [np.array(h.numpy()) for h in fetched.host]


def _launch(server, key, fn, *arrays):
    """Run one tick program over `server._state`; → (its _HostIO slot, its
    outputs on the device, valid until the program's next replay)."""
    io = server._io
    k = io.begin()
    with trace.span(server._SPANS.stage):
        ins = [io.stage(k, i, a) for i, a in enumerate(arrays)]
    *outs, server._state = server.engine._run(fn, key, server._state, *ins,
                                              graphs=server._graphs)
    return k, outs


def _submit(server, key, fn, *arrays):
    """Run one tick program over `server._state`; → the fetch of its
    outputs (see _HostIO)."""
    k, outs = _launch(server, key, fn, *arrays)
    with trace.span(server._SPANS.fetch):
        return server._io.fetch(k, outs)


def _check_engine(engine, sample_rate_hz, device) -> None:
    if sample_rate_hz is not None and engine.sample_rate_hz != sample_rate_hz:
        raise ValueError(
            f"sample_rate_hz={sample_rate_hz} contradicts the injected "
            f"engine's {engine.sample_rate_hz} Hz")
    if device is not None and torch.device(device).type != engine.device.type:
        raise ValueError(f"device={device} contradicts the injected engine's "
                         f"{engine.device}")


def _no_inflight_tick(server, verb: str) -> None:
    if server._pending is not None or server._wire_pending is not None:
        raise RuntimeError(
            f"flush_async() before {verb}: a tick is in flight")


def _active_mask(server) -> np.ndarray:
    # Rebuilding this is O(capacity) python: cached per admission epoch.
    if server._active_cache is None:
        cached = np.zeros(server.capacity, bool)
        if server._by_id:
            cached[list(server._by_id.values())] = True
        server._active_cache = cached
    return server._active_cache


def _server_save(server, path: str, kind: str, extra: Dict[str, object],
                 transport: Optional[dict] = None) -> None:
    """Snapshot engine state AND the host slot bookkeeping, so a drained
    server restores mid-call on another host.  In-flight async pipelines
    must be flushed first.  Stream ids ride in the snapshot's JSON header:
    numpy scalars are coerced, richer id objects are refused here."""
    _no_inflight_tick(server, "save")

    def scalar(sid):
        if isinstance(sid, np.generic):
            sid = sid.item()
        if sid is not None and not isinstance(sid, (str, int, float, bool)):
            raise TypeError(
                f"stream id {sid!r} is not JSON-scalar; snapshots require "
                "str/int stream ids")
        return sid

    slots = [(scalar(s.stream_id), bool(s.active)) for s in server._slots]
    state = server._state
    if isinstance(state, Sharded):  # the unsharded layout, in shard order
        state = unshard_batch_tree(state)
    checkpoint.save_state(
        path, state,
        extra={"kind": kind, "slots": slots, "gen": server._gen.tolist(),
               "sample_rate_hz": server.sample_rate_hz,
               # Opaque serving-layer state riding the same atomic
               # snapshot; restore() hands it back to the transport.
               **({"transport": transport} if transport is not None else {}),
               **extra})


def _server_restore(server, path: str, kind: str, required: tuple = (),
                    validate=None) -> Dict[str, object]:
    """Validates everything BEFORE mutating the server: a failed restore
    leaves it exactly as it was.  The snapshot is loaded once."""
    _no_inflight_tick(server, "restore")
    state, extra = checkpoint.load_state(path)
    if extra.get("kind") != kind:
        raise ValueError(f"snapshot is not a {kind}-server snapshot")
    for k in ("slots", "gen", *required):
        if k not in extra:
            raise ValueError(f"snapshot is missing the {k!r} header field")
    slots = extra["slots"]
    if len(slots) != server.capacity:
        raise ValueError(
            f"snapshot capacity {len(slots)} != server capacity "
            f"{server.capacity}")
    snap_rate = extra.get("sample_rate_hz", config.INTERNAL_SAMPLE_RATE)
    if snap_rate != server.sample_rate_hz:
        raise ValueError(
            f"snapshot is a {snap_rate} Hz fleet; this server runs at "
            f"{server.sample_rate_hz} Hz")
    if validate is not None:
        validate(extra)
    mesh = getattr(server.engine, "mesh", None)
    if mesh is not None:  # a mesh-sharded engine: land the state sharded
        server._state = shard_batch_tree(state_from_numpy(state, "cpu"),
                                         mesh, server.engine.axis_name)
    else:
        server._state = state_from_numpy(state, server.engine.device)
    server._slots = [_Slot(sid, active) for sid, active in slots]
    server._by_id = {s.stream_id: i for i, s in enumerate(server._slots)
                     if s.active}
    server._gen = np.asarray(extra["gen"], np.int64)
    server._active_cache = None
    return extra


def _check_slot(slot_table: List[_Slot], capacity: int, slot: int) -> int:
    """Validate a caller-directed slot."""
    slot = int(slot)
    if not 0 <= slot < capacity:
        raise ValueError(f"slot {slot} out of range [0, {capacity})")
    if slot_table[slot].active:
        raise ValueError(
            f"slot {slot} is occupied by stream "
            f"{slot_table[slot].stream_id!r}")
    return slot


def _free_slot(server, slot: Optional[int]) -> int:
    if slot is not None:
        return _check_slot(server._slots, server.capacity, slot)
    for i, s in enumerate(server._slots):
        if not s.active:
            return i
    raise RuntimeError("server at capacity")


def _assign_slots(by_id: Dict[object, int], slot_table: List[_Slot],
                  capacity: int, ids: List[object],
                  want: Optional[Dict[object, int]] = None):
    """Validate a bulk admission and assign free slots (all-or-nothing:
    raises before any state is touched).  Returns (mask [capacity] bool,
    {stream_id: slot})."""
    if len(set(ids)) != len(ids):
        raise KeyError("duplicate stream ids in bulk admission")
    for sid in ids:
        if sid in by_id:
            raise KeyError(f"stream {sid!r} already active")
    if want is not None:
        chosen = [_check_slot(slot_table, capacity, want[sid]) for sid in ids]
        if len(set(chosen)) != len(chosen):
            raise ValueError("duplicate slots in directed bulk admission")
    else:
        free = [i for i, s in enumerate(slot_table) if not s.active]
        if len(free) < len(ids):
            raise RuntimeError("server at capacity")
        chosen = free[: len(ids)]
    mask = np.zeros(capacity, bool)
    slots: Dict[object, int] = {}
    for sid, i in zip(ids, chosen):
        mask[i] = True
        slots[sid] = i
    return mask, slots


class DecoderServer:
    """Fixed-capacity batched decoder with per-stream admission."""

    _SPANS = _DEC

    def __init__(self, capacity: int, engine: Optional[DecoderEngine] = None,
                 model_path: str = config.DEFAULT_MODEL_PATH, seed: int = 0,
                 sample_rate_hz: Optional[int] = None, *, device=None):
        # The default engine emits int16 inside its own step; every tick
        # program casts to int16 on device anyway, so an injected float
        # engine gives the same bytes.  sample_rate_hz is the fleet's
        # external rate: the engine resamples inside its step.
        self.engine = engine or DecoderEngine(
            sample_rate_hz or config.INTERNAL_SAMPLE_RATE,
            model_path=model_path, emit_dtype="int16", device=device)
        _check_engine(self.engine, sample_rate_hz, device)
        self.sample_rate_hz = self.engine.sample_rate_hz
        self.hop_samples = self.engine.hop_samples
        self.capacity = capacity
        self._seed = seed
        self._state = self.engine.init_state(capacity, seed=seed)
        self._slots: List[_Slot] = [_Slot(None) for _ in range(capacity)]
        self._by_id: Dict[object, int] = {}
        self._num_stages = self.engine.rvq.num_stages
        # Engines built with max_bitrate= skip RVQ stages beyond the cap;
        # packets that need more would decode silently degraded, so the
        # server treats them as malformed instead.
        self._stage_cap = self.engine._max_stages or self._num_stages
        self._last_comfort = np.zeros(capacity, bool)
        # Malformed wire packets per slot: treated as loss, never fatal.
        self.bad_packets = np.zeros(capacity, np.int64)
        # Packets addressed to no active stream (stragglers after hangup).
        self.inactive_drops = 0
        # Bumped on every admission: lets the async drain detect that a
        # slot changed hands between submit and drain.
        self._gen = np.zeros(capacity, np.int64)
        self._io = _HostIO(self.engine.device)
        self._graphs = self.engine.own_graphs()
        self._pending = self._wire_pending = None
        self._active_cache = None
        self._programs: Dict[tuple, object] = {}
        native.build()  # compile the wire codec now, not mid-tick

    @property
    def num_active(self) -> int:
        return len(self._by_id)

    # -- admission ---------------------------------------------------------------
    def add_stream(self, stream_id, slot: Optional[int] = None) -> int:
        """Admit a stream; returns its slot.  One masked state reset, no
        re-capture.  `slot` directs placement; occupied or out-of-range
        slots are refused before any state is touched."""
        if stream_id in self._by_id:
            raise KeyError(f"stream {stream_id!r} already active")
        i = _free_slot(self, slot)
        return self.add_streams([stream_id], slots={stream_id: i})[stream_id]

    def add_streams(self, stream_ids,
                    slots: Optional[Dict[object, int]] = None
                    ) -> Dict[object, int]:
        """Bulk admission: one masked state reset for the whole group.
        All-or-nothing: raises before any mutation if a stream is
        duplicate or capacity is short.  `slots` directs placement per
        stream (must cover every id)."""
        ids = list(stream_ids)
        if not ids:
            return {}
        mask, slots = _assign_slots(self._by_id, self._slots, self.capacity,
                                    ids, want=slots)
        self._state = self.engine._reset(self._state, mask, self._graphs,
                                         seed=self._seed)
        lc = np.array(self._last_comfort)
        for sid, i in slots.items():
            self._slots[i] = _Slot(sid, True)
            self._by_id[sid] = i
            self.bad_packets[i] = 0  # the slot's counter belongs to its stream
            lc[i] = False  # ditto the evicted stream's comfort-noise flag
            self._gen[i] += 1
        self._last_comfort = lc
        self._active_cache = None
        return slots

    def remove_stream(self, stream_id) -> None:
        i = self._by_id.pop(stream_id)
        self._slots[i] = _Slot(None, False)
        self._active_cache = None

    def save(self, path: str, transport: Optional[dict] = None) -> None:
        """Drain-for-maintenance snapshot: engine state + slot table +
        per-slot counters (+ an opaque `transport` dict).  Restore with
        DecoderServer.restore on a server of the same capacity (either
        package's, in float mode); streams continue mid-call."""
        _server_save(self, path, "decoder", {
            "seed": self._seed,
            "bad_packets": self.bad_packets.tolist(),
            "last_comfort": self._last_comfort.tolist(),
            "inactive_drops": int(self.inactive_drops),
        }, transport)

    def restore(self, path: str) -> Optional[dict]:
        extra = _server_restore(
            self, path, "decoder",
            required=("seed", "bad_packets", "last_comfort"))
        # Later admissions keep the original server's RNG lineage.
        self._seed = extra["seed"]
        self.bad_packets = np.asarray(extra["bad_packets"], np.int64)
        self._last_comfort = np.asarray(extra["last_comfort"], bool)
        self.inactive_drops = int(extra.get("inactive_drops", 0))
        return extra.get("transport")

    # -- device programs -----------------------------------------------------------
    def _packed_step(self, state, indices, received):
        audio, is_cn, state = self.engine._step_impl(state, indices, received)
        return audio.to(torch.int16), is_cn, state

    def _wire_step(self, bits: int):
        """Unpack + step + int16 cast for uniform `bits` packets."""
        key = ("dec_wire", bits)
        if key not in self._programs:
            # The programs hold the engine, not the server: a dropped
            # server frees its device state without waiting for a cycle GC.
            nq = bits // config.BITS_PER_QUANTIZER
            engine, stages = self.engine, self._num_stages

            def step(state, wire, received):
                trace.mark("dec.wire_unpack", wire)
                full = torch.full((wire.shape[0], stages), -1,
                                  dtype=torch.int32, device=wire.device)
                full[:, :nq] = packet.unpack_wire_device(wire, bits)
                audio, is_cn, state = engine._step_impl(state, full, received)
                return audio.to(torch.int16), is_cn, state

            self._programs[key] = step
        return key, self._programs[key]

    def _wire_step_mixed(self, width: int):
        """Unpack + step + int16 cast for rows of `width` bytes holding
        packets of per-row sizes (stage counts as a device input)."""
        key = ("dec_wire_mixed", width)
        if key not in self._programs:
            n_keep = min(2 * width, self._num_stages)
            engine, stages = self.engine, self._num_stages

            def step(state, wire, received, nq_row):
                trace.mark("dec.wire_unpack", wire)
                idx = packet.unpack_wire_device_mixed(wire, nq_row)
                full = torch.full((wire.shape[0], stages), -1,
                                  dtype=torch.int32, device=wire.device)
                full[:, :n_keep] = idx[:, :n_keep]
                audio, is_cn, state = engine._step_impl(state, full, received)
                return audio.to(torch.int16), is_cn, state

            self._programs[key] = step
        return key, self._programs[key]

    # -- ticks ------------------------------------------------------------------------
    def tick(self, packets: Dict[object, Optional[bytes]]) -> Dict[object, np.ndarray]:
        """One 20 ms step for every active stream.

        packets: stream_id -> wire bytes, or None/missing for packet loss.
        Returns stream_id -> hop of int16 audio at the engine's rate.
        """
        _no_inflight_tick(self, "a synchronous tick")
        with trace.span(_DEC.tick, self._io.next_tick):
            with trace.span("dec.unpack"):
                indices = np.full((self.capacity, self._num_stages), -1,
                                  np.int32)
                received = np.zeros(self.capacity, bool)
                for sid, pkt in packets.items():
                    i = self._by_id.get(sid)
                    if i is None:
                        # A straggler for a stream that already hung up:
                        # counted, not a reason to abort every live call's
                        # tick.
                        self.inactive_drops += 1
                        continue
                    if pkt:
                        try:
                            idx = packet.unpack_indices(pkt)
                            if idx.size > self._stage_cap:
                                raise ValueError(
                                    "packet exceeds engine max_bitrate")
                        except ValueError:
                            # A malformed packet from one peer is loss for
                            # that stream (reference: LyraDecoder::
                            # SetEncodedPacket returns false per stream);
                            # PLC covers the hop.
                            self.bad_packets[i] += 1
                            continue
                        indices[i, : idx.size] = idx
                        received[i] = True
                lost = self._lost(received)
            audio = self._result(_submit(
                self, ("dec_packed",), self._packed_step, indices, received),
                lost)
            return {sid: audio[i] for sid, i in self._by_id.items()}

    def _lost(self, received: np.ndarray) -> Optional[np.ndarray]:
        """While tracing, the active rows a submitted tick does not
        receive (its drain counts them); else None."""
        return _active_mask(self) & ~received if trace.enabled() else None

    def _result(self, fetched: _Fetch, lost: Optional[np.ndarray],
                gen_prev: Optional[np.ndarray] = None) -> np.ndarray:
        """A fetched tick's audio, and its comfort-noise flags kept; with
        `gen_prev`, a slot that changed hands since the submit drains
        silence and no flag.  Counts the tick's rows where `lost` is
        given."""
        with trace.span(_DEC.drain, fetched.tick):
            audio, is_cn = _HostIO.result(fetched)
            if gen_prev is not None:
                stale = gen_prev != self._gen  # slot re-admitted since submit
                audio[stale] = 0
                is_cn = is_cn & ~stale
            self._last_comfort = is_cn
            if lost is not None:
                cn = int((lost & is_cn).sum())
                trace.count("dec.rows_comfort_noise", cn)
                trace.count("dec.rows_concealed", int(lost.sum()) - cn)
        return audio

    def is_comfort_noise(self, stream_id) -> bool:
        return bool(self._last_comfort[self._by_id[stream_id]])

    def tick_packed(self, packets: np.ndarray, received: np.ndarray,
                    sizes: np.ndarray) -> np.ndarray:
        """Array tick: packets [capacity, max_packet_size] uint8, received
        [capacity] bool, sizes [capacity] byte counts (0 = DTX empty packet,
        treated as loss).  Wire bytes → indices on the host, grouped by
        packet size.  Returns audio [capacity, hop] int16."""
        _no_inflight_tick(self, "a synchronous tick")
        with trace.span(_DEC.tick, self._io.next_tick):
            indices, received, lost = self._unpack_wire(packets, received,
                                                        sizes)
            return self._result(_submit(
                self, ("dec_packed",), self._packed_step, indices, received),
                lost)

    def _unpack_wire(self, packets, received, sizes):
        """Wire bytes → (indices [capacity, stages], effective received,
        `_lost`)."""
        with trace.span("dec.unpack"):
            packets = np.ascontiguousarray(packets, np.uint8)
            sizes = np.asarray(sizes)
            received = (np.asarray(received, bool) & (sizes > 0)
                        & _active_mask(self))
            if np.any(received & (sizes > packets.shape[1])):
                # The host's own buffer-assembly bug: refuse loudly before
                # any counter moves.
                raise ValueError(f"sizes exceed the packets array width "
                                 f"{packets.shape[1]}")
            indices = np.full((self.capacity, self._num_stages), -1,
                              np.int32)
            cap = self._stage_cap
            for size in np.unique(sizes[received]):
                bits = config.packet_size_to_num_quantized_bits(int(size))
                if bits < 0 or bits // config.BITS_PER_QUANTIZER > cap:
                    # Unknown size, or above the engine's max_bitrate cap:
                    # the whole size group is malformed → loss.
                    bad = received & (sizes == size)
                    self.bad_packets[bad] += 1
                    received = received & ~bad
                    continue
                rows = np.flatnonzero(received & (sizes == size))
                idx = packet.unpack_indices_batch(packets[rows, :int(size)],
                                                  bits)
                indices[rows, : idx.shape[1]] = idx
            return indices, received, self._lost(received)

    def tick_wire(self, packets: np.ndarray, received: np.ndarray,
                  sizes: Optional[np.ndarray] = None) -> np.ndarray:
        """Device-wire tick: the wire-format unpack runs on device inside
        the same program as the decode step.

        Without `sizes`, packets must be [capacity, packet_size] for one
        supported size; DTX empties and losses both come through
        `received` (from EncoderServer.tick_wire: `received & (sizes >
        0)`).  With `sizes` ([capacity] byte counts, EncoderServer.
        tick_wire's second output), each row's own size selects its stage
        count on device, size 0 is loss/DTX, and an unrecognized or
        over-cap size is a counted drop (bad_packets).  Bit-identical
        audio to tick_packed in both forms."""
        _no_inflight_tick(self, "a synchronous tick")
        with trace.span(_DEC.tick, self._io.next_tick):
            return self._result(*self._wire_run(packets, received, sizes))

    def _wire_run(self, packets, received, sizes, submit=_submit):
        """Uniform/mixed dispatch of the wire tick; → (`submit`'s result:
        the output fetch, or with `submit=_launch` the outputs on the
        device (the conference bridge's decode stage); `_lost`)."""
        with trace.span("dec.unpack"):
            packets = np.ascontiguousarray(packets, np.uint8)
            if sizes is None:
                bits = config.packet_size_to_num_quantized_bits(
                    int(packets.shape[1]))
                cap = self._stage_cap
                if bits < 0 or bits // config.BITS_PER_QUANTIZER > cap:
                    raise ValueError(f"packet size {packets.shape[1]} "
                                     f"unsupported for this engine")
                received = np.asarray(received, bool) & _active_mask(self)
                program, args = self._wire_step(bits), (packets, received)
            else:
                nq_row, received = self._sizes_to_nq(sizes, received,
                                                     packets.shape[1])
                program = self._wire_step_mixed(packets.shape[1])
                args = (packets, received, nq_row)
            lost = self._lost(received)
        return submit(self, *program, *args), lost

    def _sizes_to_nq(self, sizes: np.ndarray, received: np.ndarray,
                     width: int):
        """Per-row packet sizes → per-row RVQ stage counts + effective
        received mask.  Unknown sizes and bitrates above the engine's
        max_bitrate cap are counted drops; size 0 is plain loss."""
        sizes = np.asarray(sizes)
        received = (np.asarray(received, bool) & (sizes > 0)
                    & _active_mask(self))
        if np.any(received & (sizes > width)):
            # Decoding only the stages that fit would be silently degraded
            # audio: refuse loudly.
            raise ValueError(
                f"sizes exceed the packets array width {width}")
        nq_row = np.zeros(self.capacity, np.int32)
        bad = np.zeros(self.capacity, bool)
        for size in np.unique(sizes[received]):
            bits = config.packet_size_to_num_quantized_bits(int(size))
            sel = received & (sizes == size)
            if (bits < 0
                    or bits // config.BITS_PER_QUANTIZER > self._stage_cap):
                bad |= sel
            else:
                nq_row[sel] = bits // config.BITS_PER_QUANTIZER
        self.bad_packets[bad] += 1
        return nq_row, received & ~bad

    def tick_wire_async(self, packets: np.ndarray, received: np.ndarray,
                        sizes: Optional[np.ndarray] = None
                        ) -> Optional[np.ndarray]:
        """Pipelined tick_wire: submit this tick's wire bytes, return the
        *previous* tick's audio (None on the first call).  Same contract
        as tick_packed_async; same inputs as tick_wire."""
        if self._pending is not None:
            raise RuntimeError(
                "tick_packed_async pipeline in flight; flush_async() first")
        with trace.span(_DEC.tick, self._io.next_tick):
            fetched, lost = self._wire_run(packets, received, sizes)
            pending, self._wire_pending = self._wire_pending, (
                fetched, self._gen.copy(), lost)
            return None if pending is None else self._drain(pending)

    def flush_wire_async(self) -> Optional[np.ndarray]:
        pending, self._wire_pending = self._wire_pending, None
        if pending is None:
            return None
        with trace.span(_DEC.tick, pending[0].tick):
            return self._drain(pending)

    def tick_packed_async(self, packets: np.ndarray, received: np.ndarray,
                          sizes: np.ndarray) -> Optional[np.ndarray]:
        """Pipelined tick: submit this tick's packets, return the *previous*
        tick's audio (None on the first call).

        One tick of added playout latency buys overlap of device compute,
        the device→host copy and host byte handling.  Ordering and loss
        semantics are tick_packed's shifted by one tick.  A slot that
        changed hands between submit and drain (remove_stream +
        add_stream) drains *silence*, never the evicted stream's audio."""
        if self._wire_pending is not None:
            raise RuntimeError(
                "tick_wire_async pipeline in flight; flush_wire_async() first")
        with trace.span(_DEC.tick, self._io.next_tick):
            indices, received, lost = self._unpack_wire(packets, received,
                                                        sizes)
            fetched = _submit(self, ("dec_packed",), self._packed_step,
                              indices, received)
            pending, self._pending = self._pending, (
                fetched, self._gen.copy(), lost)
            return None if pending is None else self._drain(pending)

    def _drain(self, pending) -> np.ndarray:
        fetched, gen_prev, lost = pending
        return self._result(fetched, lost, gen_prev)

    def flush_async(self) -> Optional[np.ndarray]:
        """Drain the last in-flight tick of whichever async pipeline is
        live (tick_packed_async or tick_wire_async)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return self.flush_wire_async()
        with trace.span(_DEC.tick, pending[0].tick):
            return self._drain(pending)


class EncoderServer:
    """Fixed-capacity batched encoder; emits wire packets per stream."""

    _SPANS = _ENC

    def __init__(self, capacity: int, engine: Optional[EncoderEngine] = None,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 bitrate: int = 3200, sample_rate_hz: Optional[int] = None,
                 *, device=None):
        self.engine = engine or EncoderEngine(
            sample_rate_hz or config.INTERNAL_SAMPLE_RATE,
            model_path=model_path, device=device)
        _check_engine(self.engine, sample_rate_hz, device)
        self.sample_rate_hz = self.engine.sample_rate_hz
        self.hop_samples = self.engine.hop_samples
        self.capacity = capacity
        self._state = self.engine.init_state(capacity)
        self._slots: List[_Slot] = [_Slot(None) for _ in range(capacity)]
        self._by_id: Dict[object, int] = {}
        self._stage_cap = self.engine._max_stages or self.engine.rvq.num_stages
        self._default_bits = self._check_bits(bitrate)
        self._nq = np.full(
            capacity, self._default_bits // config.BITS_PER_QUANTIZER, np.int32)
        self._bits = np.full(capacity, self._default_bits, np.int32)
        # See DecoderServer._gen: detects slot reuse across an async drain.
        self._gen = np.zeros(capacity, np.int64)
        self._io = _HostIO(self.engine.device)
        self._graphs = self.engine.own_graphs()
        self._pending = self._wire_pending = None
        self._active_cache = None
        self._programs: Dict[tuple, object] = {}
        native.build()  # compile the wire codec now, not mid-tick

    def _check_bits(self, bitrate: int) -> int:
        bits = config.bitrate_to_num_quantized_bits(bitrate)
        if bits < 0:
            raise ValueError(f"unsupported bitrate {bitrate}")
        if bits // config.BITS_PER_QUANTIZER > self._stage_cap:
            raise ValueError(
                f"bitrate {bitrate} needs more RVQ stages than this engine's "
                f"max_bitrate cap computes ({self._stage_cap})")
        return bits

    @property
    def num_active(self) -> int:
        return len(self._by_id)

    # -- admission ---------------------------------------------------------------
    def add_stream(self, stream_id, bitrate: Optional[int] = None,
                   slot: Optional[int] = None) -> int:
        if stream_id in self._by_id:
            raise KeyError(f"stream {stream_id!r} already active")
        # Validate before mutating anything: a bad bitrate must not leave a
        # half-admitted stream occupying a slot.
        if bitrate is not None:
            self._check_bits(bitrate)
        i = _free_slot(self, slot)
        return self.add_streams([stream_id], bitrate,
                                slots={stream_id: i})[stream_id]

    def add_streams(self, stream_ids, bitrate: Optional[int] = None,
                    slots: Optional[Dict[object, int]] = None
                    ) -> Dict[object, int]:
        """Bulk admission at one bitrate — see DecoderServer.add_streams."""
        ids = list(stream_ids)
        bits = (self._default_bits if bitrate is None
                else self._check_bits(bitrate))
        if not ids:
            return {}
        mask, slots = _assign_slots(self._by_id, self._slots, self.capacity,
                                    ids, want=slots)
        self._state = self.engine._reset(self._state, mask, self._graphs)
        for sid, i in slots.items():
            self._slots[i] = _Slot(sid, True)
            self._by_id[sid] = i
            # Reused slots must not inherit the evicted stream's bitrate.
            self._nq[i] = bits // config.BITS_PER_QUANTIZER
            self._bits[i] = bits
            self._gen[i] += 1
        self._active_cache = None
        return slots

    def remove_stream(self, stream_id) -> None:
        i = self._by_id.pop(stream_id)
        self._slots[i] = _Slot(None, False)
        # Drop the evicted stream's bitrate at once: the wire width follows
        # the active rows' bits.
        self._nq[i] = self._default_bits // config.BITS_PER_QUANTIZER
        self._bits[i] = self._default_bits
        self._active_cache = None

    def set_bitrate(self, stream_id, bitrate: int) -> None:
        """Per-stream dynamic bitrate (reference: LyraEncoder::set_bitrate) —
        streams at different bitrates batch together."""
        bits = self._check_bits(bitrate)
        i = self._by_id[stream_id]
        self._nq[i] = bits // config.BITS_PER_QUANTIZER
        self._bits[i] = bits

    def save(self, path: str, transport: Optional[dict] = None) -> None:
        """Drain-for-maintenance snapshot — see DecoderServer.save."""
        _server_save(self, path, "encoder", {
            "bits": self._bits.tolist(),
        }, transport)

    def restore(self, path: str) -> Optional[dict]:
        def validate(extra):
            # The snapshot's active streams' bitrates must fit THIS
            # engine's stage cap (the condition add_stream/set_bitrate
            # refuse); inactive slots' stale bits do not gate restore.
            for (sid, active), bits in zip(extra["slots"], extra["bits"]):
                if active and bits // config.BITS_PER_QUANTIZER > self._stage_cap:
                    raise ValueError(
                        f"snapshot stream {sid!r} at {bits} quantized bits "
                        f"exceeds this engine's max_bitrate stage cap "
                        f"({self._stage_cap})")

        extra = _server_restore(self, path, "encoder",
                                required=("bits",), validate=validate)
        self._bits = np.asarray(extra["bits"], np.int32)
        self._nq = (self._bits // config.BITS_PER_QUANTIZER).astype(np.int32)
        return extra.get("transport")

    # -- device programs -----------------------------------------------------------
    def _step_submit(self, audio):
        """The engine step over the slot table; → the fetch of (indices,
        is_noise)."""
        with trace.span(_ENC.stage):
            pcm = _pcm_in(audio)
        return _submit(self, "step", self.engine._step_impl, pcm, self._nq)

    def _wire_step(self, max_bits: int):
        """Step + device wire pack at per-row stage counts into rows of
        the fleet's widest packet."""
        key = ("enc_wire", max_bits)
        if key not in self._programs:
            engine = self.engine  # not the server: see DecoderServer._wire_step

            def step(state, frames, nq_row):
                indices, is_noise, state = engine._step_impl(
                    state, frames, nq_row)
                trace.mark("enc.wire_pack", indices)
                return (packet.pack_wire_device_mixed(indices, nq_row,
                                                      max_bits),
                        is_noise, state)

            self._programs[key] = step
        return key, self._programs[key]

    # -- ticks ------------------------------------------------------------------------
    def tick_packed(self, audio: np.ndarray):
        """Array encode tick: audio [capacity, hop] int16-scale →
        (packets [capacity, max_size] uint8, sizes [capacity] int32).
        sizes is 0 for DTX noise hops; mixed per-stream bitrates pack in
        one host batch call per size group."""
        _no_inflight_tick(self, "a synchronous tick")
        with trace.span(_ENC.tick, self._io.next_tick):
            fetched = self._step_submit(audio)
            with trace.span(_ENC.drain, fetched.tick):
                active = _active_mask(self)
                indices, is_noise = self._result(fetched, active)
                return self._pack_wire(indices, is_noise, self._bits, active)

    @staticmethod
    def _result(fetched: _Fetch, active: np.ndarray):
        """A fetched tick's (indices or wire, is_noise); counts its DTX
        rows while tracing."""
        out, is_noise = _HostIO.result(fetched)
        if trace.enabled():
            trace.count("enc.rows_dtx", int((is_noise & active).sum()))
        return out, is_noise

    def _pack_wire(self, indices: np.ndarray, is_noise: np.ndarray,
                   bits_arr: np.ndarray, active: np.ndarray):
        """Indices → (packets [capacity, max_size] u8, sizes [capacity]).
        bits_arr/active are the per-slot wire config of the tick that
        produced the indices (snapshotted at submit on the async path).
        Width follows the active rows (default when empty)."""
        act_bits = bits_arr[active]
        max_size = config.packet_size(
            int(act_bits.max()) if act_bits.size else self._default_bits)
        out = np.zeros((self.capacity, max_size), np.uint8)
        sizes = np.zeros(self.capacity, np.int32)
        for bits in np.unique(bits_arr):
            rows = np.flatnonzero((bits_arr == bits) & ~is_noise & active)
            if rows.size == 0:
                continue
            pkts = packet.pack_indices_batch(indices[rows], int(bits))
            out[rows, : pkts.shape[1]] = pkts
            sizes[rows] = pkts.shape[1]
        return out, sizes

    def tick_wire(self, audio: np.ndarray):
        """Device-wire tick: one program runs the encode step AND the
        wire-format pack on device (packet.pack_wire_device_mixed), so the
        host receives packet bytes.  Mixed per-stream bitrates pack at
        their own rate into the fleet's widest packet size.  Returns (wire
        [capacity, max_size] uint8, sizes [capacity]) bit-identical to
        tick_packed: each row's first sizes[i] bytes are its own-rate
        packet, the tail and all non-emitting rows (inactive slots, DTX
        noise hops) are zero.  For DecoderServer.tick_wire pass these
        sizes and `received & (sizes > 0)`."""
        _no_inflight_tick(self, "a synchronous tick")
        with trace.span(_ENC.tick, self._io.next_tick):
            return self._drain_wire(self._wire_submit(audio))

    def _wire_submit(self, audio: np.ndarray):
        """Submit the step + device pack; → the pending tuple.  One
        program per fleet-widest bitrate (uniform and mixed fleets alike);
        the width follows the active rows (default when empty)."""
        with trace.span(_ENC.stage):
            rows = list(self._by_id.values())
            max_bits = (int(self._bits[rows].max()) if rows
                        else self._default_bits)
            pcm = _pcm_in(audio)
            config_now = (_active_mask(self), self._bits.copy(),
                          self._gen.copy())
        fetched = _submit(self, *self._wire_step(max_bits), pcm, self._nq)
        return (fetched, *config_now)

    def _drain_wire(self, pending):
        fetched, active, bits, gen_prev = pending
        with trace.span(_ENC.drain, fetched.tick):
            wire, is_noise = self._result(fetched, active)
            # As tick_packed: non-emitting rows carry zeros, and a slot
            # re-admitted since submit emits size 0; bits is the
            # submit-time snapshot.
            emit = (active & ~is_noise) & (gen_prev == self._gen)
            wire[~emit] = 0
            sizes = np.where(emit, config.packet_size(bits),
                             0).astype(np.int32)
            return wire, sizes

    def tick_wire_async(self, audio: np.ndarray):
        """Pipelined tick_wire: submit this tick's audio, return the
        *previous* tick's (wire, sizes) — None on the first call."""
        if self._pending is not None:
            raise RuntimeError(
                "tick_packed_async pipeline in flight; flush_async() first")
        with trace.span(_ENC.tick, self._io.next_tick):
            pending, self._wire_pending = self._wire_pending, \
                self._wire_submit(audio)
            return None if pending is None else self._drain_wire(pending)

    def flush_wire_async(self):
        pending, self._wire_pending = self._wire_pending, None
        if pending is None:
            return None
        with trace.span(_ENC.tick, pending[0].tick):
            return self._drain_wire(pending)

    def tick_packed_async(self, audio: np.ndarray):
        """Pipelined encode tick: submit this tick's audio, return the
        *previous* tick's (packets, sizes) — None on the first call.  A
        slot that changed hands between submit and drain emits size 0."""
        if self._wire_pending is not None:
            raise RuntimeError(
                "tick_wire_async pipeline in flight; flush_wire_async() first")
        with trace.span(_ENC.tick, self._io.next_tick):
            fetched = self._step_submit(audio)
            # Snapshot the wire config with the indices it belongs to.
            pending, self._pending = self._pending, (
                fetched, self._bits.copy(), _active_mask(self),
                self._gen.copy())
            return None if pending is None else self._drain(pending)

    def _drain(self, pending):
        fetched, bits, active, gen_prev = pending
        with trace.span(_ENC.drain, fetched.tick):
            indices, is_noise = self._result(fetched, active)
            return self._pack_wire(indices, is_noise, bits,
                                   active & (gen_prev == self._gen))

    def flush_async(self):
        """Drain the last in-flight tick of whichever async pipeline is
        live (tick_packed_async or tick_wire_async)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return self.flush_wire_async()
        with trace.span(_ENC.tick, pending[0].tick):
            return self._drain(pending)

    def tick(self, audio: Dict[object, np.ndarray]) -> Dict[object, bytes]:
        """One 20 ms step: stream_id -> hop of int16 samples in,
        stream_id -> wire packet bytes out (b"" for DTX noise hops)."""
        _no_inflight_tick(self, "a synchronous tick")
        with trace.span(_ENC.tick, self._io.next_tick):
            with trace.span(_ENC.stage):
                missing = self._by_id.keys() - audio.keys()
                if missing:
                    # Encoding zeros for an omitted active stream would emit
                    # a real packet of silence with no error: the host must
                    # account for every live call.
                    raise ValueError(f"no audio for active streams "
                                     f"{sorted(missing, key=repr)!r}")
                # All-int16 hops assemble into an int16 frame buffer; any
                # float hop keeps the f32 contract.
                hops = {sid: np.asarray(hop) for sid, hop in audio.items()}
                dt = (np.int16 if all(h.dtype == np.int16
                                      for h in hops.values())
                      else np.float32)
                frames = np.zeros((self.capacity, self.engine.hop_samples),
                                  dt)
                for sid, hop in hops.items():
                    i = self._by_id.get(sid)
                    if i is None:
                        raise KeyError(f"unknown stream {sid!r}")
                    frames[i] = hop.astype(dt)
            fetched = self._step_submit(frames)
            with trace.span(_ENC.drain, fetched.tick):
                indices, is_noise = self._result(fetched, _active_mask(self))
                out: Dict[object, bytes] = {}
                # Group by bitrate so each group packs in one batch call.
                for bits in np.unique(self._bits[list(self._by_id.values())]
                                      if self._by_id else []):
                    ids = [sid for sid, i in self._by_id.items()
                           if self._bits[i] == bits and not is_noise[i]]
                    if not ids:
                        continue
                    rows = np.stack([indices[self._by_id[sid]]
                                     for sid in ids])
                    pkts = packet.pack_indices_batch(rows, int(bits))
                    for sid, row in zip(ids, pkts):
                        out[sid] = row.tobytes()
                for sid, i in self._by_id.items():
                    if is_noise[i]:
                        out[sid] = b""
                return out


def _concat_wave_outputs(outs):
    """Concatenate per-wave tick outputs along the stream axis.

    Handles both decoder ticks (one audio array) and encoder ticks
    ((wire, sizes) tuples).  Rows right-pad to the widest wave's width —
    wire tails are zero by the tick_wire contract; audio rows from a
    lower-rate wave of a mixed-rate pool carry their own hop in the
    leading columns and zero padding after (a 16 kHz row in a pool whose
    widest wave is 48 kHz is 320 samples + 640 zeros)."""
    def pad_to(arrays, width):
        # No-op for the common single-rate/single-size pool: np.pad always
        # copies, and these are the fleet's PCM/wire buffers every 20 ms.
        return [a if a.shape[1] == width
                else np.pad(a, ((0, 0), (0, width - a.shape[1])))
                for a in arrays]

    if isinstance(outs[0], tuple):
        wires, sizes = zip(*outs)
        wires = pad_to(wires, max(w.shape[1] for w in wires))
        return np.concatenate(wires), np.concatenate(sizes)
    return np.concatenate(pad_to(outs, max(a.shape[1] for a in outs)))


class ServerPool:
    """Wave-scheduled serving: one fleet split across N identical servers
    whose device programs interleave each tick.

    Why: on the TPU one program over the whole fleet sat past the HBM
    working-set knee, and the JAX package serves its headline in waves
    (its bench.py); whether waves pay on the card is not measured yet.
    Streams are row-independent, so the fleet partitions freely; the pool
    preserves the single-server array API with global rows = the
    concatenation of each wave's rows.  The async tick is the intended
    path: submitting wave i+1 before draining wave i's previous output
    keeps the device queue fed across waves.

    The reference has no counterpart (one codec instance per stream,
    reference: lyra/lyra_encoder.h:30-43); this is deployment-scale
    runtime, like the servers it wraps.  In the port each wave's server
    replays its programs from its own graph cache, so waves sharing an
    engine never write each other's state.

    Mixed external sample rates: waves may run at different I/O rates
    (each wave's engine resamples on device, see the servers'
    sample_rate_hz) — a pool of a 16 kHz wave and a 48 kHz wave serves
    both client populations on one chip.  Admission then routes by rate
    (`add_stream(sid, sample_rate_hz=...)`, required once the pool is
    mixed-rate), encoder PCM input is [capacity, max hop] with each row's
    own hop left-aligned, and decoder output rows pad the same way
    (reference: lyra/lyra_config.h:56-57 — per-codec-instance external
    rates, here per wave at serving scale).
    """

    def __init__(self, servers: Sequence):
        servers = list(servers)
        if not servers or len({s.capacity for s in servers}) != 1:
            raise ValueError("pool needs >= 1 servers of equal capacity")
        kinds = {type(s) for s in servers}
        if len(kinds) != 1:
            raise ValueError("pool servers must be all-encoder or all-decoder")
        self.servers = servers
        self.wave_capacity = servers[0].capacity
        self.capacity = self.wave_capacity * len(servers)
        self.rates = tuple(s.sample_rate_hz for s in servers)
        # Mixed-rate pools take/emit PCM at the widest wave's hop; see
        # _wave_args for the per-wave column contract.
        self.hop_samples = max(s.hop_samples for s in servers)
        self._is_encoder = isinstance(servers[0], EncoderServer)

    def sample_rate_of(self, stream_id) -> int:
        _, s = self._locate(stream_id)
        return s.sample_rate_hz

    def hop_samples_of(self, stream_id) -> int:
        """Valid sample count of this stream's rows in pool PCM arrays
        (the rest of the row is padding in a mixed-rate pool)."""
        _, s = self._locate(stream_id)
        return s.hop_samples

    def _candidate_waves(self, sample_rate_hz: Optional[int]):
        """Waves admission may target for this rate.  A mixed-rate pool
        with no explicit rate is refused loudly: 'any wave' would pin the
        caller's PCM to whatever rate the emptiest wave happens to run."""
        if sample_rate_hz is None:
            if len(set(self.rates)) > 1:
                raise ValueError(
                    f"pool serves mixed rates {sorted(set(self.rates))}; "
                    f"admission needs an explicit sample_rate_hz")
            return list(range(len(self.servers)))
        waves = [w for w, r in enumerate(self.rates) if r == sample_rate_hz]
        if not waves:
            raise ValueError(
                f"pool has no {sample_rate_hz} Hz wave "
                f"(rates: {sorted(set(self.rates))})")
        return waves

    @property
    def num_active(self) -> int:
        return sum(s.num_active for s in self.servers)

    @property
    def bad_packets(self) -> np.ndarray:
        return np.concatenate([s.bad_packets for s in self.servers])

    def _locate(self, stream_id):
        for w, s in enumerate(self.servers):
            if stream_id in s._by_id:
                return w, s
        raise KeyError(f"unknown stream {stream_id!r}")

    def add_stream(self, stream_id, sample_rate_hz: Optional[int] = None,
                   **kw) -> int:
        """Admit on the least-loaded (rate-matching) wave; returns the
        global row."""
        for s in self.servers:
            if stream_id in s._by_id:
                raise KeyError(f"stream {stream_id!r} already active")
        waves = self._candidate_waves(sample_rate_hz)
        w = min(waves, key=lambda i: self.servers[i].num_active)
        if self.servers[w].num_active >= self.wave_capacity:
            raise RuntimeError(
                "pool at capacity" if sample_rate_hz is None else
                f"pool at capacity for {sample_rate_hz} Hz waves")
        slot = self.servers[w].add_stream(stream_id, **kw)
        return w * self.wave_capacity + slot

    def add_streams(self, stream_ids, sample_rate_hz: Optional[int] = None,
                    **kw) -> Dict[object, int]:
        """Bulk admission, balanced across (rate-matching) waves
        (all-or-nothing)."""
        ids = list(stream_ids)
        if len(set(ids)) != len(ids):
            raise KeyError("duplicate stream ids in bulk admission")
        waves = self._candidate_waves(sample_rate_hz)
        for s in self.servers:
            for sid in ids:
                if sid in s._by_id:
                    raise KeyError(f"stream {sid!r} already active")
        free = [self.wave_capacity - self.servers[w].num_active
                for w in waves]
        if len(ids) > sum(free):
            raise RuntimeError(
                "pool at capacity" if sample_rate_hz is None else
                f"pool at capacity for {sample_rate_hz} Hz waves")
        # Fill toward balance: each id goes to the emptiest candidate wave.
        assign: Dict[int, List[object]] = {w: [] for w in waves}
        load = {w: self.servers[w].num_active for w in waves}
        for sid in ids:
            w = min(waves, key=lambda i: load[i])
            assign[w].append(sid)
            load[w] += 1
        out: Dict[object, int] = {}
        for w, group in assign.items():
            for sid, slot in self.servers[w].add_streams(group, **kw).items():
                out[sid] = w * self.wave_capacity + slot
        return out

    def remove_stream(self, stream_id) -> None:
        _, s = self._locate(stream_id)
        s.remove_stream(stream_id)

    def set_bitrate(self, stream_id, bitrate: int) -> None:
        _, s = self._locate(stream_id)
        s.set_bitrate(stream_id, bitrate)

    def _wave_args(self, w: int, arrays):
        lo = w * self.wave_capacity
        out = tuple(a[lo: lo + self.wave_capacity] for a in arrays)
        if self._is_encoder:
            # Encoder ticks take one PCM array.  In a mixed-rate pool it is
            # [capacity, max hop] with each row's own hop left-aligned, so a
            # lower-rate wave reads only its leading columns; anything
            # narrower than the pool hop is the caller assembling the wrong
            # buffer (a row's tail would silently decode as dropped audio).
            (audio,) = out
            if audio.ndim != 2 or audio.shape[1] != self.hop_samples:
                raise ValueError(
                    f"pool PCM must be [capacity, {self.hop_samples}] "
                    f"(the widest wave's hop); got {audio.shape}")
            out = (audio[:, : self.servers[w].hop_samples],)
        return out

    def tick_wire(self, *arrays):
        """Synchronous tick over all waves (correctness path; the async
        variant is the throughput path — it keeps the device queue fed)."""
        return _concat_wave_outputs([
            s.tick_wire(*self._wave_args(w, arrays))
            for w, s in enumerate(self.servers)])

    def tick_packed(self, *arrays):
        """Host-codec tick over all waves (the servers' tick_packed,
        sliced/concatenated exactly like tick_wire)."""
        return _concat_wave_outputs([
            s.tick_packed(*self._wave_args(w, arrays))
            for w, s in enumerate(self.servers)])

    def tick_packed_async(self, *arrays):
        return self._merge_async([
            s.tick_packed_async(*self._wave_args(w, arrays))
            for w, s in enumerate(self.servers)])

    def flush_async(self):
        return self._merge_async([s.flush_async() for s in self.servers])

    def tick_wire_async(self, *arrays):
        """Submit every wave's tick back-to-back, then return the
        *previous* tick's concatenated outputs (None on the first call).
        Per-wave submits happen before any drain, so wave i+1's device
        program queues while wave i's prior output is still in flight."""
        outs = [s.tick_wire_async(*self._wave_args(w, arrays))
                for w, s in enumerate(self.servers)]
        return self._merge_async(outs)

    def flush_wire_async(self):
        return self._merge_async([s.flush_wire_async()
                                  for s in self.servers])

    @staticmethod
    def _merge_async(outs):
        """None only when EVERY wave is pipeline-priming; a mix of drained
        and None waves means the pipelines desynchronized (e.g. one wave
        raised on an earlier tick) -- silently returning None would drop
        the drained waves' audio on the floor, so fail loudly instead."""
        pending = [o is None for o in outs]
        if all(pending):
            return None
        if any(pending):
            raise RuntimeError(
                f"pool wave pipelines desynchronized (waves "
                f"{[w for w, p in enumerate(pending) if p]} have nothing "
                f"in flight); flush and re-prime the pool")
        return _concat_wave_outputs(outs)

    def save(self, path: str, transport: Optional[dict] = None) -> None:
        """One snapshot per wave (path.w0, path.w1, ...).  The opaque
        serving-layer `transport` dict spans the whole pool (slot rows are
        pool-wide), so it rides wave 0's snapshot."""
        for w, s in enumerate(self.servers):
            s.save(f"{path}.w{w}", transport if w == 0 else None)

    def restore(self, path: str) -> Optional[dict]:
        """All-or-nothing across waves: the snapshot's wave count must
        match this pool exactly BEFORE any wave is mutated — restoring a
        3-wave snapshot into a 2-wave pool would silently drop wave 2's
        calls, and a partial per-wave restore would leave the pool half
        old, half new (each wave's own restore is atomic; the pool must
        be too)."""
        import os

        for w in range(len(self.servers)):
            if not os.path.exists(f"{path}.w{w}.npz"):
                raise ValueError(
                    f"pool snapshot {path!r} is missing wave {w} "
                    f"(pool has {len(self.servers)} waves)")
            # Header-only peek: catch per-wave capacity mismatches before
            # any wave mutates (each wave's restore re-validates fully).
            extra = checkpoint.peek_extra(f"{path}.w{w}")
            nslots = len(extra.get("slots", ()))
            if nslots != self.wave_capacity:
                raise ValueError(
                    f"pool snapshot wave {w} capacity {nslots} != wave "
                    f"capacity {self.wave_capacity}")
        if os.path.exists(f"{path}.w{len(self.servers)}.npz"):
            raise ValueError(
                f"pool snapshot {path!r} has more waves than this pool's "
                f"{len(self.servers)} — its extra streams would be "
                f"silently dropped")
        # The header peeks above catch shape mismatches, but a wave can
        # still fail mid-loop on deeper problems (wrong snapshot kind,
        # bitrate over this engine's cap, corrupt arrays).  Snapshot every
        # wave's mutable host state first and roll back on any failure so
        # the pool is never left half restored.
        fields = ("_state", "_slots", "_by_id", "_gen", "_active_cache",
                  "_seed", "bad_packets", "_last_comfort", "inactive_drops",
                  "_bits", "_nq")
        saved = [{f: getattr(srv, f) for f in fields if hasattr(srv, f)}
                 for srv in self.servers]
        try:
            transport = None
            for w, s in enumerate(self.servers):
                tr = s.restore(f"{path}.w{w}")
                if w == 0:
                    transport = tr
        except Exception:
            for srv, snap in zip(self.servers, saved):
                for f, v in snap.items():
                    setattr(srv, f, v)
            raise
        return transport
