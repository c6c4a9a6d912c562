"""N-way conference bridge: decode → per-room mix-minus-one → re-encode,
with PCM never leaving the device — the port of
lyra_tpu/tools/conference.py.

The reference ships the codec and leaves conferencing — the deployment
Lyra was built for — to the app layer (its Android demo is a one-way
loopback, reference: lyra/android_example/.../MainActivity.java:203-262).
This is the serving-side bridge (the MCU shape): each 20 ms tick,

  uplink packets ──► DecoderServer wire step (device unpack + decode,
                     PLC/CNG on gaps)
       [device PCM] ─► per-room mix-minus-one (int32 accumulate,
                     int16 saturation — reference: lyra/dsp_utils.h:53-120
                     clipping semantics)
       [device PCM] ─► EncoderServer wire step (device encode + pack)
                 ──► per-participant downlink packets

All three stages are device programs chained on device tensors, each
one CUDA-graph replay on the card (utils/capture.py): the decoder's and
the encoder's wire programs in their servers' graph caches, the mixer in
the bridge's own.  The host touches only packet bytes (~64 B/stream each
way), never PCM (~640 B/stream each way) — a 10x smaller host boundary
than composing the servers through their public PCM ticks.  Where the
engines run eagerly (the CPU) the same programs run eagerly, bit for bit
the same.

Mixing policy: a participant's downlink is the sum of every *other*
participant in their room.  Comfort-noise hops (uplink DTX'd or long-lost,
`LyraDecoder::is_comfort_noise`, reference: lyra/lyra_decoder.h:86-94) are
excluded from the room sum — CN is receiver-side filler, and mixing N
participants' CN would stack noise floors; PLC concealment hops (the
first 0.08 s of a gap, still a speech estimate) ARE mixed.  Sums
accumulate in int32 (always exact, so the order of the device's atomic
adds cannot change a bit) and saturate to int16 like the reference's
ClipToInt16.

Over ShardedEngines (parallel/sharding.py) the mixer runs shard-locally:
one mixer program per shard over its own rows, in that shard's graph
cache, with no cross-shard sum (the JAX bridge's `shard_map` mixer).
That is right only while no room straddles a shard, so the bridge checks
it at every admission-table rebuild, and `shard_affine_slots` places
rooms inside shards.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from lyra_tpu_torch import config
from lyra_tpu_torch.parallel.sharding import shard_batch_tree
from lyra_tpu_torch.tools.stream_server import (
    DecoderServer,
    EncoderServer,
    _active_mask,
    _HostIO,
    _launch,
    _no_inflight_tick,
)
from lyra_tpu_torch.utils import checkpoint


def _mix_body(capacity: int):
    """The device mixer as a program of the bridge's graph cache:
    `body(state, pcm, exclude, rooms, active) -> (mix, state)` over an
    empty state tree.  On a sharded bridge it runs per shard over that
    shard's rows; room ids stay global dense ints (< capacity), so each
    shard's segment table is over-provisioned rather than re-indexed."""

    def body(state, pcm, exclude, rooms, active):
        # pcm rows are integral int16-scale (engine clip_to_int16), so the
        # int32 cast is exact whether the engine emits int16 or float;
        # int32 accumulation is exact for any room size.
        rooms = rooms.long()
        contrib = active.bool() & ~exclude.bool()
        x = torch.where(contrib[:, None], pcm.to(torch.int32), 0)
        sums = torch.zeros((capacity, pcm.shape[1]), dtype=torch.int32,
                           device=pcm.device)
        sums.index_add_(0, rooms, x)
        mix = sums[rooms] - x
        return mix.clamp(-32768, 32767).to(torch.int16), state

    return body


def mix_minus_one_np(pcm: np.ndarray, rooms: np.ndarray,
                     contrib: np.ndarray, num_rooms: int) -> np.ndarray:
    """Host oracle for the device mixer: bit-exact twin (int32 accumulate,
    int16 saturation).  `contrib` rows are summed; every row gets its
    room's sum minus its own contribution."""
    pcm = np.asarray(pcm)
    x = np.where(np.asarray(contrib, bool)[:, None],
                 pcm.astype(np.int32), 0)
    sums = np.zeros((num_rooms, pcm.shape[1]), np.int32)
    np.add.at(sums, np.asarray(rooms), x)
    mix = sums[np.asarray(rooms)] - x
    return np.clip(mix, -32768, 32767).astype(np.int16)


class ConferenceBridge:
    """Fixed-capacity batched conference bridge with per-room admission.

    Wraps a DecoderServer (uplink) and an EncoderServer (downlink) of the
    same capacity with mirrored slot assignment; participants are admitted
    into named rooms and each hears their room minus themselves.  The
    public tick is packets-in → packets-out (`tick_wire`); per-participant
    downlink bitrates mix freely (reference: lyra/lyra_encoder.h:44-101
    set_bitrate), and uplink packets carry their bitrate in their size
    (reference: lyra/lyra_config.h:99 PacketSizeToNumQuantizedBits).
    """

    def __init__(self, capacity: int,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 bitrate: int = 3200,
                 sample_rate_hz: Optional[int] = None,
                 seed: int = 0,
                 dec_engine=None, enc_engine=None, *, device=None):
        self._dec = DecoderServer(capacity, engine=dec_engine,
                                  model_path=model_path, seed=seed,
                                  sample_rate_hz=sample_rate_hz,
                                  device=device)
        self._enc = EncoderServer(capacity, engine=enc_engine,
                                  model_path=model_path, bitrate=bitrate,
                                  sample_rate_hz=sample_rate_hz,
                                  device=device)
        if self._enc.sample_rate_hz != self._dec.sample_rate_hz:
            raise ValueError(
                f"uplink decodes at {self._dec.sample_rate_hz} Hz but the "
                f"downlink encodes at {self._enc.sample_rate_hz} Hz — a "
                "bridge mixes at one rate")
        if self._enc.engine.device != self._dec.engine.device:
            raise ValueError(
                f"uplink runs on {self._dec.engine.device} but the downlink "
                f"on {self._enc.engine.device} — a bridge keeps its PCM on "
                "one device")
        # Multi-device: when the servers run ShardedEngines the mixer runs
        # shard-local (no cross-shard sum), which requires room-affine
        # placement — see shard_affine_slots / _check_rooms_shard_local.
        self._mesh = getattr(self._dec.engine, "mesh", None)
        enc_mesh = getattr(self._enc.engine, "mesh", None)
        if (self._mesh is None) != (enc_mesh is None) or (
                self._mesh is not None and enc_mesh != self._mesh):
            raise ValueError(
                "bridge servers must share one mesh: decoder engine mesh is "
                f"{self._mesh}, encoder engine mesh is {enc_mesh}")
        if self._mesh is not None and capacity % self._mesh.devices.size:
            raise ValueError(
                f"capacity {capacity} must divide evenly over the "
                f"{self._mesh.devices.size}-device mesh")
        self.capacity = capacity
        self.sample_rate_hz = self._dec.sample_rate_hz
        self.hop_samples = self._dec.hop_samples
        # slot → dense room index (stale values on inactive slots are
        # masked out of the sum by the active mask).
        self._rooms = np.zeros(capacity, np.int32)
        self._room_of: Dict[object, object] = {}   # stream id → room key
        self._room_ids: Dict[object, int] = {}     # room key → dense index
        self._room_refs: Dict[object, int] = {}
        self._free_rids: list = []
        self._next_rid = 0
        self._dev_cache = None  # (active, rooms) device tensors
        self._pending_async = None  # in-flight tick_wire_async submit
        # The mixer's graph cache, one per shard on a mesh (None where the
        # engines run eagerly).
        self._graphs = self._dec.engine.own_graphs()
        self._mixer = _mix_body(capacity)

    # -- admission ---------------------------------------------------------

    @property
    def num_active(self) -> int:
        return self._dec.num_active

    @property
    def bad_packets(self) -> np.ndarray:
        """Per-slot malformed-uplink-packet counters (counted drops)."""
        return self._dec.bad_packets

    def room_of(self, stream_id) -> object:
        return self._room_of[stream_id]

    def is_comfort_noise(self, stream_id) -> bool:
        """Whether the participant's *uplink* played comfort noise last
        tick (their contribution was excluded from the mix)."""
        return self._dec.is_comfort_noise(stream_id)

    def _room_enter(self, room) -> int:
        rid = self._room_ids.get(room)
        if rid is None:
            if self._free_rids:
                rid = self._free_rids.pop()
            else:
                rid = self._next_rid
                self._next_rid += 1
            self._room_ids[room] = rid
            self._room_refs[room] = 0
        self._room_refs[room] += 1
        return rid

    def _room_leave(self, room) -> None:
        self._room_refs[room] -= 1
        if self._room_refs[room] == 0:
            self._free_rids.append(self._room_ids.pop(room))
            del self._room_refs[room]

    def add_participant(self, stream_id, room,
                        bitrate: Optional[int] = None,
                        slot: Optional[int] = None) -> int:
        """Admit a participant into `room`; returns their slot (the wire
        header identity on both directions).  `slot` directs placement —
        e.g. shard-affine room packing (`shard_affine_slots`) so a room
        never straddles a mesh shard boundary."""
        slot = self._dec.add_stream(stream_id, slot=slot)
        try:
            slot_e = self._enc.add_stream(stream_id, bitrate=bitrate,
                                          slot=slot)
        except Exception:
            self._dec.remove_stream(stream_id)
            raise
        if slot != slot_e:
            raise RuntimeError("bridge slot tables diverged")
        # Room allocation AFTER both admissions succeed: live rooms can
        # then never exceed live participants, so dense ids stay
        # < capacity (the mixer's static segment count).
        self._rooms[slot] = self._room_enter(room)
        self._room_of[stream_id] = room
        self._dev_cache = None
        return slot

    def add_participants(self, rooms_by_id: Dict[object, object],
                         bitrate: Optional[int] = None,
                         slots: Optional[Dict[object, int]] = None
                         ) -> Dict[object, int]:
        """Bulk admission (one masked state reset per server — use this for
        call-setup bursts, see DecoderServer.add_streams).  `slots` directs
        placement per participant (see `shard_affine_slots`)."""
        ids = list(rooms_by_id)
        slots = self._dec.add_streams(ids, slots=slots)
        try:
            slots_e = self._enc.add_streams(ids, bitrate=bitrate,
                                            slots=slots)
        except Exception:
            for sid in ids:
                self._dec.remove_stream(sid)
            raise
        if slots != slots_e:
            raise RuntimeError("bridge slot tables diverged")
        for sid, slot in slots.items():
            self._rooms[slot] = self._room_enter(rooms_by_id[sid])
            self._room_of[sid] = rooms_by_id[sid]
        self._dev_cache = None
        return slots

    @property
    def num_shards(self) -> int:
        """Mesh shards the slot axis splits into (1 when unsharded)."""
        return 1 if self._mesh is None else int(self._mesh.devices.size)

    def shard_affine_slots(self, rooms_by_id: Dict[object, object],
                           num_shards: Optional[int] = None
                           ) -> Dict[object, int]:
        """Directed-slot placement keeping every room inside one mesh shard.

        The slot axis shards contiguously over the mesh (slot → shard is
        `slot // (capacity // num_shards)`, parallel/sharding.py
        batch_sharding), so a room whose members share a shard is mixed
        entirely from shard-local rows — the invariant the shard-local
        mixer requires.  Rooms with sitting members are pinned to their
        shard; new rooms are placed largest-first into the emptiest shard.
        All-or-nothing: raises without touching any state if a room cannot
        fit inside a single shard (capacity fragmentation is the caller's
        signal to spill the room to another bridge).  Feed the result to
        `add_participants(..., slots=...)`."""
        n = self.num_shards if num_shards is None else int(num_shards)
        if self.capacity % n:
            raise ValueError(
                f"capacity {self.capacity} must divide over {n} shards")
        per = self.capacity // n
        free = [[] for _ in range(n)]
        for i, s in enumerate(self._dec._slots):
            if not s.active:
                free[i // per].append(i)
        pin: Dict[object, int] = {}
        for sid, slot in self._dec._by_id.items():
            room = self._room_of[sid]
            sh = slot // per
            if pin.setdefault(room, sh) != sh:
                raise ValueError(
                    f"room {room!r} already straddles shards "
                    f"{pin[room]} and {sh}")
        groups: Dict[object, list] = {}
        for sid, room in rooms_by_id.items():
            groups.setdefault(room, []).append(sid)
        out: Dict[object, int] = {}

        def place(room, members, sh):
            if len(free[sh]) < len(members):
                raise RuntimeError(
                    f"room {room!r}: {len(members)} joiners do not fit in "
                    f"shard {sh} ({len(free[sh])} free seats)")
            for sid in members:
                out[sid] = free[sh].pop(0)

        for room, members in groups.items():
            if room in pin:
                place(room, members, pin[room])
        fresh = sorted((r for r in groups if r not in pin),
                       key=lambda r: -len(groups[r]))
        for room in fresh:
            sh = max(range(n), key=lambda s: len(free[s]))
            place(room, groups[room], sh)
        return out

    def _check_rooms_shard_local(self) -> None:
        """Fail loudly if any room's sitting members straddle a shard
        boundary — the shard-local mixer would silently mis-mix them."""
        per = self.capacity // self.num_shards
        shard_of: Dict[object, int] = {}
        for sid, slot in self._dec._by_id.items():
            room = self._room_of[sid]
            sh = slot // per
            if shard_of.setdefault(room, sh) != sh:
                raise ValueError(
                    f"room {room!r} straddles mesh shards {shard_of[room]} "
                    f"and {sh}; admit with slots=shard_affine_slots(...) so "
                    "the shard-local mixer stays correct")

    def remove_participant(self, stream_id) -> None:
        self._dec.remove_stream(stream_id)
        self._enc.remove_stream(stream_id)
        self._room_leave(self._room_of.pop(stream_id))
        self._dev_cache = None

    def set_bitrate(self, stream_id, bitrate: int) -> None:
        """Per-participant dynamic *downlink* bitrate."""
        self._enc.set_bitrate(stream_id, bitrate)

    # -- the tick ----------------------------------------------------------

    def _dev_tables(self):
        if self._dev_cache is None:
            tables = (torch.from_numpy(_active_mask(self._dec).copy()),
                      torch.from_numpy(self._rooms.copy()))
            if self._mesh is not None:
                self._check_rooms_shard_local()
                self._dev_cache = tuple(shard_batch_tree(t, self._mesh)
                                        for t in tables)
            else:
                dev = self._dec.engine.device
                self._dev_cache = tuple(t.to(dev) for t in tables)
        return self._dev_cache

    def tick_wire(self, packets: np.ndarray, received: np.ndarray,
                  sizes: Optional[np.ndarray] = None):
        """One 20 ms bridge tick: uplink wire packets in, downlink wire
        packets out — (wire [capacity, max_size] uint8, sizes [capacity]
        int32), the exact EncoderServer.tick_wire contract (sizes 0 on
        inactive slots).  Uplink arguments are DecoderServer.tick_wire's
        (pass `sizes` for mixed-bitrate uplinks; malformed packets are
        counted drops, never exceptions out of the tick)."""
        if self._pending_async is not None:
            raise RuntimeError(
                "bridge async pipeline in flight; flush_async() first")
        _no_inflight_tick(self._dec, "a bridge tick")
        _no_inflight_tick(self._enc, "a bridge tick")
        enc_pending, cn = self._submit(packets, received, sizes)
        out = self._enc._drain_wire(enc_pending)
        self._dec._last_comfort = _HostIO.result(cn)[0]
        return out

    def _submit(self, packets, received, sizes):
        """Run the three chained device programs (decode, mix, encode +
        pack); → (the encoder's pending wire tick, the fetch of the
        decoder's comfort-noise flags).  The decoded PCM and the mix stay
        on the device."""
        dec = self._dec
        (k, (pcm, is_cn)), _ = dec._wire_run(packets, received, sizes,
                                             submit=_launch)
        cn = dec._io.fetch(k, [is_cn])
        active, rooms = self._dev_tables()
        mix, _ = dec.engine._run(self._mixer, ("mix", self.capacity), {},
                                 pcm, is_cn, rooms, active,
                                 graphs=self._graphs)
        return self._enc._wire_submit(mix), cn

    def tick_wire_async(self, packets: np.ndarray, received: np.ndarray,
                        sizes: Optional[np.ndarray] = None):
        """Pipelined tick_wire: submit this tick's uplink, return the
        *previous* tick's downlink (None on the first call).  One tick
        (20 ms) of added latency buys overlap of device compute, D2H
        transfer, and host packet IO — the same contract as the servers'
        `*_async` ticks.  A slot that changed hands between submit and
        drain emits size 0 downlink and drops its stale CN flag; room and
        bitrate changes apply from the next submitted tick."""
        _no_inflight_tick(self._dec, "a bridge tick")
        _no_inflight_tick(self._enc, "a bridge tick")
        enc_pending, cn = self._submit(packets, received, sizes)
        pending = self._pending_async
        self._pending_async = (enc_pending, cn, self._dec._gen.copy())
        if pending is None:
            return None
        return self._drain(pending)

    def _drain(self, pending):
        enc_pending, cn, gen_d = pending
        out = self._enc._drain_wire(enc_pending)
        stale = gen_d != self._dec._gen  # see DecoderServer._drain
        self._dec._last_comfort = _HostIO.result(cn)[0] & ~stale
        return out

    def flush_async(self):
        """Drain the last in-flight async tick (None if nothing is)."""
        pending = self._pending_async
        self._pending_async = None
        if pending is None:
            return None
        return self._drain(pending)

    # -- snapshots ---------------------------------------------------------

    def save(self, path: str, transport: dict | None = None) -> None:
        """Drain-for-maintenance snapshot: both servers + the room table
        (`path` + .dec/.enc/.rooms.json).  Restore with
        ConferenceBridge.restore on a bridge of the same capacity (either
        package's, in float mode); calls continue mid-call (see
        DecoderServer.save).  The opaque serving-layer `transport` dict
        rides the .dec snapshot (the uplink jitter buffer pairs with the
        decode side)."""
        if self._pending_async is not None:
            raise RuntimeError(
                "bridge async pipeline in flight; flush_async() before save")
        self._dec.save(path + ".dec", transport)
        self._enc.save(path + ".enc")
        with open(path + ".rooms.json", "w") as f:
            # Pairs, not an object: JSON object keys would stringify int
            # stream ids.  Room keys obey the same JSON-scalar rule as
            # stream ids (stream_server.py _server_save).
            json.dump({"room_of": [[sid, room] for sid, room
                                   in self._room_of.items()]}, f)

    def restore(self, path: str) -> dict | None:
        """All-or-nothing: every cross-snapshot consistency check runs
        before either server is mutated."""
        if self._pending_async is not None:
            raise RuntimeError(
                "bridge async pipeline in flight; flush_async() before "
                "restore")
        with open(path + ".rooms.json") as f:
            room_of = {sid: room for sid, room in json.load(f)["room_of"]}
        dex = checkpoint.peek_extra(path + ".dec")
        eex = checkpoint.peek_extra(path + ".enc")
        d_slots = [tuple(s) for s in dex.get("slots", [])]
        e_slots = [tuple(s) for s in eex.get("slots", [])]
        if d_slots != e_slots:
            raise ValueError(
                "snapshot pair is inconsistent: decoder and encoder slot "
                "tables differ")
        for name, ex in (("decoder", dex), ("encoder", eex)):
            snap_rate = ex.get("sample_rate_hz", config.INTERNAL_SAMPLE_RATE)
            if snap_rate != self.sample_rate_hz:
                raise ValueError(
                    f"{name} snapshot is a {snap_rate} Hz fleet; this "
                    f"bridge runs at {self.sample_rate_hz} Hz")
        missing = [sid for sid, active in d_slots
                   if active and sid not in room_of]
        if missing:
            raise ValueError(
                f"snapshot rooms table is missing streams {missing!r}")
        transport = self._dec.restore(path + ".dec")
        self._enc.restore(path + ".enc")
        # Rebuild the room bookkeeping from scratch; dense ids need not
        # match the pre-save ones (the mix is invariant to relabeling).
        self._rooms = np.zeros(self.capacity, np.int32)
        self._room_of = {}
        self._room_ids = {}
        self._room_refs = {}
        self._free_rids = []
        self._next_rid = 0
        for slot, (sid, active) in enumerate(d_slots):
            if active:
                self._rooms[slot] = self._room_enter(room_of[sid])
                self._room_of[sid] = room_of[sid]
        self._dev_cache = None
        return transport
