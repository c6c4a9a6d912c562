"""Fleet composition: admission routing and drain/migrate across serving
hosts — the port of lyra_tpu/tools/fleet.py, a whole copy of it (only
this docstring and the package name in the imports differ; no torch is
imported here: it is the control client and the router).

Every serving host (a `python -m lyra_tpu_torch.tools.serve_main`
process on one card) carries an independent batch of streams, so a fleet
is composed with *routing*, not collectives.  This module is the
host-side control plane for that composition:

- `HostControl` — client for serve_main's --control UDP JSON endpoint
  (ping / stats / save / restore / drain / set_bitrate / quit).  UDP with
  retries and a request token, so a lost datagram surfaces as a retry,
  not a hang; with a key every request is signed (tools/control_auth.py).
- `FleetRouter` — slot admission across hosts (a caller asks the fleet
  for a seat and gets back (host, data address, slot); the wire header's
  slot field is the stream identity), plus whole-host maintenance
  migration: drain host A to a snapshot and resume its calls on a warm
  standby B without the callers doing anything but re-aiming their
  datagrams, and crash failover from A's last periodic snapshot.
- `FleetJournal` — the router's append-only routing journal, so a
  restarted controller resumes its seats (one format with the JAX
  package: either package replays the other's journal).
- `StatsSink` — the operator's JSON-lines stats exit of serve_main and
  fleet_main.

The runnable composition root is `tools/fleet_main.py` (admission
service + failure watchdog); exercised end to end by
`lyra_tpu_torch/examples/multihost_migrate.py` and
tests/test_torch_fleet.py.
"""

from __future__ import annotations

import heapq
import hmac
import itertools
import json
import os
import socket
import threading
from typing import Dict, Optional, Tuple

from lyra_tpu_torch.tools.control_auth import sign as _sign


class ControlError(RuntimeError):
    """A control command was answered with ok=false (the host keeps
    serving its previous state; restore validates before mutating)."""


class StatsSink:
    """Operator-facing stats exit (--stats PATH): one JSON object per
    line, appended at every report interval plus a final record
    (``"final": true``) at shutdown.  The human status line on stdout and
    this sink consume the same snapshot dict, so they can never disagree.
    Shared by serve_main (host tier) and fleet_main (fleet tier); the
    reference has no serving tier to instrument — this is the
    deployment-grade counterpart of its benchmark CSV exit
    (reference: lyra/lyra_benchmark_lib.cc:164-197 output path)."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a", buffering=1) if path else None

    def emit(self, snapshot: dict) -> None:
        if self._f is not None:
            self._f.write(json.dumps(snapshot) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class FleetJournal:
    """Append-only routing-state journal: one JSON record per mutation.

    The fleet controller's seat table, standby set, and room homes must
    survive a controller crash — round 4 made hosts replaceable, which
    makes the controller the last single point of failure (its amnesia
    orphans every locate/failover).  Every FleetRouter mutation appends
    one line here (line-buffered; a process crash loses at most the
    OS-buffer tail, the same durability class as the host snapshots), and
    a restarted controller rebuilds its router with `FleetRouter.replay`.

    Compaction: when the journal exceeds `compact_every` records it is
    rewritten as a single full-state record via the same tmp+rename
    discipline as utils/checkpoint.py, so the file stays O(fleet size),
    not O(call history).

    The reference's only recovery mechanism is its weights/version gate
    (reference: lyra/lyra_config.h:131-167); this is the fleet tier's
    equivalent for routing state.
    """

    def __init__(self, path: str, compact_every: int = 20000):
        self.path = path
        self._compact_every = compact_every
        # Repair a torn tail BEFORE appending: a crash mid-write leaves a
        # partial final line with no newline, and appending onto it would
        # corrupt the next record too (replay tolerates a torn tail, but
        # only as the final line).
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                back = min(size, 1 << 20)
                f.seek(size - back)
                data = f.read()
                if not data.endswith(b"\n"):
                    f.truncate(size - back + data.rfind(b"\n") + 1)
        self._f = open(path, "a", buffering=1)
        # Existing records count toward the compaction threshold: a
        # controller restarted on a huge journal compacts on the first
        # mutation instead of doubling the file first.
        self._n = sum(1 for _ in open(path)) if os.path.getsize(path) else 0

    def append(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._n += 1

    def should_compact(self) -> bool:
        return self._n >= self._compact_every

    def compact(self, state_record: dict) -> None:
        """Atomically replace the journal with one full-state record."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(state_record) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f.close()
        self._f = open(self.path, "a", buffering=1)
        self._n = 1

    def close(self) -> None:
        self._f.close()


class HostControl:
    """Client for one serving host's --control endpoint.

    Every request carries a fresh "req" token; replies are matched on it,
    so a stale reply from a retried earlier request can never be taken
    for the current one.  `timeout` is per attempt; `retries` attempts
    total.  Requests are idempotent by design (save/restore overwrite,
    drain of a stopped host times out) — safe to retry on a silent UDP
    loss.  Thread-safe: one request at a time per instance (a watchdog
    probing off-thread must not steal the reply to an admission-thread
    command riding the same socket).

    With `key` (the shared management HMAC key, tools/control_auth.py)
    every request is signed ONCE — retries resend the identical bytes,
    which the far side's replay rule accepts as the same request — for
    hosts running `serve_main --control_key` on a routable bind."""

    _req_counter = itertools.count(1)

    def __init__(self, addr: Tuple[str, int], timeout: float = 2.0,
                 retries: int = 5, key: Optional[bytes] = None):
        self.addr = addr
        self._key = key
        self._timeout = timeout
        self._retries = retries
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # connect() the UDP socket: ICMP port-unreachable then surfaces as
        # ConnectionRefusedError on the next send/recv instead of a silent
        # timeout — a crashed host is detected in microseconds, not
        # retries*timeout (measured: failover cutover 1.25 s -> ~0.15 s).
        self._sock.connect(addr)
        self._sock.settimeout(timeout)

    def request(self, cmd: str, _timeout: Optional[float] = None,
                _retries: Optional[int] = None, **fields) -> dict:
        """Send {"cmd": cmd, **fields}; return the matched ok reply.
        Raises ControlError on ok=false, socket.timeout when the host
        never answers (e.g. already drained).  _timeout/_retries override
        the instance defaults for this one request (failure detection
        wants a short probe, not the admin-command patience)."""
        req = f"r{next(self._req_counter)}"
        body = {"cmd": cmd, "req": req, **fields}
        if self._key is not None:
            # Audience = the address this client dials: the far verifier
            # refuses a captured datagram replayed at any OTHER host
            # sharing the key (control_auth.py docstring).
            body["aud"] = f"{self.addr[0]}:{self.addr[1]}"
            body = _sign(body, self._key)
        msg = json.dumps(body).encode()
        retries = self._retries if _retries is None else _retries
        last_exc: Optional[Exception] = None
        with self._lock:
            if _timeout is not None:
                self._sock.settimeout(_timeout)
            try:
                for _ in range(retries):
                    self._sock.send(msg)
                    try:
                        while True:
                            data = self._sock.recv(64 * 1024)
                            try:
                                reply = json.loads(data.decode())
                            except (ValueError, UnicodeDecodeError):
                                continue  # garbage datagram: not our reply
                            if not isinstance(reply, dict):
                                continue  # hostile/foreign sender on the
                                # port (e.g. a reused port after a crash):
                                # a counted non-reply, never an exception
                                # out of the control client
                            if reply.get("req") != req:
                                continue  # stale reply to an earlier retry
                            if not reply.get("ok"):
                                raise ControlError(
                                    f"{cmd} @ {self.addr}: "
                                    f"{reply.get('error')}")
                            return reply
                    except socket.timeout as e:
                        last_exc = e
            finally:
                if _timeout is not None:
                    self._sock.settimeout(self._timeout)
        raise socket.timeout(
            f"no reply to {cmd!r} from {self.addr} after "
            f"{retries} attempts") from last_exc

    def ping(self) -> dict:
        return self.request("ping")

    def stats(self) -> dict:
        return self.request("stats")["stats"]

    def save(self, path: str) -> dict:
        return self.request("save", path=path)

    def restore(self, path: str) -> dict:
        return self.request("restore", path=path)

    def drain(self, path: str) -> dict:
        """Snapshot, then the host stops serving (its process exits the
        serve loop).  The reply arrives before the stop."""
        return self.request("drain", path=path)

    def set_bitrate(self, slot: int, bitrate: int) -> dict:
        """Per-stream mid-call downlink bitrate (encode/bridge hosts;
        reference: lyra/lyra_encoder.cc:158-166 set_bitrate).  Idempotent,
        so UDP-retry safe like the rest of the verbs."""
        return self.request("set_bitrate", slot=slot, bitrate=bitrate)

    def quit(self) -> dict:
        return self.request("quit")

    def wait_ready(self, deadline_s: float = 120.0) -> dict:
        """Poll ping until the host's serve loop answers (engine
        construction and first-tick compile happen before the loop starts
        handling control traffic)."""
        import time

        t_end = time.monotonic() + deadline_s
        while True:
            try:
                return self.ping()
            except ConnectionRefusedError:
                # Control socket not bound yet (engine construction
                # precedes it); a refused probe costs microseconds.
                time.sleep(0.2)
                if time.monotonic() >= t_end:
                    raise socket.timeout(
                        f"host {self.addr} not ready within {deadline_s}s")
            except socket.timeout:
                if time.monotonic() >= t_end:
                    raise socket.timeout(
                        f"host {self.addr} not ready within {deadline_s}s")

    def close(self) -> None:
        self._sock.close()


class _Host:
    def __init__(self, data_addr, control: HostControl, capacity: int,
                 standby: bool, room_size: Optional[int] = None):
        self.data_addr = data_addr
        self.control = control
        self.capacity = capacity
        self.standby = standby
        self.room_size = room_size  # bridge hosts: room = slot // size
        self.slots: Dict[int, object] = {}  # slot -> stream_id
        # Lowest-free-slot allocator state (alloc_slot): a min-heap of
        # released slots + a high-water mark.  Amortized O(1) per admit —
        # the naive per-admit range scan is O(capacity), which measured
        # ~1 ms/admit at 16k-class capacities (a quadratic admission
        # storm on a cold-started big host).  Slots occupied OUTSIDE the
        # allocator (positional handoffs, journal replay) are discovered
        # lazily by the occupied check in alloc_slot.
        self._free_heap: list = []
        self._fresh = 0  # slots >= this were never allocated here
        # A handoff (migrate/failover) is in flight: admission and
        # remove_host refuse until commit/abort clears it, so the
        # blocking RPC phase of a two-phase handoff can run outside the
        # fleet lock without the tables shifting under it.
        self.busy = False

    @property
    def free(self) -> int:
        return self.capacity - len(self.slots)

    def alloc_slot(self) -> int:
        """The LOWEST free slot (the admission contract: freed seats are
        reused densely).  Every free slot below _fresh is in the heap
        (release pushes it) or gets skipped-and-advanced here; entries
        may be stale (re-occupied via a positional handoff) — the
        occupied check drops them.  Caller guarantees free > 0."""
        while True:
            if self._free_heap and (self._fresh >= self.capacity
                                    or self._free_heap[0] < self._fresh):
                slot = heapq.heappop(self._free_heap)
            elif self._fresh < self.capacity:
                slot = self._fresh
                self._fresh += 1
            else:  # impossible under the reset discipline; fail loudly
                raise RuntimeError(
                    "alloc_slot invariant broken: free > 0 but no "
                    "candidate below capacity")
            if slot not in self.slots:
                return slot

    def give_back(self, slot: int) -> None:
        # Bridge (room) hosts never allocate through the heap (room
        # admission is positional within a block), so banking their
        # releases would only grow the heap with call history.
        if self.room_size is None:
            heapq.heappush(self._free_heap, slot)

    def reset_alloc(self) -> None:
        """Re-arm the allocator after a BULK slot change (a positional
        handoff filling/emptying this host outside alloc_slot/give_back).
        (_fresh=0, empty heap) is always sound: alloc_slot rediscovers
        occupied slots lazily, amortized O(1) per admission."""
        self._free_heap = []
        self._fresh = 0

    def free_block(self) -> Optional[int]:
        """First room block with no occupant, or None (bridge hosts)."""
        used = {s // self.room_size for s in self.slots}
        return next((b for b in range(self.capacity // self.room_size)
                     if b not in used), None)


class FleetRouter:
    """Admission routing over independent serving hosts.

    Placement is least-loaded-first (ties broken by registration order):
    each admitted stream gets (host_name, data_addr, slot) and the caller
    aims its uplink datagrams there with that slot in the wire header.
    The router is pure bookkeeping — the hosts admit every slot at
    startup (serve_main), so no control traffic is needed per call; the
    router's job is to hand out non-colliding seats and to know where
    everyone lives when a host must drain.
    """

    def __init__(self, journal: Optional[FleetJournal] = None):
        self._hosts: Dict[str, _Host] = {}
        self._streams: Dict[object, Tuple[str, int]] = {}
        self._rooms: Dict[object, Tuple[str, int]] = {}  # room -> (host, block)
        self._room_of: Dict[object, object] = {}  # stream -> room
        # Seat capability tokens (caller-chosen at admit): a seat admitted
        # with a token requires it for locate/release — admission is
        # unauthenticated by design, so without this, anyone reachable
        # could tear down or trace any guessable stream id.  None = the
        # legacy open contract (token-less callers keep working).
        self._token: Dict[object, Optional[str]] = {}
        # Crash tolerance: every mutation below appends one record here
        # (see FleetJournal); a restarted controller rebuilds with replay().
        self._journal = journal

    def _log(self, **record) -> None:
        if self._journal is None:
            return
        self._journal.append(record)
        if self._journal.should_compact():
            self._journal.compact(self._state_record())

    def _state_record(self) -> dict:
        """Full routing state as one journal record (compaction target and
        replay seed).  Slot keys are ints, so slot tables serialize as
        [slot, stream] pairs (JSON objects can't carry int keys)."""
        return {
            "op": "state",
            "hosts": [
                {"name": n, "data_addr": list(h.data_addr),
                 "ctl_addr": list(h.control.addr), "capacity": h.capacity,
                 "standby": h.standby, "room_size": h.room_size,
                 "busy": h.busy,
                 "slots": [[s, sid] for s, sid in h.slots.items()]}
                for n, h in self._hosts.items()],
            "rooms": [[room, name, block]
                      for room, (name, block) in self._rooms.items()],
            "room_of": [[sid, room] for sid, room in self._room_of.items()],
            "tokens": [[sid, tok] for sid, tok in self._token.items()
                       if tok is not None],
        }

    @classmethod
    def replay(cls, path: str, journal: Optional[FleetJournal] = None,
               control_factory=None) -> Tuple["FleetRouter", list]:
        """Rebuild a router from a journal written by a previous controller
        (crash recovery).  Returns (router, open_hosts): hosts whose
        handoff was in flight when the controller died are un-reserved in
        the rebuilt tables (busy cleared) and returned for the caller to
        log — the watchdog re-judges them on its next sweep (a drained-
        but-unrestored source probes dead and fails over from its periodic
        snapshot; a completed-but-uncommitted restore is re-restored,
        costing one PLC-concealed transient).

        `journal` (usually a FleetJournal on the same path) is attached to
        the rebuilt router AFTER replay so replaying never re-journals.
        `control_factory(addr) -> HostControl` exists for tests."""
        make_ctl = control_factory if control_factory is not None else (
            lambda addr: HostControl(addr))
        router = cls()
        with open(path) as f:
            lines = [ln.strip() for ln in f]
        records = []
        for i, line in enumerate(lines):
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    # A torn FINAL line is the expected signature of the
                    # crash this journal exists to survive (power loss /
                    # kill mid-append): at most the OS-buffer tail is
                    # lost, as documented.  A torn line ANYWHERE ELSE is
                    # real corruption and stays a loud refusal.
                    break
                raise ValueError(
                    f"journal {path} is corrupt at line {i + 1} (not the "
                    f"final line — not a torn-tail crash artifact)")
        for rec in records:
            router._apply(rec, make_ctl)
        # Hosts left busy = a handoff was in flight when the controller
        # died.  Clear the marks (admission must not stay blocked on a
        # handoff whose controller is gone) and report them: the watchdog
        # re-judges those hosts on its next sweep.
        open_hosts = [n for n, h in router._hosts.items() if h.busy]
        for n in open_hosts:
            router._hosts[n].busy = False
        router._journal = journal
        return router, open_hosts

    def _apply(self, rec: dict, make_ctl) -> None:
        """Re-execute one journal record against the in-memory tables
        (no journaling, no control RPCs — replay is pure bookkeeping)."""
        op = rec["op"]
        if op == "state":
            for h in list(self._hosts.values()):
                h.control.close()
            self._hosts.clear()
            self._streams.clear()
            self._rooms.clear()
            self._room_of.clear()
            self._token.clear()
            for h in rec["hosts"]:
                host = _Host(tuple(h["data_addr"]),
                             make_ctl(tuple(h["ctl_addr"])),
                             h["capacity"], h["standby"], h["room_size"])
                host.busy = h["busy"]
                for slot, sid in h["slots"]:
                    host.slots[slot] = sid
                    self._streams[sid] = (h["name"], slot)
                self._hosts[h["name"]] = host
            for room, name, block in rec["rooms"]:
                self._rooms[room] = (name, block)
            for sid, room in rec["room_of"]:
                self._room_of[sid] = room
            for sid, tok in rec.get("tokens", []):
                self._token[sid] = tok
        elif op == "add_host":
            host = _Host(tuple(rec["data_addr"]),
                         make_ctl(tuple(rec["ctl_addr"])),
                         rec["capacity"], rec["standby"], rec["room_size"])
            self._hosts[rec["name"]] = host
        elif op == "remove_host":
            self._hosts.pop(rec["name"]).control.close()
        elif op == "admit":
            name, slot = rec["host"], rec["slot"]
            self._hosts[name].slots[slot] = rec["stream"]
            self._streams[rec["stream"]] = (name, slot)
            if rec.get("token") is not None:
                self._token[rec["stream"]] = rec["token"]
            if rec.get("room") is not None:
                self._room_of[rec["stream"]] = rec["room"]
                self._rooms[rec["room"]] = (
                    name, slot // self._hosts[name].room_size)
        elif op == "release":
            # Re-run the real release (it owns the last-member-out room
            # bookkeeping) — journaling is off during replay, and the
            # token check already passed when the record was written.
            self.release(rec["stream"], token=self._token.get(rec["stream"]))
        elif op == "begin_handoff":
            self._hosts[rec["src"]].busy = True
            self._hosts[rec["dst"]].busy = True
        elif op == "abort_handoff":
            self.abort_handoff(rec["src"], rec["dst"],
                               src_stopped=rec["src_stopped"])
        elif op == "commit_handoff":
            self.commit_handoff(rec["src"], rec["dst"],
                                deregister_src=rec["deregister_src"])
        else:
            raise ValueError(f"unknown journal record op {op!r}")

    def add_host(self, name: str, data_addr: Tuple[str, int],
                 control: HostControl, capacity: int,
                 standby: bool = False,
                 room_size: Optional[int] = None) -> None:
        """Register a host.  `standby` keeps it out of the admission pool
        (a warm spare, compiled and ticking, waiting to receive a drained
        host's snapshot); migrate() into it flips it active.

        `room_size` marks a BRIDGE host (serve_main --mode bridge): its
        slots tile into rooms of that many seats (room = slot //
        room_size, serve_main.py), and admission is room-directed —
        admit(stream, room=R) co-locates R's members in one block on one
        host, which the bridge's mixer geometry requires."""
        if name in self._hosts:
            raise KeyError(f"host {name!r} already registered")
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if room_size is not None and (
                room_size <= 0 or capacity % room_size):
            raise ValueError(
                f"room_size {room_size} must be positive and tile the "
                f"capacity {capacity} (the bridge refuses ragged rooms)")
        self._hosts[name] = _Host(data_addr, control, capacity, standby,
                                  room_size)
        if self._journal is not None:  # control.addr only exists on real
            # HostControls; journal-less routers accept any duck-typed one
            self._log(op="add_host", name=name, data_addr=list(data_addr),
                      ctl_addr=list(control.addr), capacity=capacity,
                      standby=standby, room_size=room_size)

    def remove_host(self, name: str) -> None:
        """Deregister a host; refuses while it still carries streams
        (drain or migrate them first — silently orphaning live calls is
        exactly the failure this tier exists to prevent) or while a
        handoff involving it is in flight.  Closes its control socket:
        deregistration releases the fd deterministically instead of at
        GC time (failover does the same for its dead src)."""
        host = self._hosts[name]
        if host.slots:
            raise RuntimeError(
                f"host {name!r} still carries {len(host.slots)} streams; "
                "migrate() or release() them first")
        if host.busy:
            raise RuntimeError(
                f"host {name!r} has a migration/failover in flight")
        host.control.close()
        del self._hosts[name]
        self._log(op="remove_host", name=name)

    def control(self, name: str) -> HostControl:
        """The host's control client (fleet_main's wait_ready needs it for
        hosts rebuilt by replay, which never pass through its own
        registration loop)."""
        return self._hosts[name].control

    def hosts(self) -> Dict[str, dict]:
        return {name: {"data_addr": h.data_addr, "capacity": h.capacity,
                       "occupied": len(h.slots), "standby": h.standby,
                       "busy": h.busy,
                       **({"room_size": h.room_size}
                          if h.room_size is not None else {})}
                for name, h in self._hosts.items()}

    def _check_token(self, stream_id, token) -> None:
        stored = self._token.get(stream_id)
        if stored is None:
            return
        # Constant-time compare: the token is a secret capability and
        # stream ids are guessable by design (the exact threat tokens
        # exist for) — a short-circuiting != would leak prefix length.
        if not isinstance(token, str) or not hmac.compare_digest(
                token.encode(), stored.encode()):
            raise PermissionError(
                f"seat token mismatch for stream {stream_id!r}")

    def admit(self, stream_id, room=None,
              token=None) -> Tuple[str, Tuple[str, int], int]:
        """Seat a stream on the least-loaded non-standby host; returns
        (host_name, data_addr, slot).  Raises when the fleet is full or
        the stream is already seated.

        With `room=R` (bridge fleets): R's members are co-located in one
        room block on one host — the first member claims the least-loaded
        bridge host's first free block, later members fill its remaining
        seats (a full room is a loud refusal, the fleet-level mirror of
        the bridge refusing ragged rooms).  Roomless admission never
        seats onto a bridge host (it would fragment a room block with a
        stream the mixer would treat as a roommate), and room admission
        needs a bridge host."""
        if stream_id in self._streams:
            raise KeyError(f"stream {stream_id!r} already admitted")
        if room is not None:
            name, host, slot = self._admit_room(room)
            self._room_of[stream_id] = room
        else:
            candidates = [h for h in self._hosts.items()
                          if h[1].free > 0 and not h[1].standby
                          and not h[1].busy and h[1].room_size is None]
            if not candidates:
                raise RuntimeError("fleet at capacity")
            name, host = min(candidates, key=lambda kv: len(kv[1].slots))
            slot = host.alloc_slot()
        host.slots[slot] = stream_id
        self._streams[stream_id] = (name, slot)
        self._token[stream_id] = token
        self._log(op="admit", stream=stream_id, host=name, slot=slot,
                  room=room, token=token)
        return name, host.data_addr, slot

    def _admit_room(self, room) -> Tuple[str, _Host, int]:
        if room in self._rooms:
            name, block = self._rooms[room]
            host = self._hosts[name]
            if host.busy:
                # The room's home has a handoff in flight: seating a new
                # member now would mutate the slot table mid-handoff and
                # aim the caller at a data address being drained.  Refuse
                # like every other admission path does on a busy host —
                # the caller retries, and after commit the room has been
                # re-homed to the destination.
                raise RuntimeError(
                    f"room {room!r} is on host {name!r} with a handoff "
                    "in flight; retry after it completes")
            rs = host.room_size
            slot = next((i for i in range(block * rs, (block + 1) * rs)
                         if i not in host.slots), None)
            if slot is None:
                raise RuntimeError(
                    f"room {room!r} is full ({rs} seats on {name!r})")
            return name, host, slot
        # Least-loaded-first, ties broken by REGISTRATION order (the
        # enumerate index) — the same contract as roomless admission.
        candidates = [(len(h.slots), idx, name, h, h.free_block())
                      for idx, (name, h) in enumerate(self._hosts.items())
                      if h.room_size is not None and not h.standby
                      and not h.busy]
        candidates = [c for c in candidates if c[4] is not None]
        if not candidates:
            raise RuntimeError(
                "no bridge host has a free room block (register bridge "
                "hosts with room_size, or the fleet is full)")
        _, _, name, host, block = min(candidates,
                                      key=lambda c: (c[0], c[1]))
        self._rooms[room] = (name, block)
        return name, host, block * host.room_size

    def release(self, stream_id, token=None) -> None:
        self._check_token(stream_id, token)
        name, slot = self._streams.pop(stream_id)
        self._token.pop(stream_id, None)
        host = self._hosts[name]
        del host.slots[slot]
        host.give_back(slot)
        room = self._room_of.pop(stream_id, None)
        if room is not None:
            # Last member out releases the room's block for reuse.
            _, block = self._rooms[room]
            rs = host.room_size
            if not any(block * rs <= s < (block + 1) * rs
                       for s in host.slots):
                del self._rooms[room]
        self._log(op="release", stream=stream_id)

    def locate(self, stream_id,
               token=None) -> Tuple[str, Tuple[str, int], int]:
        name, slot = self._streams[stream_id]
        self._check_token(stream_id, token)
        return name, self._hosts[name].data_addr, slot

    def set_bitrate(self, stream_id, bitrate: int) -> None:
        """Relay a per-stream mid-call rate change to the stream's host
        (encode/bridge hosts; a decode host refuses — it follows wire
        sizes).  The fleet-level knob a congestion controller turns."""
        name, slot = self._streams[stream_id]
        self._hosts[name].control.set_bitrate(slot, bitrate)

    def alive(self, name: str, timeout: float = 0.5,
              retries: int = 2) -> bool:
        """Failure detection: does the host's serve loop still answer
        pings?  UDP, so one lost datagram must not declare a live host
        dead — `retries` attempts, each `timeout` seconds.  (A host stuck
        mid-tick longer than retries*timeout also reads as dead; for a
        20 ms tick budget that is the right call.)"""
        try:
            self._hosts[name].control.request(
                "ping", _timeout=timeout, _retries=retries)
            return True
        except ControlError:
            # The host ANSWERED — with ok=false (e.g. an auth-keyed host
            # refusing this controller's unsigned/mis-keyed ping).  A
            # responding host is alive; failing it over would fork its
            # calls, and an exception here would kill the watchdog thread
            # (sweep()'s never-raises contract).  The misconfiguration
            # surfaces as the host's own auth_rejects counter.
            return True
        except (socket.timeout, OSError):
            return False

    def failover(self, src: str, dst: str, snapshot_path: str) -> int:
        """Crash recovery: resume a DEAD host's calls on a warm standby
        from the dead host's last periodic snapshot (serve_main
        --snapshot; written atomically, so it is always a complete tick-
        boundary state — possibly up to --snapshot_every seconds stale).

        Unlike migrate(), src is not drained (it cannot answer); it is
        deregistered.  The staleness costs a quality transient, not a
        protocol break: the standby's jitter buffer locks onto each
        caller's live sequence within 3 packets (late-side resync), and
        the engine's conv context re-converges from the live audio —
        the same concealment contract as a burst of packet loss
        (reference: lyra/lyra_decoder.cc:228-315).  Returns streams
        moved.  Refuses if src still answers pings (use migrate for an
        orderly drain — failing over a live host would fork its calls
        onto two servers)."""
        src_ctl, dst_ctl = self.begin_handoff(src, dst)
        try:
            if self.alive(src):
                raise RuntimeError(
                    f"host {src!r} still answers pings; failover would "
                    "fork its calls — use migrate() for an orderly drain")
            dst_ctl.restore(snapshot_path)
        except BaseException:
            self.abort_handoff(src, dst)
            raise
        return self.commit_handoff(src, dst, deregister_src=True)

    def begin_handoff(self, src: str, dst: str
                      ) -> Tuple[HostControl, HostControl]:
        """Phase 1 of a two-phase handoff: validate the slot geometry and
        mark both hosts busy, so the blocking control RPCs (drain /
        restore — seconds on a slow snapshot) can run OUTSIDE the
        caller's fleet lock while admission and remove_host refuse to
        touch either host.  Returns (src_control, dst_control) for the
        caller to drive; finish with commit_handoff or abort_handoff.
        The one-shot migrate()/failover() wrap exactly this sequence for
        single-threaded callers."""
        if src == dst:
            raise RuntimeError(f"handoff source and destination are "
                               f"both {src!r}")
        src_h, dst_h = self._hosts[src], self._hosts[dst]
        if src_h.busy or dst_h.busy:
            raise RuntimeError(
                f"a handoff involving {src if src_h.busy else dst!r} "
                "is already in flight")
        if dst_h.slots:
            raise RuntimeError(
                f"destination {dst!r} already carries "
                f"{len(dst_h.slots)} streams")
        if dst_h.capacity != src_h.capacity:
            raise RuntimeError(
                f"snapshot capacity {src_h.capacity} != destination "
                f"capacity {dst_h.capacity} (positional slot handoff)")
        if dst_h.room_size != src_h.room_size:
            raise RuntimeError(
                f"room geometry mismatch: {src!r} has room_size "
                f"{src_h.room_size}, {dst!r} {dst_h.room_size} (room "
                "blocks are positional too)")
        src_h.busy = dst_h.busy = True
        self._log(op="begin_handoff", src=src, dst=dst)
        return src_h.control, dst_h.control

    def abort_handoff(self, src: str, dst: str,
                      src_stopped: bool = False) -> None:
        """Phase 2 on failure: release the reservations.  `src_stopped`
        (a migrate whose drain succeeded but whose restore failed) parks
        src as a standby — its serve loop has STOPPED, so leaving it in
        the admission pool would seat new callers on a dead data
        address; the operator restores its snapshot elsewhere or
        restarts it."""
        for name in (src, dst):
            h = self._hosts.get(name)
            if h is not None:
                h.busy = False
        if src_stopped and src in self._hosts:
            self._hosts[src].standby = True
        self._log(op="abort_handoff", src=src, dst=dst,
                  src_stopped=src_stopped)

    def commit_handoff(self, src: str, dst: str,
                       deregister_src: bool) -> int:
        """Phase 2 on success: re-home the routing tables (slot k on src
        becomes slot k on dst, room blocks positionally) and flip dst
        active.  failover deregisters its dead src (closing the control
        socket); migrate parks the drained src as a standby for the
        operator to remove_host() or restart.  Returns streams moved."""
        src_h, dst_h = self._hosts[src], self._hosts[dst]
        moved = 0
        for slot, sid in src_h.slots.items():
            dst_h.slots[slot] = sid
            self._streams[sid] = (dst, slot)
            moved += 1
        self._rehome_rooms(src, dst)
        src_h.slots = {}
        # Both hosts' slot tables just changed in bulk (positionally, not
        # through alloc/give_back): re-arm the allocators, or a parked
        # ex-source reused later allocates past its real free slots.
        src_h.reset_alloc()
        dst_h.reset_alloc()
        dst_h.standby = False  # carries the live calls now
        src_h.busy = dst_h.busy = False
        if deregister_src:
            src_h.control.close()
            del self._hosts[src]
        else:
            # The drained host's serve loop has STOPPED (drain =
            # snapshot + stop): it must leave the admission pool
            # immediately, or being empty makes it the least-loaded
            # winner and the next caller is seated on a dead data
            # address.  Standby keeps it registered for the operator to
            # remove_host() (or re-register after a restart) — the same
            # end state failover() reaches by deregistering outright.
            src_h.standby = True
        self._log(op="commit_handoff", src=src, dst=dst,
                  deregister_src=deregister_src)
        return moved

    def _rehome_rooms(self, src: str, dst: str) -> None:
        """Rooms are positional like slots: a whole-host move carries
        every room block to the destination unchanged."""
        for room, (name, block) in list(self._rooms.items()):
            if name == src:
                self._rooms[room] = (dst, block)

    def migrate(self, src: str, dst: str, snapshot_path: str) -> int:
        """Maintenance migration: drain `src` (snapshot + stop), restore
        the snapshot into warm standby `dst`, and re-home the routing
        table.  Returns how many streams moved.

        The destination must be empty and of the same capacity as the
        source (the snapshot's slot table is positional — slot k on A
        becomes slot k on B, so callers keep their wire slot and only
        re-aim their datagrams at dst's data address; the server-side
        restore enforces the exact-capacity match).  In-flight packets
        during
        the handoff window are lost; the decoder's PLC conceals them,
        the same contract as network loss (reference:
        lyra/lyra_decoder.cc:228-315 is what makes this seamless)."""
        src_ctl, dst_ctl = self.begin_handoff(src, dst)
        drained = False
        try:
            src_ctl.drain(snapshot_path)
            drained = True
            dst_ctl.restore(snapshot_path)
        except BaseException:
            self.abort_handoff(src, dst, src_stopped=drained)
            raise
        return self.commit_handoff(src, dst, deregister_src=False)

    def close(self) -> None:
        for h in self._hosts.values():
            h.control.close()
        if self._journal is not None:
            self._journal.close()
