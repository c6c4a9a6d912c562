"""Caller-side client: one seat on a lyra_tpu_torch fleet, end to end —
the port of lyra_tpu/client.py, a whole copy of it (only this docstring
and the package name in the imports differ).

A caller asks the fleet (tools/fleet_main.py) for a SEAT and exchanges
datagrams with a serving host:

    caller = FleetCaller(("fleet.example", 6000), "call-1234")
    caller.send_packet(encoded_bytes)        # one per 20 ms tick
    for seq, payload in caller.recv():       # downlink (--echo reply)
        play(payload)
    if caller.silent_ticks > 25:             # ~0.5 s of downlink silence
        caller.relocate()                    # seat may have moved hosts
    caller.release()

What it owns:

- **Admission**: the UDP JSON envelope (the control plane's retry and
  req-token contract, tools/fleet.py HostControl) against fleet_main's
  caller verbs admit / locate / release, with a seat capability token
  generated by default.
- **Wire framing**: the 6-byte header (2 B slot + 4 B big-endian
  sequence) on uplink datagrams — encoded packets (decode/bridge hosts)
  or raw int16 PCM hops (encode-relay hosts), RED-framed on a red=D
  client — and parsing of downlink datagrams, which arrive on the SAME
  socket when the host runs `--echo reply`.
- **Re-resolution**: after a migration or failover the seat's data
  address changes but the wire slot does not; `relocate()` re-asks the
  fleet and re-aims.  `silent_ticks` counts consecutive empty `recv()`
  drains as the trigger.

The client is transport-only: it imports no torch; encoding and decoding
stay wherever the caller's codec runs (a LyraEncoder / LyraDecoder of
codec/, or raw PCM against an encode-relay host).
"""

from __future__ import annotations

import collections
import secrets
import socket
from typing import List, Optional, Tuple

import numpy as np

from lyra_tpu_torch import packet as _pkt
from lyra_tpu_torch.tools.fleet import ControlError, HostControl

HEADER_BYTES = 6  # 2 B slot + 4 B seq, big-endian (the fleet wire layout)


class SeatError(RuntimeError):
    """The fleet refused an admission-plane request (ok=false) — e.g. a
    full fleet, a token mismatch, or a released seat."""


class FleetCaller:
    """One caller's leg: a seat plus its uplink/downlink socket.

    `token`: the seat capability — a fresh random one by default; pass
    `token=None` explicitly for the legacy open contract (anyone
    reachable may then locate/release this stream id).  `bitrate` and
    `room` ride the admit (encode/bridge fleets).  `timeout`/`retries`
    shape the admission envelope's UDP patience.

    `red`: the fleet's RED redundancy distance (hosts running
    `serve_main --red D` — a WIRE CONTRACT: every sender must frame the
    same way, or the host misparses plain packets as ragged RED and
    drops them).  With red=D every uplink packet datagram also carries
    the packet sent D ticks earlier (packet.build_red framing; DTX-empty
    ticks contribute empty redundant blocks).  Downlink RED from an
    encode host is parsed with `lyra_tpu_torch.packet.parse_red` by the
    caller's own playout logic — recv() returns raw payloads.
    """

    def __init__(self, admission_addr: Tuple[str, int], stream_id,
                 token: Optional[str] = "auto",
                 bitrate: Optional[int] = None, room=None,
                 red: int = 0, timeout: float = 2.0, retries: int = 5):
        if not 0 <= red <= 8:  # before any socket exists
            raise ValueError(f"red must be in 0..8, got {red}")
        self.stream_id = stream_id
        self.token = secrets.token_hex(16) if token == "auto" else token
        self._bitrate = bitrate
        self._room = room
        self._red = red
        # Packet history for RED: the redundant block for send t is the
        # packet ATTEMPTED at t-D (empty at stream start) — attempt-based
        # like seq, so a locally failed send stays a plain loss the host
        # can even heal from a later datagram's redundant copy.
        self._red_hist = collections.deque([b""] * red, maxlen=red)
        self.seq = 0
        self.silent_ticks = 0
        self.send_errors = 0  # local sendto failures (counted, not raised)
        self.host = None  # fleet host name carrying the seat
        self.data_addr: Optional[Tuple[str, int]] = None
        self.slot: Optional[int] = None
        self._adm = HostControl(admission_addr, timeout=timeout,
                                retries=retries)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        try:
            self._seat("admit")
        except BaseException:
            # A refused admit (full fleet, token mismatch) or an
            # unreachable fleet must not leak the two sockets a retrying
            # app would otherwise accumulate.
            self._sock.close()
            self._adm.close()
            raise

    def _seat(self, verb: str) -> None:
        fields = {"stream": self.stream_id}
        if self.token is not None:
            fields["token"] = self.token
        if verb == "admit":
            if self._bitrate is not None:
                fields["bitrate"] = self._bitrate
            if self._room is not None:
                fields["room"] = self._room
        try:
            reply = self._adm.request(verb, **fields)
        except ControlError as e:
            raise SeatError(str(e)) from e
        self.host = reply["host"]
        self.data_addr = self._canonical(reply["addr"][0], reply["addr"][1])
        self.slot = int(reply["slot"])

    @staticmethod
    def _canonical(host: str, port: int) -> Tuple[str, int]:
        """Resolve the seat address to the numeric form recvfrom() will
        report.  The fleet hands back whatever the operator's --host spec
        contained; if that was a hostname, comparing it against
        recvfrom()'s numeric source would silently drop ALL downlink —
        the silent-fallback class this framework bans.  Resolution
        failure is loud (SeatError), not a dead-air call."""
        try:
            infos = socket.getaddrinfo(host, port, socket.AF_INET,
                                       socket.SOCK_DGRAM)
        except OSError as e:
            raise SeatError(
                f"cannot resolve seat data address {host!r}: {e}") from e
        return infos[0][4][:2]

    def relocate(self) -> bool:
        """Re-ask the fleet where this seat lives (after downlink silence
        or an operator-announced migration).  Returns True when the data
        address changed — the next send() already aims at the new host;
        the wire slot never changes (positional handoff)."""
        old = self.data_addr
        self._seat("locate")
        self.silent_ticks = 0
        return self.data_addr != old

    def _send(self, payload: bytes) -> int:
        if self.slot is None:
            raise SeatError("seat released")
        dgram = (self.slot.to_bytes(2, "big")
                 + self.seq.to_bytes(4, "big") + payload)
        try:
            self._sock.sendto(dgram, self.data_addr)
        except OSError:
            # A transport event (interface flap, ENETUNREACH) is a
            # counted drop, never an exception out of a tick — and the
            # sequence/RED clocks still advance, so the failed datagram
            # is just a loss the host conceals (or heals from a later
            # RED copy).
            self.send_errors += 1
        seq = self.seq
        self.seq += 1
        return seq

    def send_packet(self, packet: bytes) -> int:
        """Uplink one encoded lyra packet (decode/bridge hosts); returns
        the sequence it was sent under.  Call once per 20 ms tick; a
        DTX-empty packet (b"") is a legal zero-length payload.  On a
        red=D client the datagram is RED-framed with the packet from D
        ticks earlier."""
        packet = bytes(packet)
        payload = packet
        if self._red:
            prev = self._red_hist[0]
            self._red_hist.append(packet)
            payload = _pkt.build_red(packet, prev)
        return self._send(payload)

    def send_pcm(self, hop) -> int:
        """Uplink one 20 ms int16 PCM hop (encode-relay hosts)."""
        hop = np.ascontiguousarray(hop, dtype=np.int16)
        return self._send(hop.tobytes())

    def recv(self, max_datagrams: int = 64) -> List[Tuple[int, bytes]]:
        """Drain downlink datagrams (hosts running --echo reply answer
        to this socket from the seat's data address).  Returns
        [(seq, payload)] for OUR slot FROM the seat's current host;
        foreign sources (an off-path sender, a stale host flushing after
        a migration — the slot itself survives handoffs, so source is
        the discriminator), foreign slots, and runts are dropped, never
        an exception.  An empty drain bumps silent_ticks (the relocate()
        trigger); a non-empty one resets it."""
        out: List[Tuple[int, bytes]] = []
        # max_datagrams bounds socket READS, not accepted datagrams: a
        # flood of foreign junk must not spin this drain past the
        # caller's 20 ms tick.
        for _ in range(max_datagrams):
            try:
                dgram, src = self._sock.recvfrom(65536)
            except BlockingIOError:
                break
            except OSError:
                break
            if src != self.data_addr:
                # Not the seat's current host: an off-path sender, or a
                # stale host flushing after a migration — the slot is
                # PRESERVED across handoffs (positional), so the source
                # address is the only discriminator.  Dropped, and it
                # must not reset the silence counter that triggers
                # relocate().
                continue
            if len(dgram) < HEADER_BYTES:
                continue  # malformed: a counted-drop-class event
            slot = int.from_bytes(dgram[:2], "big")
            if slot != self.slot:
                continue
            out.append((int.from_bytes(dgram[2:HEADER_BYTES], "big"),
                        dgram[HEADER_BYTES:]))
        if out:
            self.silent_ticks = 0
        else:
            self.silent_ticks += 1
        return out

    def release(self) -> None:
        """Give the seat back (idempotent; safe on a lost reply)."""
        if self.slot is None:
            return
        fields = {"stream": self.stream_id}
        if self.token is not None:
            fields["token"] = self.token
        try:
            self._adm.request("release", **fields)
        except ControlError as e:
            raise SeatError(str(e)) from e
        self.slot = None

    def close(self) -> None:
        self._sock.close()
        self._adm.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            if self.slot is not None:
                self.release()
        except (SeatError, OSError):
            pass  # the fleet may be gone; closing must not raise
        self.close()
