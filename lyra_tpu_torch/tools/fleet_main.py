"""Runnable fleet controller: admission service + failure watchdog — the
port of lyra_tpu/tools/fleet_main.py, a whole copy of it (only this
docstring and the package name in the imports differ).

`serve_main` is one serving host; this command is the tier above it —
the process an operator runs to stand a FLEET up:

  python -m lyra_tpu_torch.tools.fleet_main \
      --host a=10.0.0.1:5620:5630 --host b=10.0.0.2:5620:5630 \
      --standby spare=10.0.0.3:5620:5630 \
      --capacity 1024 --port 6000 \
      --snapshot_dir /var/lib/lyra --watch_every 0.5

It owns a `FleetRouter` (tools/fleet.py) and exposes two behaviors:

- **Admission service** (UDP JSON on --port): callers ask for a seat and
  get back the host's data address + wire slot; `release` frees it.
  One datagram per command, one JSON reply to the sender (the same
  envelope as serve_main's control plane, with "req" echo):

    {"cmd": "admit",  "stream": ID}  -> {"ok": true, "host": name,
                                         "addr": [ip, port], "slot": N}
      (+ optional "bitrate": B on encode/bridge fleets, relayed to the
       host's set_bitrate; + optional "room": R on bridge fleets;
       + RECOMMENDED "token": the seat capability, required again by
       locate/release of that seat)
    {"cmd": "release","stream": ID}  -> {"ok": true}
    {"cmd": "locate", "stream": ID}  -> as admit (after a migration the
                                        addr points at the new host)
    {"cmd": "set_bitrate", "stream": ID, "bitrate": B}
    {"cmd": "stats"}                 -> {"ok": true, "stats": {...}}
    {"cmd": "migrate","src": A, "dst": B}
                                     -> maintenance drain (management op;
                                        the drain snapshot is
                                        --snapshot_dir/<A>.drain)
    {"cmd": "add_host", "spec": "name=ip:dport:cport:cap",
     "standby": bool}
    {"cmd": "remove_host", "host": N}
    {"cmd": "quit"}

- **Crash tolerance**: with --snapshot_dir the controller journals every
  routing mutation to <DIR>/.fleet_journal.jsonl and a restarted
  controller replays it.
- **Failure watchdog**: every --watch_every seconds each registered host
  is pinged; a dead ACTIVE host is failed over onto a standby of the
  same capacity from its periodic snapshot (--snapshot_dir/<name>; run
  every host with `serve_main --snapshot <dir>/<name> --snapshot_every
  S`).

The management verbs (migrate/quit/add_host/remove_host/set_bitrate) are
HMAC-gated when --key is given, and a routable --bind requires --key.
The controller is host code only: it imports no torch and runs no
kernel; the hosts it drives run the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import threading
import time

from lyra_tpu_torch.tools.control_auth import (
    AuthError, Verifier, load_key, require_key_for_routable)
from lyra_tpu_torch.tools.fleet import (
    ControlError, FleetJournal, FleetRouter, HostControl, StatsSink)


_NAME_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]*")

# Routing journal filename under --snapshot_dir.  The leading dot keeps it
# out of the host-name namespace: host names must start alphanumeric
# (_NAME_RE), so no host snapshot can ever collide with it.
_JOURNAL_NAME = ".fleet_journal.jsonl"


def _parse_host(spec: str):
    """name=ip:data_port:control_port[:capacity] -> parsed tuple.

    Names are restricted to [A-Za-z0-9._-] (alnum first): they become
    snapshot FILENAMES under --snapshot_dir, and add_host/migrate are
    reachable from the admission socket — a name with a path separator
    would let a datagram point drain/restore writes outside the snapshot
    directory."""
    name, _, rest = spec.partition("=")
    parts = rest.split(":")
    if not name or len(parts) not in (3, 4):
        raise argparse.ArgumentTypeError(
            f"host spec must be name=ip:data_port:control_port[:capacity],"
            f" got {spec!r}")
    if not _NAME_RE.fullmatch(name):
        raise argparse.ArgumentTypeError(
            f"host name {name!r} must match {_NAME_RE.pattern} "
            "(it names the snapshot file)")
    ip, dport, cport = parts[0], int(parts[1]), int(parts[2])
    cap = int(parts[3]) if len(parts) == 4 else None
    return name, ip, dport, cport, cap


class _Watchdog:
    """Failure detection + automatic failover (SURVEY §5: the reference
    has no process-level fault tolerance; its codec-domain concealment —
    the PLC machine, reference: lyra/lyra_decoder.cc:228-315 — is exactly
    what makes this tier's handoffs survivable for the caller)."""

    def __init__(self, router: FleetRouter, snapshot_dir: str | None,
                 log=print, lock=None):
        self._router = router
        self._snapshot_dir = snapshot_dir
        self._log = log
        # Shared with the admission service: fleet bookkeeping (router
        # tables, these counters) mutates under it, so sweeps can run in
        # their own thread without racing admit/locate.  Re-entrant:
        # stats() is reached both directly and from under _dispatch.
        self._lock = lock if lock is not None else threading.RLock()
        self.failovers = 0
        self.failover_errors = 0
        self.dead_unrecovered: list[str] = []
        # Fleet generation: bumped by notify_fleet_changed.  A sweep
        # records it before its unlocked probes; any verdict reached
        # after the fleet changed (host removed/re-added while the probe
        # blocked) is discarded instead of suppressing or failing over a
        # host the verdict was never about.
        self._gen = 0

    def notify_fleet_changed(self) -> None:
        """The dead_unrecovered list exists to stop retry storms against
        an UNCHANGED fleet (a dead host with no failover target stays
        dead).  A runtime add_host/remove_host changes the premise — a
        freshly added standby may be exactly the missing target — so the
        suppression resets and the next sweep retries every dead host.
        (Caller holds the fleet lock: the admission service invokes this
        while handling the add_host/remove_host command.)"""
        self._gen += 1
        self.dead_unrecovered.clear()

    def _suppress(self, name: str, gen0: int) -> None:
        """Stop retrying `name` — valid only if the fleet is UNCHANGED
        since the verdict's probes ran (caller holds the lock); a stale
        verdict must not suppress a host that was replaced meanwhile."""
        if self._gen == gen0:
            self.dead_unrecovered.append(name)

    def sweep(self) -> None:
        """One watchdog pass: ping every host, fail over the dead active
        ones.  Never raises — a watchdog that dies with its patient is
        useless; errors are counted and logged.

        Probes AND the failover's blocking control RPCs run OUTSIDE the
        fleet lock: a silent host (network partition, power loss) costs
        retries x timeout of blocking UDP wait, a restore can take
        seconds, and admit/locate must keep answering through exactly
        those windows (HostControl serializes per-socket use itself;
        begin_handoff's busy marks keep admission and remove_host off
        both hosts meanwhile).  Only bookkeeping takes the lock,
        re-validated against the fleet generation recorded before the
        probes."""
        with self._lock:
            hosts = self._router.hosts()
            gen0 = self._gen
            suppressed = [n for n in self.dead_unrecovered if n in hosts]
        # Suppressed hosts are still PROBED (outside the lock): one that
        # answers again — an operator restarted the process in place, or
        # a standby that was just slow to come up — changes the fleet
        # premise exactly like add_host does (it may be the missing
        # failover target), so recovery resets the whole suppression list
        # and the next sweep retries every dead host.  Without this, a
        # host only left dead_unrecovered via an explicit add/remove.
        for name in suppressed:
            try:
                # One short attempt: these hosts are usually still dead,
                # and a full retries*timeout probe per suppressed host
                # would delay detection of NEW failures every sweep (a
                # genuinely recovering host just waits one more sweep if
                # its single ping datagram is lost).
                recovered = self._router.alive(name, timeout=0.3,
                                               retries=1)
            except KeyError:
                continue  # removed while probing
            if recovered:
                with self._lock:
                    if self._gen == gen0:
                        self._log(f"fleet: host {name!r} answers pings "
                                  "again; resuming watch and retrying "
                                  "suppressed failovers")
                        self.notify_fleet_changed()
                        gen0 = self._gen
        for name, info in hosts.items():
            if name in self.dead_unrecovered:
                continue  # already reported; operator action needed
            if info.get("busy"):
                continue  # a handoff is already moving this host
            try:
                if self._router.alive(name):
                    continue
            except KeyError:
                continue  # removed while we swept; nothing to judge
            self._handle_dead(name, gen0)

    def _handle_dead(self, name: str, gen0: int) -> None:
        """Judge one dead-probing host: report a dead standby, fail an
        active one over onto a live standby.  Entered WITHOUT the lock;
        takes it only around bookkeeping."""
        with self._lock:
            if self._gen != gen0:
                return  # fleet changed while we probed; re-judge next sweep
            info = self._router.hosts().get(name)
            if (info is None or info.get("busy")
                    or name in self.dead_unrecovered):
                return  # removed, reported, or already being moved
            if info["standby"]:
                self._log(f"fleet: standby {name!r} is dead "
                          "(no failover target lost, but replace it)")
                self._suppress(name, gen0)
                return
            if self._snapshot_dir is None:
                self._log(f"fleet: host {name!r} is dead and "
                          "--snapshot_dir is not set; cannot fail over")
                self.failover_errors += 1
                self._suppress(name, gen0)
                return
            candidates = [
                n for n, h in self._router.hosts().items()
                if h["standby"] and not h.get("busy")
                and h["capacity"] == info["capacity"]
                and h.get("room_size") == info.get("room_size")
                and n not in self.dead_unrecovered]
        # Probe candidate standbys OUTSIDE the lock (each probe is
        # blocking UDP; a silently-partitioned standby costs the full
        # retries x timeout).
        dst = None
        for n in candidates:
            try:
                if self._router.alive(n):
                    dst = n
                    break
            except KeyError:
                continue  # removed while probing
        if dst is None:
            with self._lock:
                self._log(f"fleet: host {name!r} is dead and no live "
                          f"standby of capacity {info['capacity']} is "
                          "registered; its callers are down until one "
                          "is added")
                self.failover_errors += 1
                self._suppress(name, gen0)
            return
        snap = os.path.join(self._snapshot_dir, name)
        with self._lock:
            if self._gen != gen0:
                return  # fleet changed under the standby probes
            try:
                _, dst_ctl = self._router.begin_handoff(name, dst)
            except (KeyError, RuntimeError) as e:
                self._log(f"fleet: failover {name!r} -> {dst!r} "
                          f"failed: {e}")
                self.failover_errors += 1
                self._suppress(name, gen0)
                return
        # The blocking phase, outside the lock: recheck the source is
        # still dead (a flapping or replaced host must NOT be failed
        # over — that would fork its calls), then restore.
        err = flap = None
        try:
            if self._router.alive(name):
                flap = (f"fleet: host {name!r} answers pings again; "
                        "not failing over")
            else:
                dst_ctl.restore(snap)
        except (ControlError, OSError, RuntimeError) as e:
            err = str(e)
        with self._lock:
            if flap is not None:
                # Alive again: no error, no suppression — the watchdog
                # keeps watching it like any healthy host.
                self._router.abort_handoff(name, dst)
                self._log(flap)
                return
            if err is not None:
                self._router.abort_handoff(name, dst)
                self._log(f"fleet: failover {name!r} -> {dst!r} "
                          f"failed: {err}")
                self.failover_errors += 1
                self._suppress(name, gen0)
                return
            moved = self._router.commit_handoff(name, dst,
                                                deregister_src=True)
            self.failovers += 1
        self._log(f"fleet: host {name!r} died; failed over {moved} "
                  f"streams to {dst!r} from {snap}")


def _addr_json(addr):
    return [addr[0], addr[1]]


def _seat_token(cmd: dict):
    """The caller-chosen seat capability (admit/locate/release "token"
    field).  Validated here so a hostile datagram cannot stuff megabytes
    (it rides the routing journal) or non-string junk into the table."""
    token = cmd.get("token")
    if token is None:
        return None
    if not isinstance(token, str) or not 1 <= len(token) <= 128:
        raise ValueError("seat token must be a 1..128-char string")
    return token


class _AdmissionService:
    """UDP JSON endpoint: the fleet's front door for callers (admit /
    release / locate / stats) plus the operator verbs (migrate / quit).
    Same wire envelope as serve_main's control plane.

    With `key` the ADMIN verbs (migrate / quit / add_host / remove_host /
    set_bitrate) require a valid HMAC + fresh ts/nonce
    (tools/control_auth.py); the caller-facing verbs (admit / release /
    locate / stats) stay keyless — they are non-destructive and must be
    reachable by every caller.  Tampered/stale/spliced admin datagrams
    are counted auth_rejects, never fatal."""

    ADMIN_VERBS = frozenset(
        {"migrate", "quit", "add_host", "remove_host", "set_bitrate"})

    def __init__(self, router: FleetRouter, watchdog: _Watchdog,
                 port: int, bind: str, room_size=None, key=None):
        self._router = router
        self._watchdog = watchdog
        self._room_size = room_size
        self._key = key
        self.auth_rejects = 0
        self._lock = watchdog._lock  # one fleet-state lock for both
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind, port))
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]
        # A keyed endpoint must know its own identity (the audience the
        # signing operators dial); wildcard binds were refused in main().
        self._verifier = (Verifier(key, audience=f"{bind}:{self.port}")
                          if key is not None else None)
        self.admitted = 0
        self.released = 0
        # (src, dst) -> req token of the migrate currently in flight on a
        # worker thread; UDP retries of that same command are dropped (its
        # reply comes when the RPCs complete), anything else conflicting
        # is refused by begin_handoff's busy marks.  Guarded by _lock.
        self._mig_inflight: dict = {}

    def stats(self) -> dict:
        with self._lock:
            return {"hosts": self._router.hosts(),
                    "admitted": self.admitted, "released": self.released,
                    "failovers": self._watchdog.failovers,
                    "failover_errors": self._watchdog.failover_errors,
                    **({"auth_rejects": self.auth_rejects}
                       if self._verifier is not None else {}),
                    "dead_unrecovered":
                        list(self._watchdog.dead_unrecovered)}

    def _admit(self, cmd: dict, reply: dict) -> dict:
        """Seat a caller.  Idempotent per stream id: a lost reply makes
        the caller retransmit the same admit, and the retry must get the
        seat the first attempt granted (locate semantics), not a
        duplicate-stream error that strands a leaked slot (the envelope's
        retry-safety contract, fleet.py HostControl)."""
        sid = cmd["stream"]
        token = _seat_token(cmd)
        try:
            host, data_addr, slot = self._router.admit(
                sid, room=cmd.get("room"), token=token)
            fresh = True
        except KeyError:
            # Existing seat: this is either the caller's own UDP retry
            # (same token -> same seat back, locate semantics) or someone
            # else claiming the id (token mismatch -> PermissionError ->
            # refused; without it they would be handed the victim's host
            # address and could release the seat next).
            host, data_addr, slot = self._router.locate(sid, token=token)
            fresh = False
        if "bitrate" in cmd and fresh:
            # Caller-requested downlink rate (encode/bridge fleets).
            # All-or-nothing on a fresh seat: a refused rate (bad value,
            # decode host) frees it again — otherwise the caller retries
            # admit and leaks a slot per attempt.  FRESH SEATS ONLY: a
            # retried admit's seat predates this datagram (its rate was
            # set on the fresh attempt), and relaying here for an
            # existing stream would let a keyless admit datagram retune
            # someone else's call — the exact operation ADMIN_VERBS
            # gates behind the MAC (mid-call changes go through the
            # keyed set_bitrate verb).
            try:
                self._router.set_bitrate(sid, int(cmd["bitrate"]))
            except Exception:
                # Roll back with the seat's own token (a token-guarded
                # fresh seat would otherwise refuse its own rollback).
                self._router.release(sid, token=token)
                raise
        if fresh:
            self.admitted += 1
        reply.update(host=host, addr=_addr_json(data_addr), slot=slot)
        return reply

    def poll(self, snapshot_dir: str | None) -> bool:
        """Drain queued commands; True means quit."""
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
            reply = {"req": cmd.get("req"), "ok": True}
            name = cmd.get("cmd")
            if (self._verifier is not None
                    and name in self.ADMIN_VERBS):
                try:
                    self._verifier.verify(cmd)
                except AuthError as e:
                    with self._lock:
                        self.auth_rejects += 1  # counted, never fatal
                    self._reply(addr, {"req": cmd.get("req"), "ok": False,
                                       "error": f"auth: {e}"})
                    continue
            try:
                # The fleet lock spans the whole command: router tables and
                # watchdog counters mutate atomically with respect to the
                # sweep thread's failover decisions.  (Exception: migrate
                # defers its blocking drain/restore RPCs past the lock —
                # see _finish_migrate.)
                with self._lock:
                    reply = self._dispatch(name, cmd, reply, snapshot_dir)
                    stop = stop or reply.pop("_stop", False)
                if reply.pop("_drop", False):
                    continue  # retry of an in-flight migrate: its reply
                    # is sent by the worker when the RPCs complete
                mig = reply.pop("_migrate", None)
                if mig is not None:
                    # The blocking drain/restore RPCs run on a worker
                    # thread so this loop keeps answering admit/locate;
                    # the reply rides out when the migration completes.
                    threading.Thread(
                        target=self._finish_migrate,
                        args=(mig, reply, addr), daemon=True).start()
                    continue
            except Exception as e:  # the fleet outlives a bad request
                reply = {"req": cmd.get("req"), "ok": False,
                         "error": f"{type(e).__name__}: {e}"}
            self._reply(addr, reply)
        return stop

    def _finish_migrate(self, mig, reply, addr) -> None:
        """Phase 2 of the migrate verb, on a worker thread: the blocking
        drain + restore RPCs run here, OUTSIDE the fleet lock and off the
        admission loop, so admit/locate keep answering during a
        maintenance migration (begin_handoff's busy marks keep admission,
        remove_host, and the watchdog off both hosts meanwhile).  Sends
        the deferred reply itself."""
        src, dst, snap, src_ctl, dst_ctl = mig
        drained = False
        try:
            try:
                src_ctl.drain(snap)
                drained = True
                dst_ctl.restore(snap)
            except Exception as e:
                with self._lock:
                    self._router.abort_handoff(src, dst,
                                               src_stopped=drained)
                reply = {"req": reply.get("req"), "ok": False,
                         "error": f"{type(e).__name__}: {e}"}
            else:
                with self._lock:
                    reply["moved"] = self._router.commit_handoff(
                        src, dst, deregister_src=False)
        finally:
            with self._lock:
                self._mig_inflight.pop((src, dst), None)
        self._reply(addr, reply)

    def _dispatch(self, name, cmd, reply, snapshot_dir):
        """One command under the fleet lock; may raise (poll turns the
        exception into an ok=false reply).  reply["_stop"] signals quit."""
        if name == "admit":
            reply = self._admit(cmd, reply)
        elif name == "release":
            # Idempotent (the envelope's UDP-retry contract): a retry of
            # a completed release must be an ok, not an error that makes
            # the caller believe the seat leaked.  Token-guarded seats
            # refuse a mismatch (PermissionError -> counted ok=false).
            try:
                self._router.release(cmd["stream"], token=_seat_token(cmd))
                self.released += 1
            except KeyError:
                pass
        elif name == "locate":
            host, data_addr, slot = self._router.locate(
                cmd["stream"], token=_seat_token(cmd))
            reply.update(host=host, addr=_addr_json(data_addr), slot=slot)
        elif name == "set_bitrate":
            self._router.set_bitrate(cmd["stream"], int(cmd["bitrate"]))
        elif name == "add_host":
            # Runtime fleet growth / dead-host replacement: same spec
            # grammar as the --host flag, capacity required (there is no
            # --capacity default to fall back on).
            hname, ip, dport, cport, cap = _parse_host(cmd["spec"])
            if cap is None:
                raise ValueError("runtime add_host spec needs :CAP "
                                 "(name=ip:dport:cport:capacity)")
            ctl = HostControl((ip, cport), key=self._key)
            try:
                # Runtime hosts inherit the fleet's room geometry: a
                # bridge fleet's replacement standby must tile the same
                # blocks or restore would mis-seat every room.
                self._router.add_host(hname, (ip, dport), ctl, cap,
                                      standby=bool(cmd.get("standby",
                                                           False)),
                                      room_size=self._room_size)
            except Exception:
                ctl.close()
                raise
            self._watchdog.notify_fleet_changed()
        elif name == "remove_host":
            # Refused while the host carries streams (FleetRouter fails
            # loudly) — migrate them first.
            self._router.remove_host(cmd["host"])
            self._watchdog.notify_fleet_changed()
        elif name == "stats":
            reply["stats"] = self.stats()
        elif name == "migrate":
            if snapshot_dir is None:
                raise RuntimeError(
                    "migrate needs --snapshot_dir for the drain snapshot")
            snap = os.path.join(snapshot_dir, f"{cmd['src']}.drain")
            key = (cmd["src"], cmd["dst"])
            if self._mig_inflight.get(key) == cmd.get("req"):
                reply["_drop"] = True  # UDP retry of the in-flight one
                return reply
            # Phase 1 under the lock (validate + reserve); the blocking
            # drain/restore RPCs run on a worker thread
            # (_finish_migrate), so a multi-second migration does not
            # stall admit/locate or the watchdog.
            src_ctl, dst_ctl = self._router.begin_handoff(cmd["src"],
                                                          cmd["dst"])
            self._mig_inflight[key] = cmd.get("req")
            reply["_migrate"] = (cmd["src"], cmd["dst"], snap,
                                 src_ctl, dst_ctl)
        elif name == "quit":
            reply["_stop"] = True
        else:
            reply = {"req": cmd.get("req"), "ok": False,
                     "error": f"unknown cmd {name!r}"}
        return reply

    def _reply(self, addr, obj) -> None:
        try:
            self._sock.sendto(json.dumps(obj).encode(), addr)
        except OSError:
            pass  # requester vanished; replies are best-effort

    def close(self) -> None:
        self._sock.close()


def _build_router(args):
    """Construct the FleetRouter: fresh, or rebuilt from the routing
    journal a previous controller left under --snapshot_dir (crash
    recovery — VERDICT r4 item 1: the controller must not be a single
    point of failure with amnesia).

    Resume rules: the journal is authoritative for routing state (seat
    table, room homes, standby flips — a host that failed over during the
    previous life must not be demoted by a stale flag); the --host /
    --standby flags are verified against it (address/capacity mismatch is
    a loud refusal, the no-silent-fallback convention) and may ADD hosts
    the journal has never seen.  Returns (router, recovered_hosts) where
    recovered_hosts had a handoff in flight at the crash — the watchdog
    re-judges them on its first sweep."""
    journal = None
    recovered: list = []
    jpath = None
    if args.snapshot_dir is not None:
        os.makedirs(args.snapshot_dir, exist_ok=True)
        jpath = os.path.join(args.snapshot_dir, _JOURNAL_NAME)
    key = getattr(args, "_key", None)
    if jpath is not None and os.path.exists(jpath) and os.path.getsize(jpath):
        journal = FleetJournal(jpath)
        router, recovered = FleetRouter.replay(
            jpath, journal=journal,
            control_factory=lambda addr: HostControl(addr, key=key))
        n_streams = sum(h["occupied"] for h in router.hosts().values())
        print(f"fleet: resumed routing journal {jpath} "
              f"({len(router.hosts())} hosts, {n_streams} seated streams"
              + (f", {len(recovered)} mid-handoff hosts re-judged"
                 if recovered else "") + ")", flush=True)
    else:
        if jpath is not None:
            journal = FleetJournal(jpath)
        router = FleetRouter(journal)

    for standby, specs in ((False, args.host), (True, args.standby)):
        for name, ip, dport, cport, cap in specs:
            cap = cap if cap is not None else args.capacity
            existing = router.hosts().get(name)
            if existing is not None:
                # Journal wins on standby/occupancy; the flag must agree
                # on identity (address, capacity, geometry) or the
                # operator is pointing the resumed fleet at a different
                # machine than the seats live on.
                if (tuple(existing["data_addr"]) != (ip, dport)
                        or tuple(router.control(name).addr) != (ip, cport)
                        or existing["capacity"] != cap
                        or existing.get("room_size") != args.room_size):
                    raise SystemExit(
                        f"fleet: --host/--standby {name!r} disagrees with "
                        f"the resumed journal {jpath} (journal: "
                        f"addr={existing['data_addr']}, "
                        f"capacity={existing['capacity']}, room_size="
                        f"{existing.get('room_size')}); remove_host it "
                        "first or fix the flag")
                if existing["standby"] != standby:
                    print(f"fleet: {name!r} resumed as "
                          f"{'standby' if existing['standby'] else 'active'}"
                          f" (journal overrides the flag)", flush=True)
                continue
            ctl = HostControl((ip, cport), key=key)
            router.add_host(name, (ip, dport), ctl, cap,
                            standby=standby, room_size=args.room_size)
    return router, recovered


def main(argv=None, _on_ready=None, _stop=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", action="append", type=_parse_host, default=[],
                   metavar="NAME=IP:DPORT:CPORT[:CAP]",
                   help="Register an active serving host (repeatable): "
                        "its data port and serve_main --control port.")
    p.add_argument("--standby", action="append", type=_parse_host,
                   default=[], metavar="NAME=IP:DPORT:CPORT[:CAP]",
                   help="Register a warm standby (compiled and ticking, "
                        "excluded from admission until a migration or "
                        "failover flips it active).")
    p.add_argument("--capacity", type=int, default=None,
                   help="Default per-host capacity (streams) for specs "
                        "without their own :CAP suffix.")
    p.add_argument("--room_size", type=int, default=None,
                   help="Bridge fleets: every registered host serves "
                        "rooms of this many seats (serve_main --mode "
                        "bridge --room_size K); admission becomes "
                        "room-directed (admit takes a \"room\" field, "
                        "members co-locate in one block on one host).")
    p.add_argument("--port", type=int, default=0,
                   help="Admission endpoint port (0 = ephemeral, printed "
                        "in the startup line).")
    p.add_argument("--bind", default="127.0.0.1", metavar="ADDR",
                   help="Admission bind address (default loopback).  "
                        "admit/release/locate/stats are caller-facing and "
                        "keyless, but the admin verbs (migrate/quit/"
                        "add_host/remove_host/set_bitrate) ride the same "
                        "socket, so a routable bind (e.g. 0.0.0.0) "
                        "REQUIRES --key — refused at startup otherwise "
                        "(DEPLOYMENT.md, Trust boundary).")
    p.add_argument("--key", default=None, metavar="FILE",
                   help="Shared HMAC key file (>= 16 bytes) for the "
                        "management plane: admin verbs on the admission "
                        "socket must carry a valid mac + fresh ts/nonce, "
                        "and every host-control RPC this controller sends "
                        "is signed with it (run hosts with serve_main "
                        "--control_key on the same file when their "
                        "control binds are routable).")
    p.add_argument("--snapshot_dir", default=None, metavar="DIR",
                   help="Where each host's periodic snapshot lives "
                        "(<DIR>/<name>, i.e. run hosts with serve_main "
                        "--snapshot <DIR>/<name>).  Required for "
                        "automatic failover and the migrate command.  "
                        "Also holds the controller's own routing journal "
                        "(" + _JOURNAL_NAME + "): a restarted controller "
                        "replays it and answers locate for every "
                        "pre-existing seat (crash recovery; without this "
                        "flag routing state is in-memory only).")
    p.add_argument("--watch_every", type=float, default=0.5,
                   help="Watchdog sweep interval in seconds (0 disables "
                        "failure detection; admission still works).")
    p.add_argument("--wait_ready", action="store_true",
                   help="Block until every registered host answers its "
                        "control ping before opening admission.")
    p.add_argument("--report_every", type=float, default=10.0)
    p.add_argument("--stats", default=None, metavar="PATH",
                   help="Append one JSON stats line per --report_every "
                        "interval (+ a final record) — the fleet-tier "
                        "twin of serve_main --stats.")
    p.add_argument("--seconds", type=float, default=0,
                   help="Run duration (0 = until quit/SIGINT).")
    args = p.parse_args(argv)

    if not args.host and not args.standby:
        # A flagless start is legal ONLY as a journal resume: the host set
        # then comes from the previous life's routing journal.
        jpath = (os.path.join(args.snapshot_dir, _JOURNAL_NAME)
                 if args.snapshot_dir else None)
        if jpath is None or not (os.path.exists(jpath)
                                 and os.path.getsize(jpath)):
            p.error("register at least one --host or --standby (or point "
                    "--snapshot_dir at a previous controller's journal "
                    "to resume)")
    if args.watch_every < 0:
        p.error("--watch_every must be >= 0")
    caps = [c for *_, c in args.host + args.standby]
    if args.capacity is None and any(c is None for c in caps):
        p.error("give --capacity or a :CAP suffix on every host spec")
    names = [n for n, *_ in args.host + args.standby]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        p.error(f"duplicate host name(s): {', '.join(dupes)}")

    # Trust boundary, enforced before any socket binds: loopback stays
    # keyless, a routable admission bind requires the shared key.
    require_key_for_routable(args.bind, args.key,
                             "fleet_main admission endpoint")
    if args.key is not None and args.bind in ("0.0.0.0", "::", ""):
        p.error("--key with a wildcard --bind: a keyed endpoint must know "
                "its own identity (the audience operators sign for) — "
                "bind the specific interface address")
    args._key = load_key(args.key) if args.key is not None else None

    router, recovered = _build_router(args)
    if args.wait_ready:
        # In PARALLEL (total wait = slowest host, not the sum — a dead
        # host must not serialize 120 s in front of every other wait and
        # the admission bind), and tolerant: a host that is dead
        # (timeout) or answering ok=false (ControlError — e.g. keyed with
        # a stale key) must not abort the controller start.  That would
        # turn one host's failure into a fleet-wide outage exactly when
        # crash recovery is restarting the controller; the watchdog (or
        # the host's own auth_rejects counter) surfaces it instead.
        def wait_one(name):
            try:
                router.control(name).wait_ready()
            except (socket.timeout, ControlError) as e:
                print(f"fleet: host {name!r} not ready at startup "
                      f"({type(e).__name__}); serving without it "
                      "(watchdog will judge)", flush=True)

        waiters = [threading.Thread(target=wait_one, args=(n,))
                   for n in router.hosts()]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
    if recovered:
        # Mid-handoff hosts from a crashed previous life: probe once and
        # report loudly — with the watchdog enabled (default) the next
        # sweep re-judges them; with --watch_every 0 the operator must.
        for name in recovered:
            try:
                ok = router.alive(name)
            except KeyError:
                continue
            if not ok:
                print(f"fleet: recovered mid-handoff host {name!r} is not "
                      "answering; the watchdog will fail it over"
                      + ("" if args.watch_every > 0 else
                         " — but --watch_every is 0: operator action "
                         "needed"), flush=True)

    watchdog = _Watchdog(router, args.snapshot_dir)
    svc = _AdmissionService(router, watchdog, args.port, args.bind,
                            room_size=args.room_size, key=args._key)
    sink = StatsSink(args.stats)
    print(f"fleet controller on UDP :{svc.port} "
          f"({len(args.host)} hosts, {len(args.standby)} standbys, "
          f"watch_every={args.watch_every}s)", flush=True)
    if _on_ready is not None:
        _on_ready(svc.port)

    # The watchdog sweeps in its own thread: a silent host (partition,
    # power loss) costs retries x timeout of blocking probe wait, and the
    # admission loop must keep answering admit/locate through exactly
    # that window.  Fleet-state mutations share one lock (see _Watchdog).
    watch_stop = threading.Event()

    def watch_loop():
        # Wait-first: give freshly registered hosts one interval before
        # the first probe (deeper startup grace is --wait_ready's job).
        while not watch_stop.wait(args.watch_every):
            try:
                watchdog.sweep()
            except Exception as e:  # noqa: BLE001 — a watchdog that dies
                # with one bad probe leaves the fleet without failure
                # detection for the rest of the controller's life;
                # sweep() promises never to raise, this is the backstop.
                print(f"fleet: watchdog sweep error (continuing): "
                      f"{type(e).__name__}: {e}", flush=True)

    watcher = None
    if args.watch_every > 0:
        watcher = threading.Thread(target=watch_loop, daemon=True)
        watcher.start()

    t_end = (time.monotonic() + args.seconds) if args.seconds else None
    next_report = time.monotonic() + args.report_every
    try:
        while ((t_end is None or time.monotonic() < t_end)
               and not (_stop is not None and _stop.is_set())):
            if svc.poll(args.snapshot_dir):
                break
            if time.monotonic() >= next_report:
                next_report = time.monotonic() + args.report_every
                snap = {"ts": round(time.time(), 3), **svc.stats()}
                sink.emit(snap)
                print(f"fleet: {json.dumps(snap)}", flush=True)
            time.sleep(0.01)
    except KeyboardInterrupt:
        pass
    finally:
        watch_stop.set()
        if watcher is not None:
            watcher.join(timeout=30)
        snap = {"ts": round(time.time(), 3), **svc.stats(), "final": True}
        sink.emit(snap)
        sink.close()
        print(f"fleet: final {json.dumps(snap)}", flush=True)
        svc.close()
        router.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
