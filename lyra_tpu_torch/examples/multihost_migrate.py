"""Example: live two-process migration — drain a serving host mid-call
and resume its streams on a warm standby, measured for audio gaps — the
port of examples/multihost_migrate.py.

drain_migrate.py proves the snapshot math in one process; this is the
real deployment shape: two independent `python -m
lyra_tpu_torch.tools.serve_main` host PROCESSES on the card (independent
batches), a `FleetRouter` seating callers and orchestrating the
maintenance move over each host's --control endpoint:

  host A (serving)            host B (warm standby, captured, ticking)
      │  uplink packets ◄──────────── callers (this process)
      │  downlink PCM ──► collector
      │
      │  router.migrate("A","B", snap):
      │    A: drain → snapshot engine state + slot table, stop
      │    B: restore → swaps the snapshot in at a tick boundary
      │
      └─ callers re-aim datagrams at B; wire slots are positional, so
         nothing else changes.  In-flight packets during the handoff are
         lost and concealed by PLC (reference: lyra/lyra_decoder.cc:
         228-315); B's jitter buffer re-syncs to the callers' sequence
         origin within 3 packets.

Callers send a constant 440 Hz tone, so "audio gap" is crisp: any
downlink hop with speech-level RMS counts as voice.  The example reports,
per caller, the longest wall-clock gap between consecutive voice hops
across the cutover and fails if it exceeds --max_gap_ms.

Run from the repo root (the hosts are processes on the card, started one
after the other so their first ticks' graph captures never overlap; the
example raises before it spawns anything when there is no card, and it
has no CPU mode — the in-process fleet tests cover that path):

    python -m lyra_tpu_torch.examples.multihost_migrate --callers 2 \
        --seconds_each 4 --model_path DIR

--failover simulates a CRASH instead of an orderly drain: host A runs
with periodic atomic snapshots (--snapshot_every, the staleness bound),
is SIGKILLed mid-call, declared dead when pings stop answering, and its
calls resume on B from the last snapshot (FleetRouter.failover).  The
same gap metric applies — the stale conv context costs a quality
transient, not a protocol break.

--controller runs the fleet tier as a THIRD real process (`python -m
lyra_tpu_torch.tools.fleet_main`): callers admit and re-resolve their seats
over its UDP JSON admission endpoint, the drain is the controller's
`migrate` verb, and in --failover the controller's WATCHDOG detects the
SIGKILL and fails over on its own — this example just keeps streaming at
the dead address (as a real caller would) and polls `locate` until the
seat flips to B.  The measured gap then includes the watchdog's
detection latency, the closest thing to production topology this stack
can demonstrate on one machine.  After the cutover the example prints
the router's host table (`FleetRouter.hosts()`, in --controller mode the
controller's `stats`).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from lyra_tpu_torch.examples import _common
from lyra_tpu_torch.tools.fleet import FleetRouter, HostControl
from lyra_tpu_torch.tools.stream_server import EncoderServer
from lyra_tpu_torch.utils.device import resolve

_HDR = 6  # 2 B slot + 4 B seq, big-endian (the stack's wire header)
# The hosts run `python -m lyra_tpu_torch...` from the repository root.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _Admission(HostControl):
    """Caller-side client for fleet_main's UDP admission endpoint — the
    same req-token envelope as the host control plane, so HostControl IS
    the client; this only adds the seat-tuple convenience."""

    def seat(self, cmd, stream):
        r = self.request(cmd, stream=stream)
        return r["host"], (r["addr"][0], r["addr"][1]), r["slot"]


def _spawn_controller(ports: dict, cap: int, snap_dir: str, log_dir: str,
                      watch_every: float) -> tuple:
    """Start fleet_main as its own process; returns (Popen, _Admission)."""
    port = _common.free_udp_port()
    log = open(os.path.join(log_dir, "controller.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lyra_tpu_torch.tools.fleet_main",
         "--host", f"A=127.0.0.1:{ports['A'][0]}:{ports['A'][1]}:{cap}",
         "--standby", f"B=127.0.0.1:{ports['B'][0]}:{ports['B'][1]}:{cap}",
         "--snapshot_dir", snap_dir, "--watch_every", str(watch_every),
         "--port", str(port), "--report_every", "60", "--seconds", "0"],
        stdout=log, stderr=subprocess.STDOUT, cwd=_ROOT)
    adm = _Admission(("127.0.0.1", port))
    deadline = time.time() + 60
    while True:  # the controller answers stats once its socket is up
        try:
            adm.request("stats")
            return proc, adm
        except (socket.timeout, ConnectionRefusedError):
            if time.time() > deadline:
                raise RuntimeError("fleet controller never came up")
            time.sleep(0.2)


def _spawn_host(name: str, data_port: int, ctl_port: int, collector: int,
                capacity: int, log_dir: str, model_path: str,
                extra=()) -> subprocess.Popen:
    log = open(os.path.join(log_dir, f"host_{name}.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "lyra_tpu_torch.tools.serve_main",
         "--capacity", str(capacity), "--seconds", "0",
         "--model_path", model_path,
         "--max_bitrate", "3200", "--playout_delay", "1",
         "--port", str(data_port), "--control", str(ctl_port),
         "--echo", f"127.0.0.1:{collector}", "--report_every", "60",
         *extra],
        stdout=log, stderr=subprocess.STDOUT, cwd=_ROOT)


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--callers", type=int, default=2)
    p.add_argument("--seconds_each", type=float, default=4.0,
                   help="Seconds of call before AND after the migration.")
    p.add_argument("--max_gap_ms", type=float, default=1000.0,
                   help="Fail if any caller's downlink voice gap across "
                        "the cutover exceeds this.")
    p.add_argument("--failover", action="store_true",
                   help="Simulate a host CRASH instead of an orderly "
                        "drain: SIGKILL host A mid-call, detect death by "
                        "ping loss, resume on B from A's last periodic "
                        "snapshot (--snapshot_every stale at worst).")
    p.add_argument("--snapshot_every", type=float, default=0.5,
                   help="Failover mode: host A's periodic snapshot "
                        "cadence (its staleness bound).")
    p.add_argument("--controller", action="store_true",
                   help="Run the fleet tier as a third real process "
                        "(tools/fleet_main.py): admission and locate over "
                        "its UDP endpoint; in --failover its watchdog "
                        "detects the crash and fails over autonomously.")
    p.add_argument("--watch_every", type=float, default=0.3,
                   help="Controller mode: watchdog sweep interval.")
    p.add_argument("--log_dir", default=os.path.join(
        tempfile.gettempdir(), "lyra_tpu_torch_multihost"))
    _common.add_model_flag(p)
    args = p.parse_args(argv)
    _common.check_model_flag(p, args)
    # The hosts are processes of their own on the card: no card, no run
    # (raised here, before anything is spawned).
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"multihost_migrate runs its hosts on the card; "
                         f"device={device!r} is not one")
    os.makedirs(args.log_dir, exist_ok=True)
    cap = args.callers

    # A constant tone encodes to real packets once; replayed each tick.
    enc = EncoderServer(cap, model_path=args.model_path, bitrate=3200,
                        device=dev)
    enc.add_streams(range(cap))
    t = np.arange(320) / 16000.0
    tone = np.tile((8000 * np.sin(2 * np.pi * 440 * t))
                   .astype(np.int16), (cap, 1))
    packets = [enc.tick({c: tone[c] for c in range(cap)})
               for _ in range(8)]  # a few distinct hops to cycle
    del enc

    # Downlink collector: both hosts echo decoded PCM hops here.
    col = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    col.bind(("127.0.0.1", 0))
    col.settimeout(0.05)
    arrivals = []  # (t_wall, src_port, slot, rms)
    col_stop = threading.Event()

    def collect():
        while not col_stop.is_set():
            try:
                dgram, src = col.recvfrom(4096)
            except socket.timeout:
                continue
            if len(dgram) < _HDR:
                continue
            slot = int.from_bytes(dgram[:2], "big")
            pcm = np.frombuffer(dgram[_HDR:], np.int16)
            rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
            arrivals.append((time.perf_counter(), src[1], slot, rms))

    col_thread = threading.Thread(target=collect, daemon=True)
    col_thread.start()

    ports = {n: (_common.free_udp_port(), _common.free_udp_port())
             for n in ("A", "B")}
    procs = {}
    ctls = {}
    router = None if args.controller else FleetRouter()
    controller = adm = None
    snap_dir = tempfile.mkdtemp(dir=args.log_dir)
    # fleet_main's failover convention is --snapshot_dir/<host name>.
    snap = os.path.join(snap_dir, "A" if args.controller else "snapA")
    try:
        # Sequential startup: one first-tick graph capture at a time.
        for name in ("A", "B"):
            data_port, ctl_port = ports[name]
            extra = ()
            if args.failover and name == "A":
                extra = ("--snapshot", snap,
                         "--snapshot_every", str(args.snapshot_every))
            procs[name] = _spawn_host(name, data_port, ctl_port,
                                      col.getsockname()[1], cap,
                                      args.log_dir, args.model_path, extra)
            ctl = HostControl(("127.0.0.1", ctl_port))
            ctl.wait_ready(180)
            ctls[name] = ctl
            if router is not None:
                router.add_host(name, ("127.0.0.1", data_port), ctl, cap,
                                standby=name == "B")
            print(f"host {name} ready (data :{data_port}, "
                  f"control :{ctl_port}"
                  + (", standby" if name == "B" else "") + ")", flush=True)
        if args.controller:
            controller, adm = _spawn_controller(
                ports, cap, snap_dir, args.log_dir, args.watch_every)
            print("fleet controller up (third process)", flush=True)

        def admit(sid):
            return adm.seat("admit", sid) if adm else router.admit(sid)

        def locate(sid):
            return adm.seat("locate", sid) if adm else router.locate(sid)

        # Seat every caller: B is a warm standby, so they all land on A.
        seats = {c: admit(f"caller{c}") for c in range(cap)}
        assert all(s[0] == "A" for s in seats.values()), (
            "expected all callers seated on A")

        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        ticks_each = int(args.seconds_each / 0.02)
        seq = 0
        t_migrate = None

        def send_tick():
            # Real callers aim at their cached seat; a migration re-aims
            # them via the explicit locate() refresh after the cutover.
            nonlocal seq
            cycle = packets[seq % len(packets)]
            for c in range(cap):
                _, data_addr, slot = seats[c]
                tx.sendto(slot.to_bytes(2, "big") + seq.to_bytes(4, "big")
                          + cycle[c], data_addr)
            seq += 1

        next_tick = time.perf_counter()
        for _ in range(ticks_each):
            while time.perf_counter() < next_tick:
                time.sleep(0.001)
            next_tick = max(next_tick, time.perf_counter()) + 0.02
            send_tick()

        t_migrate = time.perf_counter()
        if args.failover and adm is not None:
            # The controller's watchdog owns detection AND recovery; this
            # process behaves like a real caller — keeps streaming at the
            # dead address on the 20 ms grid and polls locate until its
            # seat flips to the standby.
            procs["A"].kill()  # simulated crash: no drain, no goodbye
            procs["A"].wait(timeout=30)
            flip_deadline = time.perf_counter() + 30
            next_tick = time.perf_counter()
            while True:
                while time.perf_counter() < next_tick:
                    time.sleep(0.001)
                next_tick = max(next_tick, time.perf_counter()) + 0.02
                send_tick()
                if seq % 3 == 0 and locate("caller0")[0] != "A":
                    break
                if time.perf_counter() > flip_deadline:
                    raise RuntimeError("the watchdog never failed over")
            moved = cap
            verb = ("failed over", "autonomous watchdog detection + "
                                   "stale-snapshot restore")
        elif args.failover:
            procs["A"].kill()  # simulated crash: no drain, no goodbye
            procs["A"].wait(timeout=30)
            while router.alive("A", timeout=0.2, retries=1):
                time.sleep(0.05)  # failure detection: pings stop answering
            moved = router.failover("A", "B", snap)
            verb = ("failed over", "death detection + stale-snapshot "
                                   "restore")
        elif adm is not None:
            moved = adm.request("migrate", src="A", dst="B")["moved"]
            verb = ("migrated", "controller drain + restore")
        else:
            moved = router.migrate("A", "B", snap)
            verb = ("migrated", "control drain + restore")
        for c in range(cap):  # callers re-resolve their seats
            seats[c] = locate(f"caller{c}")
        assert all(s[0] == "B" for s in seats.values())
        t_migrated = time.perf_counter()
        print(f"{verb[0]} {moved} streams A→B in "
              f"{(t_migrated - t_migrate) * 1e3:.0f} ms ({verb[1]})",
              flush=True)
        hosts = (adm.request("stats")["stats"]["hosts"] if adm is not None
                 else router.hosts())
        print(f"hosts after the cutover: {hosts}", flush=True)
        if not args.failover:
            procs["A"].wait(timeout=60)  # drain stops A's serve loop

        next_tick = time.perf_counter()
        for _ in range(ticks_each):
            while time.perf_counter() < next_tick:
                time.sleep(0.001)
            next_tick = max(next_tick, time.perf_counter()) + 0.02
            send_tick()

        b_stats = ctls["B"].stats()
        print(f"host B after cutover: ticks={b_stats['ticks']} "
              f"occupied={b_stats['occupied']}/{b_stats['capacity']} "
              f"jb={b_stats['jb']}", flush=True)
        ctls["B"].quit()
        procs["B"].wait(timeout=60)
    finally:
        if adm is not None:
            try:
                adm.request("quit")
            except (socket.timeout, RuntimeError, OSError):
                pass  # already down; terminate below
            adm.close()
        if controller is not None and controller.poll() is None:
            controller.terminate()
            controller.wait(timeout=30)
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=30)
        col_stop.set()
        col_thread.join(timeout=5)
        col.close()
        if router is not None:
            router.close()
        else:
            for ctl in ctls.values():
                ctl.close()

    # Analysis: per caller, the longest gap between consecutive
    # speech-level downlink hops (tone RMS decodes well above 1000; CNG
    # and PLC-faded hops sit far below).  The only allowed big gap is the
    # cutover, and it must stay under --max_gap_ms.
    failed = False
    for c in range(cap):
        voiced = sorted(tt for (tt, _, slot, rms) in arrivals
                        if slot == c and rms > 1000.0)
        if len(voiced) < 10:
            print(f"caller{c}: only {len(voiced)} voice hops — FAIL")
            failed = True
            continue
        pre = sum(1 for tt in voiced if tt < t_migrate)
        post = len(voiced) - pre
        gaps = np.diff(voiced) * 1e3
        cutover_gap = max(gaps)
        print(f"caller{c}: {pre} voice hops on A, {post} after cutover; "
              f"max gap {cutover_gap:.0f} ms (cutover), p95 steady-state "
              f"{np.percentile(gaps, 95):.0f} ms, budget "
              f"{args.max_gap_ms:.0f} ms")
        if cutover_gap > args.max_gap_ms or post < 10:
            failed = True
    print("MIGRATION " + ("FAILED: audio gap over budget" if failed
                          else "OK: no audio gap beyond the cutover budget"),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
