"""The port's fleet tier (lyra_tpu_torch/tools/fleet.py, fleet_main.py,
client.py) against real port serving hosts, on the CPU.

The JAX package's tests of the fleet tier that need real hosts skip
without the reference weights; these mirror them against the port's
serve_main, each host a thread of this process on the small synthetic
fixture, `device="cpu"`, capacity 2:

  * the control plane end to end (ping / stats / save / restore / drain)
    and an in-process drain → restore migration between two hosts; the
    periodic snapshot and `--restore`; `set_bitrate` on an encode host;
  * fleet_main's admission and its watchdog's failover, and a controller
    restart mid-call in a keyed fleet;
  * FleetCaller's whole lifecycle across a live migration.

Every migration is checked bitwise: the standby's downlink from its first
tick after the restore equals an offline replay — one DecoderServer that
restores the drain snapshot and takes the same jitter-buffer collects
(the snapshot's playout schedule, the datagrams the callers sent after
the cutover).  The callers send those datagrams as one burst that fits
the jitter buffer, so nothing of the check depends on the hosts' timing:
the standby's late and overflow drops must stay 0.

Across packages: a routing journal written by either package's
FleetRouter replays into the other's to the same hosts() / locate()
state; a keyed HostControl of either package drives the other's
serve_main; and the port's FleetRouter migrates a float call from a JAX
serve_main host to a port host, whose PCM is then bitwise the port's
offline replay of the JAX snapshot and within 1 int16 LSB of the JAX
package's own replay (the packages' float audio differs by ~1e-6 of its
range, which the int16 rounding turns into 0 or 1 LSB).
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from lyra_tpu.tools import fleet as jax_fleet
from lyra_tpu.tools import serve_main as jax_serve_main
from lyra_tpu_torch import config, packet
from lyra_tpu_torch.client import FleetCaller
from lyra_tpu_torch.codec.engine import DecoderEngine
from lyra_tpu_torch.tools import serve_main
from lyra_tpu_torch.tools.control_auth import load_key
from lyra_tpu_torch.tools.fleet import ControlError, FleetRouter, HostControl
from lyra_tpu_torch.tools.fleet_main import main as fleet_main
from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer
from lyra_tpu_torch.tools.stream_server import DecoderServer
from lyra_tpu_torch.utils import checkpoint

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
CAP = 2
HDR = 6
DELAY = 2  # the hosts' playout delay
DEPTH = DELAY + 6  # serve_main's jitter-buffer depth
WIDE = config.packet_size(184)
PCM = config.num_samples_per_hop(16000) * 2
# The bound of a wait of its own: every wait here ends when its condition
# holds; in-process CPU hosts tick many times slower under a loaded test
# run, so the bound only catches a hang.
HANG = 300.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The hosts are threads of this process.  With torch's default of one
    intra-op thread per core in every worker of a parallel test run, a
    capacity-2 tick took 1.5-2 s, past the control plane's 2 s timeout,
    and a retried restore ran twice; one thread keeps a tick short."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _control(port):
    """A HostControl for the tests' own RPCs, restore and drain among them,
    which must run once: one attempt, answered at the host's next tick."""
    return HostControl(("127.0.0.1", port), timeout=60.0, retries=1)


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _hdr(slot, seq):
    return int(slot).to_bytes(2, "big") + int(seq).to_bytes(4, "big")


def _packets(seed, n, size=15):
    """n random lyra packets of `size` bytes per slot: [n, CAP] bytes."""
    rng = np.random.default_rng(seed)
    wire = rng.integers(0, 256, (n, CAP, size), dtype=np.uint8)
    return [[wire[i, s].tobytes() for s in range(CAP)] for i in range(n)]


class _Host:
    """A serve_main (the port's, or with `package=jax_serve_main` the JAX
    package's) in a thread of this process: decode at capacity CAP unless
    `extra` says otherwise, a control port, echo to `echo`."""

    def __init__(self, extra=(), echo=None, package=serve_main, key=None):
        self.ctl_port = _free_udp_port()
        argv = ["--capacity", str(CAP), "--seconds", "0",
                "--max_bitrate", "9200", "--model_path", SMALL,
                "--playout_delay", str(DELAY), "--report_every", "30",
                "--control", str(self.ctl_port), *extra]
        if echo is not None:
            argv += ["--echo", echo]
        if key is not None:
            argv += ["--control_key", key]
        kwargs = {"device": "cpu"} if package is serve_main else {}
        self.stop = threading.Event()
        ready, box = threading.Event(), {}
        self.thread = threading.Thread(target=package.main, kwargs=dict(
            argv=argv, _on_ready=lambda p: (box.update(port=p), ready.set()),
            _stop=self.stop, **kwargs))
        self.thread.start()
        assert ready.wait(120), "host never bound its port"
        self.port = box["port"]
        self.addr = ("127.0.0.1", self.port)

    def spec(self, name):
        return f"{name}=127.0.0.1:{self.port}:{self.ctl_port}:{CAP}"

    def join(self):
        self.stop.set()
        self.thread.join(timeout=120)
        assert not self.thread.is_alive(), "serve loop failed to stop"


class _Collector:
    """Every datagram a socket receives, by (slot, seq), read in a thread
    of its own so a ticking host's echo never overflows the socket."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.02)
        self.echo = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.got = {}
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                d = self.sock.recv(65536)
            except socket.timeout:
                continue
            self.got[(int.from_bytes(d[:2], "big"),
                      int.from_bytes(d[2:HDR], "big"))] = d[HDR:]

    def wait(self, pred, stall=60.0, limit=HANG):
        """Until pred() holds.  The hosts tick at the pace the machine
        allows (in-process CPU hosts slow down many times under a loaded
        test run), so the wait fails when no datagram has arrived for
        `stall` seconds — the hosts stopped sending — and, as a bound of
        its own, after `limit` seconds in all."""
        start = last = time.time()
        seen = len(self.got)
        while not pred():
            now = time.time()
            if len(self.got) != seen:
                seen, last = len(self.got), now
            assert now - last < stall, f"no downlink for {stall} s"
            assert now - start < limit, "timed out waiting for downlink"
            time.sleep(0.01)

    def wait_through(self, seq):
        """Until every slot's downlink has reached sequence `seq`; the
        datagrams before it are then in, or lost for good (a host sends
        each slot's hops in sequence order)."""
        self.wait(lambda: all(any(s == slot and q >= seq for s, q in
                                  list(self.got)) for slot in range(CAP)))

    def close(self):
        self._stop.set()
        self._th.join(timeout=10)
        self.sock.close()


def _stream(send, n, recv=None, pace=0.02):
    """n ticks of uplink at the 20 ms pace: send(i) sends tick i's
    datagrams; recv() drains the downlink meanwhile."""
    for i in range(n):
        send(i)
        time.sleep(pace)
        if recv is not None:
            recv()


def _burst(heads, next_seq, seed, least=4):
    """The datagrams of the cutover: per slot the sequences from the
    caller's next one (or the playout head, if later) to the last the
    standby's jitter buffer holds, as (slot, seq, packet) — at least
    `least` of them: a caller further ahead of the drained host's playout
    head (a host that ticked slower than its callers sent) sends again
    from there."""
    out = []
    for slot in range(CAP):
        last = int(heads[slot]) + DEPTH - 1
        first = max(int(heads[slot]),
                    min(int(next_seq[slot]), last + 1 - least))
        pkts = _packets(seed + slot, last - first + 1)
        out += [(slot, seq, pkts[seq - first][slot])
                for seq in range(first, last + 1)]
    return out


def _replay(snap, burst, ticks, server=None, jb_cls=JitterBuffer):
    """The offline replay of a cutover: `server` (a port DecoderServer on
    the CPU by default) restores the drain snapshot, a fresh jitter
    buffer takes the snapshot's playout schedule and the burst, and
    `ticks` collects go through tick_wire → [ticks] int16 [CAP, hop]."""
    if server is None:
        server = DecoderServer(CAP, engine=DecoderEngine(
            16000, SMALL, emit_dtype="int16", max_bitrate=9200,
            device="cpu"))
    transport = server.restore(snap)
    jb = jb_cls(CAP, WIDE, depth=DEPTH)
    for slot, head in enumerate(transport["jb_heads"]):
        assert head >= 0
        jb.add_stream(slot, start_seq=int(head), playout_delay=DELAY)
    for slot, seq, payload in burst:
        assert jb.insert(slot, seq, payload) == 0
    out = []
    for _ in range(ticks):
        pkts, received, sizes = jb.collect()
        out.append(np.asarray(server.tick_wire(pkts, received,
                                               sizes.astype(np.int32))))
    return out


def _resume_seq(got, expected, lo, hi):
    """The standby's downlink sequence of its first tick after the
    restore: its sequence numbers count its own ticks, so the one T in
    [lo, hi] where every received hop (slot, T + i) equals replay tick i.
    → T, and how many hops were compared."""
    found = []
    for t0 in range(lo, hi + 1):
        hops = [(slot, seq) for slot, seq in got
                if t0 <= seq < t0 + len(expected)]
        if hops and all(got[(slot, seq)] == expected[seq - t0][slot]
                        .tobytes() for slot, seq in hops):
            found.append((t0, len(hops)))
    assert len(found) == 1, ("no single resume tick matches the replay",
                             found)
    return found[0]


def _check_cutover(snap, burst, got, lo, hi, stats):
    """The standby's downlink after the restore equals the replay of the
    drain snapshot bit for bit, every hop from its first tick that plays
    a packet on compared; no datagram of the burst came late."""
    assert stats["jb"]["late_drops"] == stats["jb"]["overflow_drops"] == 0
    ticks = DEPTH + DELAY + 2
    expected = _replay(snap, burst, ticks)
    assert max(np.abs(e).max() for e in expected) > 1000  # speech level
    t0, _ = _resume_seq(got, expected, lo, hi)
    missing = [(s, t0 + i) for s in range(CAP) for i in range(DELAY, ticks)
               if (s, t0 + i) not in got]
    assert not missing, missing
    return t0


# ---- the control plane and an in-process migration ---------------------------


def test_control_plane_and_inprocess_migration(tmp_path):
    """Mirror of tests/test_fleet.py::test_control_plane_and_inprocess_
    migration on port hosts: ping/stats on host A, live packets decoding,
    save/restore idempotence, a failed restore leaves A serving; then
    drain A → restore into warm host B, and B's downlink from its first
    tick after the restore is bitwise an offline replay of A's drain
    snapshot taking the same collects."""
    col_a, col_b = _Collector(), _Collector()
    host_a = _Host(echo=col_a.echo)
    ctl_a = _control(host_a.ctl_port)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    pkts = _packets(1, 40)
    host_b = ctl_b = None
    try:
        assert ctl_a.wait_ready(120)["mode"] == "decode"

        def send_a(i):
            for slot in range(CAP):
                tx.sendto(_hdr(slot, i) + pkts[i][slot], host_a.addr)

        _stream(send_a, 12)
        col_a.wait(lambda: len(col_a.got) >= CAP)
        stats = ctl_a.stats()
        assert stats["capacity"] == CAP and stats["ticks"] > 0
        assert stats["ingest"]["datagrams"] > 0

        # save keeps serving; restore of the same snapshot is accepted.
        snap = str(tmp_path / "snapA")
        assert ctl_a.save(snap)["ticks"] >= 0
        assert os.path.exists(snap + ".npz")
        heads = checkpoint.peek_extra(snap)["transport"]["jb_heads"]
        assert len(heads) == CAP and all(h >= 0 for h in heads), heads
        ctl_a.restore(snap)
        with pytest.raises(ControlError):
            ctl_a.restore(str(tmp_path / "missing"))
        assert ctl_a.ping()["ok"]
        _stream(lambda i: send_a(12 + i), 8)

        # Warm standby B, then the migration: drain A, restore into B.
        host_b = _Host(echo=col_b.echo)
        ctl_b = _control(host_b.ctl_port)
        ctl_b.wait_ready(120)
        drain = str(tmp_path / "drainA")
        ctl_a.drain(drain)
        host_a.thread.join(timeout=60)
        assert not host_a.thread.is_alive(), "drained host kept serving"
        heads = checkpoint.peek_extra(drain)["transport"]["jb_heads"]
        lo = ctl_b.stats()["ticks"]
        ctl_b.restore(drain)
        burst = _burst(heads, [20] * CAP, seed=50)
        for slot, seq, payload in burst:
            tx.sendto(_hdr(slot, seq) + payload, host_b.addr)
        col_b.wait_through(lo + DEPTH + DELAY + 11)
        stats = ctl_b.stats()
        assert stats["active"] == CAP  # A's slot table came across
        _check_cutover(drain, burst, col_b.got, lo, lo + 10, stats)
    finally:
        tx.close()
        for host in (host_a, host_b):
            if host is not None:
                host.join()
        ctl_a.close()
        if ctl_b is not None:
            ctl_b.close()
        col_a.close()
        col_b.close()


def test_periodic_snapshot_is_restorable(tmp_path):
    """Mirror of tests/test_fleet.py::test_periodic_snapshot_is_
    restorable: --snapshot writes atomic periodic snapshots a standby of
    the same capacity resumes from after the writer is gone."""
    snap = str(tmp_path / "auto")
    host = _Host(extra=("--snapshot", snap, "--snapshot_every", "0.2"))
    try:
        deadline = time.time() + HANG
        while not os.path.exists(snap + ".npz") and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.exists(snap + ".npz"), "no periodic snapshot"
    finally:
        host.join()
    leftovers = [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert not leftovers, leftovers
    dec = DecoderServer(CAP, model_path=SMALL, device="cpu")
    dec.restore(snap)
    assert dec.num_active == CAP


def test_restore_flag_resumes_snapshot(tmp_path):
    """Mirror of tests/test_fleet.py::test_restore_flag_resumes_snapshot:
    a cold host stands up from a snapshot (its slot table, not a fresh
    admission); set_bitrate on a decode host is refused loudly; a
    capacity mismatch is refused by the server's restore."""
    dec = DecoderServer(CAP, model_path=SMALL, device="cpu")
    dec.add_streams(["x"])  # one seat occupied, one free
    snap = str(tmp_path / "snap")
    dec.save(snap)
    host = _Host(extra=("--restore", snap))
    ctl = _control(host.ctl_port)
    try:
        assert ctl.wait_ready(120)["mode"] == "decode"
        assert ctl.stats()["active"] == 1
        with pytest.raises(ControlError, match="encoder side"):
            ctl.set_bitrate(0, 6000)
    finally:
        host.join()
        ctl.close()
    with pytest.raises(ValueError):
        DecoderServer(4, model_path=SMALL, device="cpu").restore(snap)


def test_set_bitrate_mid_call():
    """Mirror of tests/test_fleet.py::test_set_bitrate_mid_call: an
    encode host changes one stream's downlink bitrate mid-call over the
    control plane — slot 0's packets shrink from 9.2 kbps (23 B) to
    3.2 kbps (8 B) while slot 1 keeps its rate; bad rates and slots are
    refused and the host keeps serving."""
    col = _Collector()
    host = _Host(extra=("--mode", "encode", "--bitrate", "9200",
                        "--max_bitrate", "9200", "--ingest", "python"),
                 echo=col.echo)
    ctl = _control(host.ctl_port)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t = np.arange(320) / 16000.0
    hop = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16).tobytes()
    seq = 0

    def pump_until(slot0_size, deadline_s=HANG):
        """Drive PCM into both slots until slot 0 relays a packet of
        `slot0_size` bytes; → the sizes slot 1 relayed meanwhile."""
        nonlocal seq
        seen, other = set(col.got), set()
        t_end = time.time() + deadline_s
        while time.time() < t_end:
            for slot in range(CAP):
                tx.sendto(_hdr(slot, seq) + hop, host.addr)
            seq += 1
            time.sleep(0.02)
            new = [(k, p) for k, p in list(col.got.items()) if k not in seen]
            seen.update(k for k, _ in new)
            other |= {len(p) for (s, _), p in new if s == 1}
            if any(s == 0 and len(p) == slot0_size for (s, _), p in new):
                return other
        raise AssertionError(f"slot 0 never relayed a {slot0_size}-byte "
                             f"packet")

    try:
        wide, narrow = config.packet_size(184), config.packet_size(64)
        pump_until(wide)
        assert ctl.set_bitrate(0, 3200)["ok"]
        assert pump_until(narrow) == {wide}, "slot 1 should stay at 9.2"
        with pytest.raises(ControlError):
            ctl.set_bitrate(0, 1234)
        with pytest.raises(ControlError):
            ctl.set_bitrate(7, 3200)
        assert ctl.stats()["mode"] == "encode"
    finally:
        tx.close()
        host.join()
        ctl.close()
        col.close()


# ---- fleet_main ---------------------------------------------------------------


class _Fleet:
    """The port's fleet_main in a thread of this process."""

    def __init__(self, argv, port=None):
        self.port = port if port is not None else _free_udp_port()
        self.stop = threading.Event()
        ready = threading.Event()
        self.thread = threading.Thread(target=fleet_main, kwargs=dict(
            argv=[*argv, "--port", str(self.port), "--report_every", "60",
                  "--seconds", "0"],
            _on_ready=lambda port: ready.set(), _stop=self.stop))
        self.thread.start()
        assert ready.wait(120), "controller never came up"
        self.addr = ("127.0.0.1", self.port)

    def join(self):
        self.stop.set()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


def _wait_failover(adm, deadline_s=HANG):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        st = adm.request("stats")["stats"]
        if st["failovers"] == 1:
            return st
        time.sleep(0.1)
    raise AssertionError(f"the watchdog never failed over: {st}")


def test_fleet_admission_and_auto_failover(tmp_path):
    """Mirror of tests/test_fleet_main.py::test_fleet_admission_and_auto_
    failover: admit a caller through the controller (idempotently), kill
    the active host, and the watchdog fails its seat over to the standby
    from the periodic snapshot; locate() then points the caller at the
    standby, where its packets decode; release and quit; the --stats
    sink's final record carries the failover."""
    snap_dir = str(tmp_path)
    col = _Collector()
    host_a = _Host(extra=("--snapshot", os.path.join(snap_dir, "a"),
                          "--snapshot_every", "0.3"), echo=col.echo)
    host_b = _Host(echo=col.echo)
    fleet = _Fleet(["--host", host_a.spec("a"),
                    "--standby", host_b.spec("spare"),
                    "--snapshot_dir", snap_dir, "--watch_every", "0.3",
                    "--wait_ready",
                    "--stats", os.path.join(snap_dir, "fleet.jsonl")])
    adm = HostControl(fleet.addr)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    wire = packet.pack_indices_batch(np.zeros((1, 16), np.int32), 64)[0]
    try:
        seat = adm.request("admit", stream="caller1")
        assert seat["host"] == "a" and seat["addr"] == list(host_a.addr)
        slot = seat["slot"]
        assert adm.request("admit", stream="caller1")["slot"] == slot
        st = adm.request("stats")["stats"]
        assert st["admitted"] == 1 and st["hosts"]["a"]["occupied"] == 1
        assert st["hosts"]["spare"]["standby"] is True

        def send(i, addr):
            tx.sendto(_hdr(slot, i) + wire.tobytes(), addr)

        _stream(lambda i: send(i, host_a.addr), 10)
        col.wait(lambda: any(s == slot for s, _ in col.got))
        deadline = time.time() + HANG
        while (not os.path.exists(os.path.join(snap_dir, "a.npz"))
               and time.time() < deadline):
            time.sleep(0.05)
        host_a.join()  # the crash: its control socket closes

        st = _wait_failover(adm)
        assert st["failover_errors"] == 0, st
        assert "a" not in st["hosts"]
        assert st["hosts"]["spare"]["standby"] is False
        loc = adm.request("locate", stream="caller1")
        assert loc["host"] == "spare" and loc["slot"] == slot
        assert loc["addr"] == list(host_b.addr)

        before = len(col.got)
        _stream(lambda i: send(10 + i, host_b.addr), 10)
        col.wait(lambda: len(col.got) > before + CAP)
        assert all(len(p) == PCM for p in col.got.values())

        assert adm.request("release", stream="caller1")["ok"]
        assert adm.request("quit")["ok"]
        fleet.thread.join(timeout=60)
        with open(os.path.join(snap_dir, "fleet.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        assert lines[-1]["final"] is True and lines[-1]["failovers"] == 1
        assert "spare" in lines[-1]["hosts"]
    finally:
        tx.close()
        adm.close()
        fleet.join()
        host_b.join()
        col.close()


def test_controller_restart_mid_call_then_failover(tmp_path):
    """Mirror of tests/test_fleet_main.py::test_controller_restart_mid_
    call_then_failover, keyed throughout (serve_main --control_key and
    fleet_main --key on one file): the controller dies mid-call and
    restarts on the same --snapshot_dir; the journal gives back the seat
    (locate without re-admission, no double grant), and a later host
    death still fails over through RPCs the second life signs."""
    snap_dir = str(tmp_path)
    key_file = os.path.join(snap_dir, "fleet.key")
    with open(key_file, "wb") as f:
        f.write(os.urandom(32))
    col = _Collector()
    host_a = _Host(extra=("--snapshot", os.path.join(snap_dir, "a"),
                          "--snapshot_every", "0.3"),
                   echo=col.echo, key=key_file)
    host_b = _Host(echo=col.echo, key=key_file)
    argv = ["--host", host_a.spec("a"), "--standby", host_b.spec("spare"),
            "--snapshot_dir", snap_dir, "--watch_every", "0.3",
            "--wait_ready", "--key", key_file]
    fleet = _Fleet(argv)
    adm = HostControl(fleet.addr, key=load_key(key_file))
    fleet2 = None
    try:
        seat = adm.request("admit", stream="caller1")
        assert seat["host"] == "a"
        slot = seat["slot"]
        fleet.join()  # the controller dies mid-call
        fleet2 = _Fleet(argv, port=fleet.port)
        loc = adm.request("locate", stream="caller1")
        assert (loc["host"], loc["slot"]) == ("a", slot)
        seat2 = adm.request("admit", stream="caller2")
        assert (seat2["host"], seat2["slot"]) != ("a", slot)
        st = adm.request("stats")["stats"]
        assert st["hosts"]["a"]["occupied"] == 2
        assert st["hosts"]["spare"]["standby"] is True

        deadline = time.time() + HANG
        while (not os.path.exists(os.path.join(snap_dir, "a.npz"))
               and time.time() < deadline):
            time.sleep(0.05)
        host_a.join()
        _wait_failover(adm)
        loc = adm.request("locate", stream="caller1")
        assert (loc["host"], loc["slot"]) == ("spare", slot)
        # The failover's restore was a signed RPC the host accepted.
        ctl_b = HostControl(("127.0.0.1", host_b.ctl_port),
                            key=load_key(key_file))
        assert ctl_b.stats()["auth_rejects"] == 0
        ctl_b.close()
        assert adm.request("quit")["ok"]
        fleet2.thread.join(timeout=60)
    finally:
        adm.close()
        for f in (fleet, fleet2):
            if f is not None:
                f.join()
        host_b.join()
        col.close()


def test_fleet_caller_end_to_end_with_live_migration(tmp_path):
    """Mirror of tests/test_client.py::test_fleet_caller_end_to_end_with_
    live_migration: port decode hosts with --echo reply behind the port's
    fleet_main; FleetCallers admit, uplink on the 20 ms grid and receive
    their own PCM; the controller's migrate verb drains A into warm
    standby B; each caller relocates, and B's downlink to it from its
    first tick after the restore is bitwise the offline replay of A's
    drain snapshot."""
    snap_dir = str(tmp_path)
    host_a = _Host(echo="reply")
    host_b = _Host(echo="reply")
    fleet = _Fleet(["--host", host_a.spec("a"), "--standby", host_b.spec("b"),
                    "--snapshot_dir", snap_dir, "--wait_ready",
                    "--watch_every", "0"])
    callers = []
    ctl_b = _control(host_b.ctl_port)
    pkts = _packets(2, 40)
    try:
        callers = [FleetCaller(fleet.addr, f"caller{c}") for c in range(CAP)]
        assert [c.host for c in callers] == ["a", "a"]
        assert sorted(c.slot for c in callers) == list(range(CAP))
        got = {c.slot: {} for c in callers}

        def recv():
            for c in callers:
                for seq, payload in c.recv():
                    got[c.slot][seq] = payload

        def send(i):
            for c in callers:
                c.send_packet(pkts[i][c.slot])

        _stream(send, 20, recv)
        deadline = time.time() + HANG
        tick = 20
        while not all(got.values()):
            assert time.time() < deadline, "no downlink PCM from host A"
            # The uplink goes on, as a caller's does: a host that ticked
            # past the callers' first sequences before they arrived drops
            # them as near-late until 25 in a row resync its schedule
            # (native/jitter_buffer.cc, kNearLateResyncAfter), and with
            # --echo reply a slot without an accepted datagram has no
            # route for its downlink.
            send(tick % len(pkts))
            tick += 1
            recv()
            time.sleep(0.02)
        assert all(len(p) == PCM for g in got.values() for p in g.values())

        adm = HostControl(fleet.addr)
        lo = ctl_b.stats()["ticks"]
        assert adm.request("migrate", src="a", dst="b")["moved"] == CAP
        adm.close()
        drain = os.path.join(snap_dir, "a.drain")
        heads = checkpoint.peek_extra(drain)["transport"]["jb_heads"]
        next_seq = [0] * CAP
        for c in callers:
            assert c.relocate() and c.host == "b"
            next_seq[c.slot] = c.seq
        burst = _burst(heads, next_seq, seed=60)
        by_slot = {c.slot: c for c in callers}
        for slot, seq, payload in burst:
            caller = by_slot[slot]
            caller.seq = seq
            caller.send_packet(payload)
        got = {c.slot: {} for c in callers}
        deadline = time.time() + HANG
        while min(len(g) for g in got.values()) < DEPTH + DELAY + 4:
            assert time.time() < deadline, "no downlink PCM from host B"
            recv()
            time.sleep(0.02)
        flat = {(slot, seq): p for slot, g in got.items()
                for seq, p in g.items()}
        _check_cutover(drain, burst, flat, lo, lo + 10, ctl_b.stats())
        for c in callers:
            c.release()
    finally:
        for c in callers:
            c.close()
        ctl_b.close()
        fleet.join()
        host_a.join()
        host_b.join()


# ---- across packages ---------------------------------------------------------


class _FakeControl:
    """Duck-typed HostControl (tests/test_fleet.py's pattern)."""

    def __init__(self, addr=("127.0.0.1", 1001)):
        self.addr = tuple(addr)

    def request(self, cmd, _timeout=None, _retries=None, **fields):
        return {"ok": True}

    def drain(self, path):
        return {"ok": True}

    def restore(self, path):
        return {"ok": True}

    def close(self):
        pass


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A routing journal written by either package's FleetRouter —
    admissions with and without seat tokens, room blocks, a release, a
    whole-host migration, a host removed — replays into the other
    package's router to the same hosts() and the same locate() of every
    seated stream; the reader then journals on, and the writer's package
    replays the result."""
    from lyra_tpu_torch.tools import fleet as port_fleet

    mods = {"jax": jax_fleet, "port": port_fleet}
    src, dst = mods[writer], mods["port" if writer == "jax" else "jax"]
    path = str(tmp_path / "journal.jsonl")
    r = src.FleetRouter(src.FleetJournal(path))
    r.add_host("a", ("127.0.0.1", 5001), _FakeControl(("127.0.0.1", 6001)),
               4)
    r.add_host("b", ("127.0.0.1", 5002), _FakeControl(("127.0.0.1", 6002)),
               4, standby=True)
    r.add_host("c", ("127.0.0.1", 5003), _FakeControl(("127.0.0.1", 6003)),
               4, room_size=2)
    r.add_host("d", ("127.0.0.1", 5004), _FakeControl(("127.0.0.1", 6004)),
               4)
    for i in range(4):
        r.admit(f"s{i}", token=f"tok{i}" if i % 2 else None)
    r.admit("alice", room="R1")
    r.admit("bob", room="R1")
    r.release("s2")
    r.migrate("a", "b", str(tmp_path / "snap"))
    r.remove_host("a")
    streams = ["s0", "s1", "s3", "alice", "bob"]

    def state(router):
        return (router.hosts(), {
            s: router.locate(s, token=f"tok{s[1:]}"
                             if s in ("s1", "s3") else None)
            for s in streams})

    want = state(r)
    r2, open_hosts = dst.FleetRouter.replay(
        path, journal=dst.FleetJournal(path), control_factory=_FakeControl)
    assert open_hosts == []
    assert state(r2) == want
    with pytest.raises(PermissionError):
        r2.locate("s1", token="wrong")
    r2.admit("s4")
    streams.append("s4")
    r3, _ = src.FleetRouter.replay(path, control_factory=_FakeControl)
    assert state(r3) == state(r2) != want


@pytest.mark.parametrize("client", ["port", "jax"])
def test_keyed_host_control_crosses_packages(tmp_path, client):
    """A keyed HostControl of either package drives the other package's
    serve_main (--control_key on one shared file): ping, stats and a save
    the other package's checkpoint reader opens; a request signed with
    another key is refused and counted, and the host keeps serving."""
    from lyra_tpu.utils import checkpoint as jax_checkpoint

    key_file = str(tmp_path / "ctl.key")
    with open(key_file, "wb") as f:
        f.write(os.urandom(32))
    other = str(tmp_path / "other.key")
    with open(other, "wb") as f:
        f.write(os.urandom(32))
    ctl_cls = HostControl if client == "port" else jax_fleet.HostControl
    host = _Host(package=jax_serve_main if client == "port" else serve_main,
                 key=key_file)
    addr = ("127.0.0.1", host.ctl_port)
    ctl = ctl_cls(addr, key=load_key(key_file))
    # One attempt, so the refusal is counted once; the host answers at its
    # next tick, which a loaded test run can delay by seconds.
    bad = ctl_cls(addr, key=load_key(other), retries=1, timeout=60.0)
    try:
        assert ctl.wait_ready(120)["mode"] == "decode"
        snap = str(tmp_path / "snap")
        assert ctl.save(snap)["ok"]
        reader = checkpoint if client == "jax" else jax_checkpoint
        assert len(reader.peek_extra(snap)["transport"]["jb_heads"]) == CAP
        with pytest.raises(RuntimeError, match="auth"):
            bad.ping()
        st = ctl.stats()
        assert st["auth_rejects"] == 1 and st["capacity"] == CAP
    finally:
        host.join()
        ctl.close()
        bad.close()


def test_migrate_jax_host_to_port_host(tmp_path):
    """The port's FleetRouter migrates a float call from a JAX serve_main
    host to a port serve_main host: the JAX host drains to its own
    snapshot format, the port host restores it, and the port host's PCM
    from its first tick after the restore is bitwise the port's offline
    replay of that snapshot and within 1 int16 LSB of the JAX package's
    DecoderServer replaying the same snapshot and collects."""
    from lyra_tpu.codec.engine import DecoderEngine as JaxDecoderEngine
    from lyra_tpu.tools.jitter_buffer import JitterBuffer as JaxJitterBuffer
    from lyra_tpu.tools.stream_server import DecoderServer as JaxDecoderServer

    col_a, col_b = _Collector(), _Collector()
    host_a = _Host(package=jax_serve_main, echo=col_a.echo)
    host_b = _Host(echo=col_b.echo)
    router = FleetRouter()
    router.add_host("A", host_a.addr, _control(host_a.ctl_port), CAP)
    router.add_host("B", host_b.addr, _control(host_b.ctl_port), CAP,
                    standby=True)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    pkts = _packets(3, 40)
    try:
        seats = [router.admit(f"c{i}") for i in range(CAP)]
        assert {s[0] for s in seats} == {"A"}
        router.control("A").wait_ready(120)
        router.control("B").wait_ready(120)

        def send(i):
            for _, addr, slot in seats:
                tx.sendto(_hdr(slot, i) + pkts[i][slot], addr)

        _stream(send, 20)
        col_a.wait(lambda: len(col_a.got) >= CAP)
        lo = router.control("B").stats()["ticks"]
        snap = str(tmp_path / "A.drain")
        assert router.migrate("A", "B", snap) == CAP
        heads = checkpoint.peek_extra(snap)["transport"]["jb_heads"]
        seats = [router.locate(f"c{i}") for i in range(CAP)]
        assert {s[0] for s in seats} == {"B"}
        burst = _burst(heads, [20] * CAP, seed=70)
        for slot, seq, payload in burst:
            tx.sendto(_hdr(slot, seq) + payload, host_b.addr)
        ticks = DEPTH + DELAY + 2
        col_b.wait_through(lo + ticks + 9)
        t0 = _check_cutover(snap, burst, col_b.got, lo, lo + 10,
                            router.control("B").stats())
        jax_dec = JaxDecoderServer(CAP, engine=JaxDecoderEngine(
            16000, SMALL, emit_dtype="int16", max_bitrate=9200))
        ref = _replay(snap, burst, ticks, server=jax_dec,
                      jb_cls=JaxJitterBuffer)
        for i, want in enumerate(ref):
            got = np.stack([np.frombuffer(col_b.got[(s, t0 + i)], np.int16)
                            for s in range(CAP)])
            assert np.abs(got.astype(np.int32) - want).max() <= 1, i
    finally:
        tx.close()
        host_b.join()
        if host_a.thread.is_alive():
            host_a.join()
        router.close()
        col_a.close()
        col_b.close()
