"""The port's serving process vs the JAX package's, on the CPU.

Transport (the native facade over native/, shared by both packages, each
loading its own build): the port's JitterBuffer, UdpIngest, PcmIngest and
UdpEgress run the same datagram script as the JAX ones — collect outputs,
return codes and stats identical, egress datagrams byte-identical on a
loopback socket; so do the shard groups (ShardedUdpIngest,
ShardedPcmIngest fed by `blast`) and MultiEgress.  control_auth: a
message signed by either package verifies in the other, a tampered one
fails in both.

serve_main (lyra_tpu_torch/tools/serve_main.py) runs in-process in a
thread on the small synthetic fixture at capacity 4, `device="cpu"`:

  * decode and bridge read a preloaded timeline: every datagram is sent
    before the first tick, so the jitter buffer holds the whole script
    when the loop starts (checked: no late or overflow drop) and the run
    is exactly reproducible; the echoed output must equal, bit for bit,
    an offline replay of the same datagrams through the port's own
    JitterBuffer and DecoderServer / ConferenceBridge; decode also runs
    over an ingest shard group with striped or per-shard reply egress;
  * the encode relay gets one constant hop per slot, sent every 2 ms by a
    process of its own, so each tick finds a fresh hop for every slot
    (checked: pcm_gaps 0) and its packets must equal an offline replay
    through an EncoderServer;
  * the stats records carry the JAX keys (and, with --trace, a "trace"
    dict of span percentiles and counters); the argument refusals hold.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from lyra_tpu.tools import control_auth as jax_auth
from lyra_tpu.tools import jitter_buffer as jax_jb
from lyra_tpu.tools import serve_main as jax_serve_main
from lyra_tpu.tools import udp_egress as jax_egress
from lyra_tpu.tools import udp_ingest as jax_ingest
from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.tools import control_auth, serve_main, udp_egress, udp_ingest
from lyra_tpu_torch.tools.conference import ConferenceBridge
from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils import native, trace

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
CAP = 4
HDR = 6
WIDE = config.packet_size(184)  # the serving jitter buffer's row width
# The stats record keys of the JAX serve_main's _snapshot per mode
# (lyra_tpu/tools/serve_main.py), before the optional ones.
STATS_KEYS = {
    "decode": {"mode", "ts", "ticks", "tick_ms_p50", "tick_ms_p95",
               "budget_ms", "capacity", "occupied", "active", "ingest", "jb",
               "egress", "bad_packets", "final"},
    "encode": {"mode", "ts", "ticks", "tick_ms_p50", "tick_ms_p95",
               "budget_ms", "capacity", "occupied", "active", "pcm_gaps",
               "ingest", "egress", "final"},
    "bridge": {"mode", "ts", "ticks", "tick_ms_p50", "tick_ms_p95",
               "budget_ms", "capacity", "occupied", "active", "room_size",
               "ingest", "jb", "egress", "bad_packets", "final"},
}


def _hdr(slot, seq):
    return int(slot).to_bytes(2, "big") + int(seq).to_bytes(4, "big")


def _script(seed, cap, seqs):
    """A datagram script: (slot, seq, payload) in send order — packets of
    8, 15 and 23 bytes and a few of an unknown size, ~15% lost, the
    sequences sent out of order."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([8, 15, 23], (seqs, cap))
    sizes[rng.random((seqs, cap)) < 0.05] = 5  # malformed: a counted drop
    sent = rng.random((seqs, cap)) >= 0.15
    wire = rng.integers(0, 256, (seqs, cap, WIDE), dtype=np.uint8)
    out = []
    for seq in rng.permutation(seqs):
        for slot in range(cap):
            if sent[seq, slot]:
                out.append((slot, int(seq),
                            wire[seq, slot, :sizes[seq, slot]].tobytes()))
    return out


def _recv_all(sock, n, timeout=10.0):
    got, deadline = [], time.time() + timeout
    sock.settimeout(0.05)
    while len(got) < n and time.time() < deadline:
        try:
            got.append(sock.recvfrom(4096)[0])
        except socket.timeout:
            pass
    return got


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "timed out"
        time.sleep(0.005)


# ---- transport ---------------------------------------------------------------


def test_native_library_builds_into_the_port():
    lib = native.load()
    assert lib is not None
    path = native.lib_path()
    assert os.path.exists(path) and path.startswith(native.BUILD_DIR)
    assert os.path.dirname(path) != os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "native"))
    idx = np.random.default_rng(0).integers(0, 16, (7, 46)).astype(np.int32)
    for bits in (64, 120, 184):
        wire = packet.pack_indices_batch(idx, bits)
        np.testing.assert_array_equal(
            wire, packet.pack_indices_batch_np(idx, bits))
        np.testing.assert_array_equal(
            packet.unpack_indices_batch(wire, bits), idx[:, :bits // 4])


def test_jitter_buffer_matches_jax():
    """The same inserts (plain, RED copies, reordered, duplicate, late,
    too far ahead, inactive and out-of-range slots) and collects, with
    adaptive playout on: every return, collect, stat and export equal."""
    bufs = [JitterBuffer(CAP, WIDE, depth=8), jax_jb.JitterBuffer(CAP, WIDE, 8)]
    for jb in bufs:
        for slot in range(3):
            jb.add_stream(slot, start_seq=slot, playout_delay=slot % 3)
        jb.set_adaptive(1, 5, window=4)
    rng = np.random.default_rng(1)
    for tick in range(40):
        for _ in range(rng.integers(0, 7)):
            slot = int(rng.integers(0, CAP))
            seq = int(tick + rng.integers(-4, 12))
            data = rng.integers(0, 256, int(rng.choice([0, 8, 15, 23])),
                                dtype=np.uint8).tobytes()
            red = rng.random() < 0.2
            rcs = [(jb.insert_red if red else jb.insert)(slot, seq, data)
                   for jb in bufs]
            assert rcs[0] == rcs[1], (tick, slot, seq, red)
        if tick == 20:
            for jb in bufs:
                jb.remove_stream(1)
                jb.add_stream(3, start_seq=30, playout_delay=2)
                jb.adapt_seed(0, 3, 1)
        outs = [jb.collect() for jb in bufs]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        assert bufs[0].stats() == bufs[1].stats()
        assert bufs[0].adapt_stats() == bufs[1].adapt_stats()
        np.testing.assert_array_equal(bufs[0].heads(), bufs[1].heads())
    assert bufs[0].red_heals == bufs[1].red_heals > 0
    for a, b in zip(bufs[0].adapt_export(), bufs[1].adapt_export()):
        np.testing.assert_array_equal(a, b)
    assert [jb.delay(0) for jb in bufs] == [bufs[1].delay(0)] * 2
    for jb in bufs:
        with pytest.raises(ValueError):
            jb.insert(CAP, 0, b"x")
        with pytest.raises(ValueError):
            jb.set_adaptive(3, 1)


@pytest.mark.parametrize("red", [0, 1])
def test_udp_ingest_matches_jax(red):
    """Both pumps receive the same datagram script (RED-framed with
    `red`), plus junk: a short header, a slot past capacity, a ragged RED
    block; then the same collects give the same matrices and stats."""
    pumps = []
    for mod, jbm in ((udp_ingest, JitterBuffer), (jax_ingest, jax_jb.JitterBuffer)):
        pump = mod.UdpIngest(jbm(CAP, WIDE, 12))
        for slot in range(CAP):
            pump.add_stream(slot, playout_delay=2)
        if red:
            pump.set_red(red)
        pumps.append(pump)
    script = _script(2, CAP, 10)
    by_key = {(s, q): p for s, q, p in script}
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dgrams = []
    for slot, seq, payload in script:
        if red:
            payload = packet.build_red(payload, by_key.get((slot, seq - 1), b""))
        dgrams.append(_hdr(slot, seq) + payload)
    dgrams += [b"\x00\x01", _hdr(CAP + 3, 0) + b"\x00" * 8,
               _hdr(0, 1) + (b"\x09ab" if red else b"\x00" * 64)]
    try:
        for d in dgrams:
            for pump in pumps:
                tx.sendto(d, ("127.0.0.1", pump.port))
        for pump in pumps:
            _wait(lambda p=pump: p.stats()["datagrams"]
                  + p.stats()["malformed_drops"] == len(dgrams))
        for _ in range(14):
            outs = [pump.collect() for pump in pumps]
            for a, b in zip(*outs):
                np.testing.assert_array_equal(a, b)
        assert pumps[0].stats() == pumps[1].stats()
        assert pumps[0].jb_stats() == pumps[1].jb_stats()
        assert pumps[0].red_heals == pumps[1].red_heals
        assert pumps[0].stats()["malformed_drops"] >= 2
        np.testing.assert_array_equal(pumps[0].heads(), pumps[1].heads())
    finally:
        tx.close()
        for pump in pumps:
            pump.close()


def test_pcm_ingest_matches_jax():
    """Latest-wins by sequence, stale drops, wrong-size datagrams and the
    3-stale resync: the same script gives the same collects and stats."""
    hop = 64
    pumps = [udp_ingest.PcmIngest(CAP, hop * 2),
             jax_ingest.PcmIngest(CAP, hop * 2)]
    rng = np.random.default_rng(3)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for rnd in range(4):
            dgrams = []
            for _ in range(12):
                slot = int(rng.integers(0, CAP))
                seq = int(rnd * 10 + rng.integers(-6, 6)) % 1000
                n = hop if rng.random() > 0.1 else hop - 1
                pcm = rng.integers(-32768, 32767, n).astype(np.int16)
                dgrams.append(_hdr(slot, seq) + pcm.tobytes())
            for d in dgrams:
                for pump in pumps:
                    tx.sendto(d, ("127.0.0.1", pump.port))
            for pump in pumps:
                _wait(lambda p=pump: sum(p.stats()[k] for k in (
                    "datagrams", "malformed_drops")) == 12 * (rnd + 1))
            audio = [np.zeros((CAP, hop), np.int16) for _ in pumps]
            fresh = [p.collect_into(a) for p, a in zip(pumps, audio)]
            np.testing.assert_array_equal(fresh[0], fresh[1])
            np.testing.assert_array_equal(audio[0], audio[1])
            assert pumps[0].stats() == pumps[1].stats()
    finally:
        tx.close()
        for pump in pumps:
            pump.close()


def test_sharded_transport_matches_jax():
    """The shard groups and striped egress against the JAX ones: the same
    datagram script, one socket per slot, into a ShardedUdpIngest of each
    package (collects and summed stats equal, whichever shard the kernel
    hashed a flow to); `blast` from each package into a ShardedPcmIngest
    of each; one wire matrix through MultiEgress of each (the same
    datagrams, each row once)."""
    groups = [mod.ShardedUdpIngest(CAP, WIDE, 12, shards=2)
              for mod in (udp_ingest, jax_ingest)]
    pcms = [mod.ShardedPcmIngest(CAP, 64, shards=2)
            for mod in (udp_ingest, jax_ingest)]
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(CAP)]
    script = _script(9, CAP, 10)
    try:
        for group in groups:
            for slot in range(CAP):
                group.add_stream(slot, playout_delay=2)
        for slot, seq, payload in script:
            for group in groups:
                socks[slot].sendto(_hdr(slot, seq) + payload,
                                   ("127.0.0.1", group.port))
        for group in groups:
            _wait(lambda g=group: g.stats()["datagrams"]
                  + g.stats()["malformed_drops"] == len(script))
        for _ in range(14):
            outs = [group.collect() for group in groups]
            for a, b in zip(*outs):
                np.testing.assert_array_equal(a, b)
        assert groups[0].stats() == groups[1].stats()
        assert groups[0].jb_stats() == groups[1].jb_stats()
        assert groups[0].num_shards == groups[1].num_shards == 2

        sent = [mod.blast(pcm.port, CAP * 3, 64, CAP, sources=CAP)
                for mod, pcm in zip((udp_ingest, jax_ingest), pcms)]
        assert sent == [CAP * 3] * 2
        for pcm in pcms:
            _wait(lambda p=pcm: p.stats()["datagrams"] == CAP * 3)
        audio = [np.full((CAP, 32), 7, np.int16) for _ in pcms]
        fresh = [p.collect_into(a) for p, a in zip(pcms, audio)]
        np.testing.assert_array_equal(fresh[0], fresh[1])
        assert fresh[0].all()
        np.testing.assert_array_equal(audio[0], audio[1])
        assert pcms[0].stats() == pcms[1].stats()
    finally:
        for sock in socks:
            sock.close()
        for obj in (*groups, *pcms):
            obj.close()

    rx = []
    for _ in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        rx.append(s)
    rng = np.random.default_rng(10)
    wire = rng.integers(0, 256, (8, WIDE), dtype=np.uint8)
    sizes = np.array([8, 0, 15, 23, 8, 0, 23, 15], np.int32)
    egs = [mod.MultiEgress(8, threads=3,
                           dest=("127.0.0.1", s.getsockname()[1]))
           for mod, s in ((udp_egress, rx[0]), (jax_egress, rx[1]))]
    try:
        assert [eg.send(wire, sizes, 5) for eg in egs] == [6, 6]
        got = [sorted(_recv_all(s, 6)) for s in rx]
        assert len(got[0]) == 6 and got[0] == got[1]
        assert got[0][0] == _hdr(0, 5) + wire[0, :8].tobytes()
        assert egs[0].stats() == egs[1].stats()
    finally:
        for eg in egs:
            eg.close()
        for s in rx:
            s.close()


def test_udp_egress_matches_jax():
    """One tick's wire matrix (mixed sizes, silent rows, a slot routed
    elsewhere) through both egresses: the same datagrams, byte for byte,
    and the same stats; the same refusals."""
    rx = []
    for _ in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        rx.append(s)
    rng = np.random.default_rng(4)
    wire = rng.integers(0, 256, (8, WIDE), dtype=np.uint8)
    sizes = np.array([8, 0, 15, 23, 8, 0, 23, 15], np.int32)
    pcm = rng.integers(-32768, 32767, (8, 320)).astype(np.int16)
    egs = [mod.UdpEgress(8, ("127.0.0.1", s.getsockname()[1]))
           for mod, s in ((udp_egress, rx[0]), (jax_egress, rx[1]))]
    try:
        sent = [eg.send(wire, sizes, 7) for eg in egs]
        sent += [eg.send(pcm, np.full(8, 640, np.int32), 8) for eg in egs]
        assert sent[0] == sent[1] == 6 and sent[2] == sent[3] == 8
        got = [_recv_all(s, 14) for s in rx]
        assert len(got[0]) == 14 and got[0] == got[1]
        assert got[0][0] == _hdr(0, 7) + wire[0, :8].tobytes()
        assert egs[0].stats() == egs[1].stats()
        for eg in egs:
            with pytest.raises(ValueError):
                eg.send(wire[:, :8], sizes, 9)  # a size over the stride
        with pytest.raises(ValueError):
            udp_egress.UdpEgress(65537)
    finally:
        for eg in egs:
            eg.close()
        for s in rx:
            s.close()


def test_control_auth_crosses_packages(tmp_path):
    key_file = tmp_path / "key"
    key_file.write_bytes(os.urandom(32) + b"\n")
    key = control_auth.load_key(str(key_file))
    assert key == jax_auth.load_key(str(key_file))
    aud = "127.0.0.1:5000"
    msg = {"cmd": "drain", "path": "/tmp/x", "req": 3, "aud": aud}
    for signer in (control_auth, jax_auth):
        signed = signer.sign(msg, key)
        for verifier in (control_auth, jax_auth):
            verifier.Verifier(key, audience=aud).verify(dict(signed))
            for tampered in ({**signed, "cmd": "quit"},
                             {**signed, "mac": "0" * 64},
                             {**signed, "aud": "127.0.0.1:5001"}):
                with pytest.raises(verifier.AuthError):
                    verifier.Verifier(key, audience=aud).verify(tampered)
            with pytest.raises(verifier.AuthError):  # stale
                verifier.Verifier(key, clock=lambda: signed["ts"] + 60.0
                                  ).verify(dict(signed))
    short = tmp_path / "short"
    short.write_bytes(b"x" * 8)
    for mod in (control_auth, jax_auth):
        with pytest.raises(ValueError):
            mod.load_key(str(short))
        mod.require_key_for_routable("127.0.0.1", None, "x")
        with pytest.raises(SystemExit):
            mod.require_key_for_routable("0.0.0.0", None, "x")


# ---- serve_main --------------------------------------------------------------


def _serve(argv, on_ready, want, timeout=60.0, rx=None):
    """Run the port's serve_main in a thread with `argv` + an echo socket
    (or, with `rx`, `argv` names the downlink and `rx` are the sockets it
    reaches); `on_ready(port)` runs in the server thread before its first
    tick.  Receives echoed datagrams until every slot has sequences
    0..want-1, stops the server.  → ({(slot, seq): payload}, the last
    stats record)."""
    import json
    import select
    import tempfile

    if rx is None:
        echo = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        echo.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        echo.bind(("127.0.0.1", 0))
        argv = [*argv, "--echo", f"127.0.0.1:{echo.getsockname()[1]}"]
        rx = [echo]
    tmp = tempfile.TemporaryDirectory()
    stats = os.path.join(tmp.name, "stats.jsonl")
    box, ready, stop = {}, threading.Event(), threading.Event()

    def ready_hook(port):
        box["port"] = port
        on_ready(port)
        ready.set()

    th = threading.Thread(target=serve_main.main, kwargs=dict(
        argv=[*argv, "--capacity", str(CAP), "--seconds", "0",
              "--model_path", SMALL, "--report_every", "30",
              "--stats", stats],
        _on_ready=ready_hook, _stop=stop, device="cpu"))
    th.start()
    got = {}
    try:
        assert ready.wait(timeout), "server never bound its port"
        deadline = time.time() + timeout
        while (len([k for k in got if k[1] < want]) < CAP * want
               and time.time() < deadline):
            for sock in select.select(rx, [], [], 0.01)[0]:
                d = sock.recvfrom(4096)[0]
                got[(int.from_bytes(d[:2], "big"),
                     int.from_bytes(d[2:HDR], "big"))] = d[HDR:]
    finally:
        stop.set()
        th.join(timeout)
        for sock in rx:
            sock.close()
    assert not th.is_alive(), "serve loop failed to stop"
    with open(stats) as f:
        records = [json.loads(line) for line in f]
    tmp.cleanup()
    assert len([k for k in got if k[1] < want]) == CAP * want, sorted(got)
    return got, records[-1]


def _red_prev(script, red):
    """(slot, seq) → the packet a RED datagram carries for seq - red."""
    by_key = {(s, q): p for s, q, p in script}
    return {(s, q): by_key.get((s, q - red), b"") if red else b""
            for s, q, _ in script}


def _preload(script, prev, socks=None):
    """on_ready hook: send every datagram of `script` (RED-framed where
    `prev` holds a redundant block) before the first tick, then give the
    pump time to file them.  With `socks`, slot s sends from socks[s] (one
    flow per slot, as callers do), else all from one socket."""

    def on_ready(port):
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for slot, seq, payload in script:
            if prev:
                payload = packet.build_red(payload, prev[(slot, seq)])
            (socks[slot] if socks else tx).sendto(_hdr(slot, seq) + payload,
                                                  ("127.0.0.1", port))
        tx.close()
        time.sleep(0.2)

    return on_ready


def _replay_collects(script, ticks, delay, prev=None, red=0):
    """The same datagrams through a fresh port JitterBuffer (the parse of
    serve_main's python drain), collected `ticks` times."""
    jb = JitterBuffer(CAP, WIDE, depth=delay + 6)
    for slot in range(CAP):
        jb.add_stream(slot, playout_delay=delay)
    for slot, seq, payload in script:
        jb.insert(slot, seq, payload)
        if red and prev[(slot, seq)] and seq >= red:
            jb.insert_red(slot, seq - red, prev[(slot, seq)])
    return [jb.collect() for _ in range(ticks)], jb.stats()


def _check_stats(rec, mode, *extra):
    assert set(rec) == STATS_KEYS[mode] | set(extra), sorted(rec)
    assert rec["final"] is True and rec["mode"] == mode
    assert rec["capacity"] == CAP and rec["budget_ms"] == 20.0
    assert rec["ticks"] > 0 and rec["tick_ms_p95"] > 0


@pytest.mark.parametrize("ingest,red", [("native", 0), ("python", 0),
                                        ("native", 1)])
def test_serve_main_decode_matches_offline_replay(ingest, red):
    delay = 3
    script = _script(5, CAP, delay + 6)
    want = delay + 6 + 3  # the script's hops, then three lost ones
    argv = ["--ingest", ingest, "--playout_delay", str(delay)]
    prev = _red_prev(script, red)
    if red:
        argv += ["--red", str(red)]
        # Primaries lost on the way; their copies ride the next datagram.
        script = [d for d in script if (d[0] + d[1]) % 4]
    got, rec = _serve(argv, _preload(script, prev if red else None), want)
    _check_stats(rec, "decode", *(("red_heals",) if red else ()))
    assert rec["jb"]["late_drops"] == rec["jb"]["overflow_drops"] == 0
    if ingest == "native":
        assert rec["ingest"]["datagrams"] == len(script)
    _check_decode_replay(got, rec, script, want, delay, prev, red)
    if red:
        assert rec["red_heals"] > 0


def test_serve_main_trace_reports_spans_and_counters():
    """--trace: each record gains a "trace" dict (per span its count and
    the p50 / p95 of its self ms over the interval; the counters), every
    other key and the PCM as without it, and the tracer is off again once
    the run returns."""
    delay = 3
    script = _script(5, CAP, delay + 6)
    want = delay + 6 + 3
    got, rec = _serve(["--ingest", "native", "--playout_delay", str(delay),
                       "--trace"], _preload(script, None), want)
    _check_stats(rec, "decode", "trace")
    spans = rec["trace"]["spans"]
    assert {"serve.collect", "serve.tick", "serve.send", "serve.pace",
            "dec.tick", "dec.unpack", "dec.stage", "graph.replay",
            "dec.fetch", "dec.drain", "host.wait"} <= set(spans)
    for v in spans.values():
        assert v["n"] > 0 and 0 <= v["p50_ms"] <= v["p95_ms"]
    assert spans["serve.tick"]["n"] >= want
    counts = rec["trace"]["counts"]
    assert counts["dec.rows_run"] == CAP * spans["dec.fetch"]["n"]
    assert counts["dec.rows_concealed"] + counts.get(
        "dec.rows_comfort_noise", 0) > 0
    assert not trace.enabled()
    _check_decode_replay(got, rec, script, want, delay)


def _check_decode_replay(got, rec, script, want, delay, prev=None, red=0):
    """The echoed PCM of a decode run equals, bit for bit, the same
    datagrams through a JitterBuffer and a DecoderServer."""
    collects, jb_stats = _replay_collects(script, want, delay, prev, red)
    dec = DecoderServer(CAP, engine=DecoderEngine(
        16000, SMALL, emit_dtype="int16", max_bitrate=9200, device="cpu"))
    dec.add_streams(range(CAP))
    for seq, (pkts, received, sizes) in enumerate(collects):
        audio = dec.tick_wire(pkts, received, sizes.astype(np.int32))
        for slot in range(CAP):
            assert got[(slot, seq)] == audio[slot].tobytes(), (slot, seq)
    assert rec["bad_packets"] == int(dec.bad_packets.sum()) > 0
    assert rec["jb"] == jb_stats


@pytest.mark.parametrize("echo", ["addr", "reply"])
def test_serve_main_decode_sharded_matches_offline_replay(echo):
    """--ingest_shards 2 (an SO_REUSEPORT ShardedUdpIngest) with the
    downlink striped over --egress_threads 2 (MultiEgress) or sent back
    to each caller by its shard (ShardedReplyEgress): each slot sends
    from its own socket, and the merged collects give the same PCM as one
    jitter buffer."""
    delay = 3
    script = _script(8, CAP, delay + 6)
    want = delay + 6 + 3
    socks = []
    for _ in range(CAP):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        socks.append(sock)
    argv = ["--ingest", "native", "--ingest_shards", "2",
            "--playout_delay", str(delay)]
    if echo == "reply":
        got, rec = _serve([*argv, "--echo", "reply"],
                          _preload(script, None, socks), want, rx=socks)
        assert set(rec["egress"]) >= {"sent", "no_route_drops"}
    else:
        try:
            got, rec = _serve([*argv, "--egress_threads", "2"],
                              _preload(script, None, socks), want)
        finally:
            for sock in socks:
                sock.close()
    _check_stats(rec, "decode")
    assert rec["jb"]["late_drops"] == rec["jb"]["overflow_drops"] == 0
    assert rec["ingest"]["datagrams"] == len(script)
    _check_decode_replay(got, rec, script, want, delay)


_SENDER = """
import socket, sys, time
import numpy as np
port, seed, cap = map(int, sys.argv[1:4])
hops = np.random.default_rng(seed).integers(-8000, 8000, (cap, 320)).astype(
    np.int16)
tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
seq = 0
while True:  # a fresh hop per slot every 2 ms until killed
    for slot in range(cap):
        tx.sendto(slot.to_bytes(2, "big") + seq.to_bytes(4, "big")
                  + hops[slot].tobytes(), ("127.0.0.1", port))
    seq += 1
    if seq == 3:
        print("sending", flush=True)
    time.sleep(0.002)
"""


def test_serve_main_encode_relay_matches_offline_replay():
    """The traffic comes from a process of its own (no interpreter lock
    shared with the serve loop), starts before the first tick and
    outlives the serve loop, so every tick finds a fresh hop per slot."""
    import subprocess
    import sys

    seed = 6
    hops = np.random.default_rng(seed).integers(
        -8000, 8000, (CAP, 320)).astype(np.int16)
    procs = []

    def on_ready(port):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _SENDER, str(port), str(seed), str(CAP)],
            stdout=subprocess.PIPE, text=True))
        assert procs[0].stdout.readline().strip() == "sending"

    want = 8
    try:
        got, rec = _serve(["--mode", "encode", "--bitrate", "6000"],
                          on_ready, want)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(10)
    _check_stats(rec, "encode")
    assert rec["pcm_gaps"] == 0, rec
    enc = EncoderServer(CAP, engine=EncoderEngine(
        16000, SMALL, max_bitrate=9200, device="cpu"), bitrate=6000)
    enc.add_streams(range(CAP))
    for t in range(want):
        wire, sizes = enc.tick_wire(hops)
        for slot in range(CAP):
            assert got[(slot, t)] == wire[slot, :sizes[slot]].tobytes()


def test_serve_main_bridge_matches_offline_replay():
    delay = 2
    script = _script(7, CAP, delay + 6)
    want = delay + 6 + 2
    got, rec = _serve(["--mode", "bridge", "--room_size", "2", "--bitrate",
                       "6000", "--playout_delay", str(delay)],
                      _preload(script, None), want)
    _check_stats(rec, "bridge")
    assert rec["room_size"] == 2
    assert rec["jb"]["late_drops"] == rec["jb"]["overflow_drops"] == 0
    collects, _ = _replay_collects(script, want, delay)
    bridge = ConferenceBridge(
        CAP, bitrate=6000,
        dec_engine=DecoderEngine(16000, SMALL, max_bitrate=9200,
                                 emit_dtype="int16", device="cpu"),
        enc_engine=EncoderEngine(16000, SMALL, max_bitrate=9200,
                                 device="cpu"))
    bridge.add_participants({slot: slot // 2 for slot in range(CAP)})
    for seq, (pkts, received, sizes) in enumerate(collects):
        wire, out_sizes = bridge.tick_wire(pkts, received,
                                           sizes.astype(np.int32))
        for slot in range(CAP):
            assert got[(slot, seq)] == wire[slot, :out_sizes[slot]].tobytes()
    assert rec["bad_packets"] == int(bridge.bad_packets.sum())


@pytest.mark.parametrize("argv", [
    ["--devices", "2"],
    ["--echo", "reply", "--ingest", "python"],
    ["--echo", "reply", "--egress", "python"],
    ["--mode", "bridge", "--sample_rate_hz", "8000"],
    ["--mode", "encode", "--adaptive", "1:4"],
    ["--red", "2", "--playout_delay", "2"],
    ["--control_key", "/nonexistent"],
    ["--ingest_shards", "2", "--ingest", "python"],
])
def test_serve_main_refusals(argv, capsys, monkeypatch):
    """Refused before any engine is built, each the way the JAX host
    refuses it: at parse time, or --devices N with fewer than N cards
    attached (one here, faked) with the JAX host's ValueError."""
    if argv[:2] == ["--devices", "2"]:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError) as exc:
            serve_main.main([*argv, "--model_path", SMALL], device="cuda")
        assert str(exc.value) == "--devices=2 but only 1 are attached"
        return
    with pytest.raises(SystemExit) as exc:
        serve_main.main([*argv, "--model_path", SMALL], device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as ref:
        jax_serve_main.main([*argv, "--model_path", SMALL])
    assert ref.value.code == 2
    assert capsys.readouterr().err.splitlines()[-1].split(": error: ")[1] == \
        err.splitlines()[-1].split(": error: ")[1]


def _cn_enters(pre, post):
    """[CAP] bool: rows whose hop from decoder state `pre` to `post` has
    comfort noise in it (the engine's run_cng)."""
    from lyra_tpu_torch.codec.engine import FADE_TO_CNG

    return ((post["fade_dir"] == FADE_TO_CNG) | (pre["fade"] != 0)).numpy()


@pytest.mark.parametrize("mode", ["decode", "bridge"])
def test_serve_main_devices_2_matches_one_engine_replay(mode):
    """--devices 2, here the CPU named twice (two shards of CAP / 2 slots,
    ShardedEngine pairs, the bridge's shard-local mixer): the downlink
    equals the offline replay over one unsharded engine, which --devices 1
    equals bit for bit (the tests above) — bitwise, but within 1 int16
    LSB in a hop with comfort noise in it (decode) and in a room that has
    had comfort noise (bridge): the noise estimator's and the comfort-
    noise generator's matmuls sum in another order at another row count
    (tests/test_torch_sharding.py).  Rooms that do not tile the shards
    are refused before any engine is built."""
    delay = 2
    script = _script(12, CAP, delay + 6)
    want = delay + 6 + 3
    argv = ["--playout_delay", str(delay), "--devices", "2"]
    if mode == "bridge":
        argv += ["--mode", "bridge", "--room_size", "2", "--bitrate", "6000"]
        with pytest.raises(ValueError, match="does not tile 2 shards"):
            serve_main.main(["--mode", "bridge", "--room_size", "3",
                             "--devices", "2", "--capacity", str(CAP),
                             "--model_path", SMALL], device="cpu")
    got, rec = _serve(argv, _preload(script, None), want)
    assert rec["jb"]["late_drops"] == rec["jb"]["overflow_drops"] == 0
    collects, _ = _replay_collects(script, want, delay)
    dec_e = DecoderEngine(16000, SMALL, max_bitrate=9200, emit_dtype="int16",
                          device="cpu")
    if mode == "decode":
        dec = DecoderServer(CAP, engine=dec_e)
        dec.add_streams(range(CAP))
    else:
        dec = ConferenceBridge(CAP, bitrate=6000, dec_engine=dec_e,
                               enc_engine=EncoderEngine(
                                   16000, SMALL, max_bitrate=9200,
                                   device="cpu"))
        dec.add_participants({slot: slot // 2 for slot in range(CAP)})
    tainted = np.zeros(CAP // 2, bool)
    for seq, (pkts, received, sizes) in enumerate(collects):
        server = dec if mode == "decode" else dec._dec
        pre = server._state
        out = dec.tick_wire(pkts, received, sizes.astype(np.int32))
        cn = _cn_enters(pre, server._state)
        tainted[np.flatnonzero(cn) // 2] = True
        for slot in range(CAP):
            if mode == "decode":
                hop = np.frombuffer(got[(slot, seq)], np.int16)
                if cn[slot]:
                    assert np.abs(hop.astype(np.int32)
                                  - out[slot].astype(np.int32)).max() <= 1
                else:
                    assert got[(slot, seq)] == out[slot].tobytes()
            elif not tainted[slot // 2]:
                wire, sizes_out = out
                assert got[(slot, seq)] == \
                    wire[slot, :sizes_out[slot]].tobytes()
    assert rec["bad_packets"] == int(dec.bad_packets.sum()) > 0
