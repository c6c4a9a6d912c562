"""The port's serving core vs the JAX package's, on the CPU.

The port's DecoderServer / EncoderServer (lyra_tpu_torch/tools/
stream_server.py) run eagerly here (their engines' `graphs` is None on
the CPU); the JAX servers run with injected JAX engines on the same small
synthetic fixture (tests/golden/synthetic_lyra/small).  Bars:

  * host codecs and RED framing: bytes identical;
  * encoder wire bytes and sizes from the same pre-tick state: identical,
    but a row may differ at an RVQ near-tie (the features agree to float32
    tolerance, as in tests/test_torch_engine.py);
  * decoder audio from the same pre-tick state: within 1 int16 LSB, and
    the comfort-noise flags, bad_packets and inactive_drops equal;
  * snapshots cross between the packages in float mode and continue
    within the same bars; bf16 snapshots round-trip bit for bit;
  * ServerPool (uniform and mixed-rate waves) and ConferenceBridge
    (tick_wire and the async pipeline) against the JAX ones from the same
    pre-tick state, within the same bars; the bridge also bitwise equal to
    the port's own servers composed through host PCM, and the torch mixer
    bitwise equal to mix_minus_one_np and the JAX mixer.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu import packet as jax_packet
from lyra_tpu.codec.engine import DecoderEngine as JaxDecoder
from lyra_tpu.codec.engine import EncoderEngine as JaxEncoder
from lyra_tpu.dsp import utils as jax_dsp_utils
from lyra_tpu.tools import stream_server as jax_server
from lyra_tpu.utils import checkpoint as jax_checkpoint
from lyra_tpu_torch import packet
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.tools.stream_server import (
    DecoderServer,
    EncoderServer,
    ServerPool,
)
from lyra_tpu_torch.utils import checkpoint, state as state_mod
from lyra_tpu_torch.utils.state import state_from_numpy, state_to_numpy

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
CAP = 4


def _audio(seed, ticks, b=CAP, hop=320):
    rng = np.random.default_rng(seed)
    gain = np.where(rng.random((ticks, b, 1)) < 0.7, 4000.0, 40.0)
    return np.clip(rng.normal(0.0, 1.0, (ticks, b, hop)) * gain, -32768,
                   32767).astype(np.int16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines():
    """(JAX encoder, JAX decoder, port encoder, port decoder), the
    decoders capped at 6 kbps so a 9.2 kbps packet is over the cap."""
    return (JaxEncoder(16000, SMALL), JaxDecoder(16000, SMALL,
                                                 max_bitrate=6000),
            EncoderEngine(16000, SMALL, device="cpu"),
            DecoderEngine(16000, SMALL, max_bitrate=6000, device="cpu"))


def _pair(engines, bitrate=6000):
    je, jd, te, td = engines
    return (jax_server.EncoderServer(CAP, engine=je, bitrate=bitrate),
            jax_server.DecoderServer(CAP, engine=jd),
            EncoderServer(CAP, engine=te, bitrate=bitrate),
            DecoderServer(CAP, engine=td))


def _sync_state(port, ref):
    port._state = state_from_numpy(_np_tree(ref._state), "cpu")


def _near_tie_rows(je, jes, audio, got, want, bits_row):
    """Rows whose wire bytes (row r's first bits_row[r] / 8) differ must
    differ first at a stage whose two candidate codewords score within
    float32 noise of each other, from the JAX features of the same
    pre-tick state."""
    rows = [r for r in range(got.shape[0])
            if (got[r, :bits_row[r] // 8] != want[r, :bits_row[r] // 8]).any()]
    if not rows:
        return
    feats, _ = je.soundstream.extract(
        jes["soundstream"],
        jax_dsp_utils.int16_to_unit(jnp.asarray(audio, jnp.float32)))
    feats = np.asarray(feats, np.float64)
    cbs = np.asarray(je.rvq.codebooks, np.float64)
    for r in rows:
        n = bits_row[r] // 8
        a = packet.unpack_indices_batch_np(got[r:r + 1, :n], bits_row[r])[0]
        b = packet.unpack_indices_batch_np(want[r:r + 1, :n], bits_row[r])[0]
        s = int(np.flatnonzero(a != b)[0])
        resid = feats[r] - sum((cbs[j, b[j]] for j in range(s)),
                               np.zeros(cbs.shape[-1]))
        scores = (cbs[s] ** 2).sum(-1) - 2.0 * cbs[s] @ resid
        gap = abs(scores[a[s]] - scores[b[s]])
        assert gap <= 1e-4 * max(abs(scores).max(), 1.0), (r, s, gap)


@pytest.mark.parametrize("bits", [64, 120, 184])
def test_host_codecs_and_red_match_jax(bits):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 16, (9, 46)).astype(np.int32)
    got = packet.pack_indices_batch(idx, bits)
    np.testing.assert_array_equal(got, jax_packet.pack_indices_batch(idx, bits))
    np.testing.assert_array_equal(got, packet.pack_indices_batch_np(idx, bits))
    np.testing.assert_array_equal(
        packet.unpack_indices_batch(got, bits),
        jax_packet.unpack_indices_batch(got, bits))
    np.testing.assert_array_equal(
        packet.unpack_indices_batch_np(got, bits), idx[:, :bits // 4])
    for row in range(3):
        one = packet.pack_indices(idx[row], bits)
        assert one == jax_packet.pack_indices(idx[row], bits)
        assert one == got[row].tobytes()
        np.testing.assert_array_equal(packet.unpack_indices(one),
                                      jax_packet.unpack_indices(one))
        s = packet.indices_to_bitstring(idx[row, :bits // 4])
        assert s == jax_packet.indices_to_bitstring(idx[row, :bits // 4])
        np.testing.assert_array_equal(packet.bitstring_to_indices(s),
                                      jax_packet.bitstring_to_indices(s))
        assert packet.pack_bitstring(s) == jax_packet.pack_bitstring(s)
        assert packet.unpack_bitstring(one, bits) == \
            jax_packet.unpack_bitstring(one, bits)
    # RED framing, one datagram and a whole tick's matrix.
    size = bits // 8
    cur, prev = got[0].tobytes(), got[1].tobytes()[: size - 1]
    red = packet.build_red(cur, prev)
    assert red == jax_packet.build_red(cur, prev)
    assert packet.parse_red(red) == jax_packet.parse_red(red) == (cur, prev)
    cur_sizes = rng.choice([0, size - 2, size], 9)
    prev_sizes = rng.choice([0, size], 9)
    for a, b in zip(packet.build_red_batch(got, cur_sizes, got[::-1],
                                           prev_sizes),
                    jax_packet.build_red_batch(got, cur_sizes, got[::-1],
                                               prev_sizes)):
        np.testing.assert_array_equal(a, b)
    for bad in (b"\x05ab", b"\x01", b"\x00\x02a"):
        for parse in (packet.parse_red, jax_packet.parse_red):
            with pytest.raises(ValueError):
                parse(bad)
    with pytest.raises(ValueError):
        packet.pack_indices_batch(np.full((1, 46), 16, np.int32), bits)
    with pytest.raises(ValueError):
        packet.unpack_indices(b"\x00" * 9)


def test_encoder_ticks_match_jax(engines):
    """tick_wire (mixed bitrates), tick_packed and tick from the same
    pre-tick state: bytes and sizes equal (but at RVQ near-ties)."""
    je = engines[0]
    jenc, _, tenc, _ = _pair(engines)
    for srv in (jenc, tenc):
        srv.add_streams(["a", "b", "c"])
        srv.set_bitrate("b", 3200)
        srv.set_bitrate("c", 9200)
    audio = _audio(1, 6)
    for t in range(6):
        _sync_state(tenc, jenc)
        pre = jenc._state
        if t % 3 == 0:
            want, want_sizes = jenc.tick_wire(audio[t])
            got, sizes = tenc.tick_wire(audio[t])
        elif t % 3 == 1:
            want, want_sizes = jenc.tick_packed(audio[t])
            got, sizes = tenc.tick_packed(audio[t])
        else:
            hops = {sid: audio[t, i] for sid, i in jenc._by_id.items()}
            want_d, got_d = jenc.tick(hops), tenc.tick(hops)
            assert {k: len(v) for k, v in want_d.items()} == \
                {k: len(v) for k, v in got_d.items()}
            width = max(len(v) for v in want_d.values())
            want = np.zeros((CAP, width), np.uint8)
            got = np.zeros((CAP, width), np.uint8)
            for sid, i in jenc._by_id.items():
                want[i, :len(want_d[sid])] = np.frombuffer(want_d[sid], np.uint8)
                got[i, :len(got_d[sid])] = np.frombuffer(got_d[sid], np.uint8)
            want_sizes = sizes = None
        if sizes is not None:
            np.testing.assert_array_equal(sizes, want_sizes)
            assert got.shape == want.shape == (CAP, 23)
        _near_tie_rows(je, pre, audio[t], got, want, tenc._bits)
    assert tenc.num_active == 3


def test_decoder_ticks_match_jax(engines):
    """tick_wire uniform and mixed (an unknown size and an over-cap size
    count in bad_packets), tick_packed and tick (a straggler counts in
    inactive_drops) from the same pre-tick state: audio within 1 LSB."""
    _, jdec, _, tdec = _pair(engines)
    for srv in (jdec, tdec):
        srv.add_streams(["a", "b", "c"])
    rng = np.random.default_rng(2)
    for t in range(8):
        _sync_state(tdec, jdec)
        wire = rng.integers(0, 256, (CAP, 23)).astype(np.uint8)
        received = rng.random(CAP) < 0.8
        kind = t % 4
        if kind in (1, 2):
            received[:3] = True  # the bad sizes land on active rows
        if kind == 0:  # uniform 120-bit packets
            args = (wire[:, :15], received)
            want, got = jdec.tick_wire(*args), tdec.tick_wire(*args)
        elif kind == 1:  # mixed: 8, 15, unknown 10, over-cap 23
            sizes = np.array([8, 23, 10, 15])
            want = jdec.tick_wire(wire, received, sizes)
            got = tdec.tick_wire(wire, received, sizes)
        elif kind == 2:
            sizes = np.array([8, 0, 23, 15])
            want = jdec.tick_packed(wire, received, sizes)
            got = tdec.tick_packed(wire, received, sizes)
        else:
            pkts = {"a": wire[0, :8].tobytes(), "b": None,
                    "c": wire[2, :10].tobytes(), "gone": b"\x00" * 8}
            want_d, got_d = jdec.tick(pkts), tdec.tick(pkts)
            assert set(want_d) == set(got_d) == {"a", "b", "c"}
            want = np.stack([want_d[k] for k in "abc"])
            got = np.stack([got_d[k] for k in "abc"])
        assert got.dtype == np.int16 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1, t
        np.testing.assert_array_equal(tdec._last_comfort, jdec._last_comfort)
        for sid in "abc":
            assert tdec.is_comfort_noise(sid) == jdec.is_comfort_noise(sid)
    np.testing.assert_array_equal(tdec.bad_packets, jdec.bad_packets)
    assert tdec.bad_packets.sum() > 0
    assert tdec.inactive_drops == jdec.inactive_drops == 2
    received[:] = True
    for srv in (jdec, tdec):
        with pytest.raises(ValueError):  # a size wider than the rows
            srv.tick_wire(wire[:, :15], received, np.array([8, 15, 23, 0]))
        with pytest.raises(ValueError):  # uniform rows over the cap
            srv.tick_wire(wire, received)


def test_admission_eviction_and_async_shift(engines):
    """Admission resets rows exactly as JAX's; the async pipelines give
    the sync outputs one tick later; a slot re-admitted between submit
    and drain drains silence (decoder) and size 0 (encoder)."""
    jenc, jdec, tenc, tdec = _pair(engines, bitrate=3200)
    for srv in (jenc, jdec):
        srv.add_streams(["a", "b", "c", "d"])
    _sync_state(tenc, jenc)
    _sync_state(tdec, jdec)
    tenc.add_streams(["a", "b", "c", "d"])
    tdec.add_streams(["a", "b", "c", "d"])
    audio = _audio(3, 8)
    for t in range(3):
        wire, sizes = tenc.tick_wire(audio[t])
        tdec.tick_wire(wire, sizes > 0, sizes)
    jenc._state, jdec._state = (jax.tree.map(jnp.asarray, state_to_numpy(
        s._state)) for s in (tenc, tdec))
    for srv in (jenc, jdec, tenc, tdec):
        srv.remove_stream("b")
        assert srv.add_stream("e") == 1
    for t_srv, j_srv in ((tenc, jenc), (tdec, jdec)):
        jax.tree.map(np.testing.assert_array_equal,
                     state_to_numpy(t_srv._state), _np_tree(j_srv._state))

    # Sync reference, then the same ticks through both async pipelines.
    def run(asynchronous):
        enc = EncoderServer(CAP, engine=engines[2], bitrate=3200)
        dec = DecoderServer(CAP, engine=engines[3])
        for srv in (enc, dec):
            srv.add_streams(["a", "b", "c", "d"])
        outs = []
        for t in range(6):
            if t == 3:  # slot of "c" changes hands before tick 3's drain
                for srv in (enc, dec):
                    srv.remove_stream("c")
                    srv.add_stream("f")
            if asynchronous:
                w = enc.tick_wire_async(audio[t])
                a = dec.tick_packed_async(*inputs[t])
            else:
                w = enc.tick_wire(audio[t])
                a = dec.tick_packed(*inputs[t])
            outs.append((w, a, dec._last_comfort.copy()))
        if asynchronous:
            outs.append((enc.flush_async(), dec.flush_async(),
                         dec._last_comfort.copy()))
            assert enc.flush_async() is None and dec.flush_async() is None
        return outs

    rng = np.random.default_rng(4)
    inputs = [(rng.integers(0, 256, (CAP, 8)).astype(np.uint8),
               rng.random(CAP) < 0.7, np.full(CAP, 8)) for _ in range(6)]
    sync, asyn = run(False), run(True)
    assert asyn[0][0] is None and asyn[0][1] is None
    slot_c = 2
    for t in range(6):
        (w, s), a, cn = sync[t]
        (wa, sa), aa, cna = asyn[t + 1]
        if t == 2:  # re-admitted before the drain
            assert sa[slot_c] == 0 and not wa[slot_c].any()
            assert not aa[slot_c].any() and not cna[slot_c]
            w, s, a, cn = w.copy(), s.copy(), a.copy(), cn.copy()
            w[slot_c], s[slot_c], a[slot_c], cn[slot_c] = 0, 0, 0, False
        np.testing.assert_array_equal(wa, w)
        np.testing.assert_array_equal(sa, s)
        np.testing.assert_array_equal(aa, a)
        np.testing.assert_array_equal(cna, cn)
    assert sync[2][1][slot_c].any()  # the silenced hop was not silent
    enc = EncoderServer(CAP, engine=engines[2], bitrate=3200)
    enc.add_stream("x")
    enc.tick_wire_async(audio[0])
    with pytest.raises(RuntimeError):
        enc.tick_wire(audio[1])
    with pytest.raises(RuntimeError):
        enc.tick_packed_async(audio[1])
    with pytest.raises(RuntimeError):
        enc.save("/nonexistent/never-written")


def _run_pair(enc, dec, audio, received, ticks, snap=None, at=None):
    """ticks of EncoderServer.tick_wire → DecoderServer.tick_wire; saves
    both servers into `snap` before tick `at`.  → per tick (pre-tick
    encoder state, wire, sizes, audio, comfort flags)."""
    outs = []
    for t in ticks:
        if t == at:
            enc.save(snap + "-enc")
            dec.save(snap + "-dec")
        pre = _np_tree(enc._state) if isinstance(enc, jax_server.EncoderServer) \
            else None
        wire, sizes = enc.tick_wire(audio[t])
        out = dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
        outs.append((pre, wire, sizes, out, dec._last_comfort.copy()))
    return outs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_float_snapshots_cross_packages(engines, tmp_path, writer):
    """A snapshot written by one package's server pair restores in the
    other's, which continues within the bars of an uninterrupted run."""
    je = engines[0]
    jenc, jdec, tenc, tdec = _pair(engines)
    ids = ["a", "b", "c"]
    for srv in (jenc, jdec, tenc, tdec):
        srv.add_streams(ids)
    audio = _audio(5, 10)
    received = np.random.default_rng(5).random((10, CAP)) < 0.8
    received[6:9, 1] = False
    snap = str(tmp_path / "snap")
    src, dst = ((jenc, jdec), (tenc, tdec)) if writer == "jax" else \
        ((tenc, tdec), (jenc, jdec))
    ref = _run_pair(*src, audio, received, range(10), snap=snap, at=5)
    for srv, part in zip(dst, ("-enc", "-dec")):
        srv.restore(snap + part)
    got = _run_pair(*dst, audio, received, range(5, 10))
    for t, ((pre, w, s, a, cn), (pre_r, w_r, s_r, a_r, cn_r)) in enumerate(
            zip(got, ref[5:])):
        np.testing.assert_array_equal(s, s_r)
        jax_pre = pre if pre is not None else pre_r
        if jax_pre is not None:
            _near_tie_rows(je, jax_pre, audio[5 + t], w, w_r,
                           np.full(CAP, 120))
        else:
            np.testing.assert_array_equal(w, w_r)
        assert np.abs(a.astype(np.int32) - a_r).max() <= 1, t
        np.testing.assert_array_equal(cn, cn_r)
    assert dst[1].num_active == 3 and dst[1]._seed == src[1]._seed


def test_bf16_snapshots_are_bitwise(tmp_path, monkeypatch):
    """A bf16 port snapshot round-trips bit for bit (with and without
    ml_dtypes), and a JAX bf16 state tree saved by np.savez (|V2 leaves)
    loads into the port bit for bit."""
    td = DecoderEngine(16000, SMALL, mode="bf16", device="cpu")
    dec = DecoderServer(CAP, engine=td)
    dec.add_streams(["a", "b"])
    rng = np.random.default_rng(6)
    for _ in range(3):
        dec.tick_wire(rng.integers(0, 256, (CAP, 8)).astype(np.uint8),
                      rng.random(CAP) < 0.8)

    def bits(tree):
        return {k: bits(v) if isinstance(v, dict) else
                (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
                for k, v in tree.items()}

    def same(a, b):
        for (pa, x), (pb, y) in zip(sorted(a.items()), sorted(b.items())):
            assert pa == pb
            if isinstance(x, dict):
                same(x, y)
            else:
                assert x.dtype == y.dtype and torch.equal(x, y), pa

    for without_ml_dtypes in (False, True):
        if without_ml_dtypes:
            monkeypatch.setitem(__import__("sys").modules, "ml_dtypes", None)
        path = str(tmp_path / f"bf16-{without_ml_dtypes}")
        dec.save(path)
        flat, _ = checkpoint.load_state(path)
        assert flat["gan"] and all(v.dtype == np.dtype("V2")
                                   for v in flat["gan"].values())
        back = DecoderServer(CAP, engine=td)
        back.restore(path)
        same(bits(back._state), bits(dec._state))
        assert any(v.dtype == torch.bfloat16 for v in back._state["gan"].values())
        assert back._state["cng"]["ctr"].dtype == torch.int64
    monkeypatch.undo()
    assert state_mod._bf16_dtype().name == "bfloat16"

    jd = JaxDecoder(16000, SMALL, mode="bf16")
    st = _np_tree(jd.init_state(CAP, seed=2))
    st["gan"] = {k: rng.normal(size=v.shape).astype(v.dtype)
                 for k, v in st["gan"].items()}
    path = str(tmp_path / "jax-bf16")
    jax_checkpoint.save_state(path, st, extra={"kind": "decoder"})
    loaded, extra = checkpoint.load_state(path)
    assert extra == {"kind": "decoder"}
    ours = state_from_numpy(loaded, "cpu")
    for k, v in st["gan"].items():
        assert ours["gan"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours["gan"][k].view(torch.int16).numpy(),
                                      v.view(np.int16))
    np.testing.assert_array_equal(ours["cng"]["ctr"].numpy(),
                                  st["cng"]["ctr"].astype(np.int64))
    assert checkpoint.peek_extra(path) == {"kind": "decoder"}


@pytest.mark.parametrize("servers", [(DecoderServer, jax_server.DecoderServer),
                                     (EncoderServer, jax_server.EncoderServer)])
def test_server_constructors_and_methods_follow_jax(servers):
    ours, ref = servers
    params = inspect.signature(ours.__init__).parameters
    ref_params = inspect.signature(ref.__init__).parameters
    assert list(params)[:-1] == list(ref_params)
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
    for name in ("add_stream", "add_streams", "remove_stream", "save",
                 "restore", "tick", "tick_packed", "tick_wire",
                 "tick_wire_async", "tick_packed_async", "flush_async",
                 "flush_wire_async"):
        assert (list(inspect.signature(getattr(ours, name)).parameters)
                == list(inspect.signature(getattr(ref, name)).parameters)), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ours(2, model_path=SMALL)
    with pytest.raises(ValueError):
        ours(2, engine=(DecoderEngine if ours is DecoderServer
                        else EncoderEngine)(16000, SMALL, device="cpu"),
             sample_rate_hz=48000)


# ---- ServerPool, ConferenceBridge and the mixer ----------------------------


@pytest.fixture(scope="module")
def engines_lo():
    """8 kHz engines of both packages (JAX encoder, JAX decoder, port
    encoder, port decoder), for the mixed-rate pool."""
    return (JaxEncoder(8000, SMALL), JaxDecoder(8000, SMALL),
            EncoderEngine(8000, SMALL, device="cpu"),
            DecoderEngine(8000, SMALL, device="cpu"))


def _pools(wave_engines, wave_cap=2, bitrate=6000):
    """(JAX encoder pool, JAX decoder pool, port encoder pool, port
    decoder pool), one wave per engine quadruple."""
    return (jax_server.ServerPool([jax_server.EncoderServer(
                wave_cap, engine=e[0], bitrate=bitrate) for e in wave_engines]),
            jax_server.ServerPool([jax_server.DecoderServer(
                wave_cap, engine=e[1]) for e in wave_engines]),
            ServerPool([EncoderServer(wave_cap, engine=e[2], bitrate=bitrate)
                        for e in wave_engines]),
            ServerPool([DecoderServer(wave_cap, engine=e[3])
                        for e in wave_engines]))


def _sync_pool(port, ref):
    for p, r in zip(port.servers, ref.servers):
        _sync_state(p, r)


def _pool_audio(seed, ticks, pool):
    """[ticks, capacity, pool hop] int16, each row's own hop left-aligned
    (the rest zero)."""
    audio = np.zeros((ticks, pool.capacity, pool.hop_samples), np.int16)
    for w, srv in enumerate(pool.servers):
        rows = slice(w * pool.wave_capacity, (w + 1) * pool.wave_capacity)
        audio[:, rows, :srv.hop_samples] = _audio(
            seed + w, ticks, pool.wave_capacity, srv.hop_samples)
    return audio


def test_server_pool_matches_jax(engines, engines_lo):
    """A mixed-rate pool (an 8 kHz and a 16 kHz wave, rate-routed
    admission, 8 kHz rows padded to the 16 kHz hop) from the same
    pre-tick state as the JAX pool: placement equal, tick_wire's wire
    bytes equal (but at RVQ near-ties on the 16 kHz wave), decoder audio
    within 1 LSB; tick_packed equals tick_wire bit for bit, as each
    server's does."""
    jenc, jdec, tenc, tdec = _pools([engines_lo, engines])
    _, _, tenc2, tdec2 = _pools([engines_lo, engines])
    ids = ["a", "b", "c"]
    rates = {"a": 16000, "b": 8000, "c": 8000}
    pools = (jenc, jdec, tenc, tdec, tenc2, tdec2)
    for pool in (jenc, tenc):
        with pytest.raises(ValueError, match="explicit sample_rate_hz"):
            pool.add_stream("x")
    rows = [{sid: pool.add_stream(sid, sample_rate_hz=rates[sid])
             for sid in ids} for pool in pools]
    assert all(r == rows[0] for r in rows)
    assert tenc.sample_rate_of("b") == 8000
    assert tenc.hop_samples_of("b") == 160 and tenc.hop_samples == 320
    for pool in (jenc, tenc):
        with pytest.raises(RuntimeError, match="8000"):
            pool.add_stream("d", sample_rate_hz=8000)
        with pytest.raises(ValueError, match="no 48000 Hz wave"):
            pool.add_stream("d", sample_rate_hz=48000)
    audio = _pool_audio(8, 4, tenc)
    rng = np.random.default_rng(8)
    w0 = tenc.wave_capacity
    for t in range(3):
        _sync_pool(tenc, jenc)
        _sync_pool(tdec, jdec)
        pre = _np_tree(jenc.servers[1]._state)
        want, want_sizes = jenc.tick_wire(audio[t])
        got, sizes = tenc.tick_wire(audio[t])
        np.testing.assert_array_equal(sizes, want_sizes)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:w0], want[:w0])
        _near_tie_rows(engines[0], pre, audio[t, w0:], got[w0:], want[w0:],
                       tenc.servers[1]._bits)
        received = (want_sizes > 0) & (rng.random(tdec.capacity) < 0.8)
        a_want = jdec.tick_wire(want, received, want_sizes)
        a_got = tdec.tick_wire(want, received, want_sizes)
        assert a_got.dtype == np.int16 and a_got.shape == a_want.shape
        assert not a_got[:w0, 160:].any()  # an 8 kHz row's padding
        assert np.abs(a_got.astype(np.int32) - a_want).max() <= 1, t
    np.testing.assert_array_equal(tdec.bad_packets, jdec.bad_packets)
    for pairs in ((tenc2, tenc), (tdec2, tdec)):
        _sync_pool(*pairs)
    wire, sizes = tenc.tick_wire(audio[3])
    for got, want in zip(tenc2.tick_packed(audio[3]), (wire, sizes)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdec2.tick_packed(wire, sizes > 0, sizes),
                                  tdec.tick_wire(wire, sizes > 0, sizes))
    assert tdec.num_active == jdec.num_active == 3
    tenc.set_bitrate("a", 3200)
    tenc.remove_stream("c")
    assert tenc.num_active == 2
    with pytest.raises(KeyError):
        tenc.remove_stream("nope")
    with pytest.raises(ValueError, match="equal capacity"):
        ServerPool([tdec.servers[0], DecoderServer(3, engine=engines[3])])
    with pytest.raises(ValueError, match="all-encoder or all-decoder"):
        ServerPool([tenc.servers[0], tdec.servers[0]])


def test_server_pool_async_and_snapshots(engines, tmp_path):
    """Balanced admission as JAX's; the async pool ticks equal the sync
    ones one tick later; a pool
    snapshot written by either package restores in the other and
    continues within the bars; a wave-count or wave-capacity mismatch is
    refused before any wave changes."""
    jenc, jdec, tenc, tdec = _pools([engines, engines])
    _, _, tenc2, tdec2 = _pools([engines, engines])
    pools = (jenc, jdec, tenc, tdec, tenc2, tdec2)
    rows = [pool.add_streams(["a", "b", "c"]) for pool in pools]
    assert all(r == rows[0] for r in rows)  # balanced across the waves
    assert [pool.add_stream("d") for pool in pools] == [3] * 6
    audio = _pool_audio(9, 4, tenc)
    sync = []
    for t in range(4):
        wire, sizes = tenc.tick_wire(audio[t])
        sync.append((wire, sizes, tdec.tick_wire(wire, sizes > 0, sizes)))
    asyn = []
    for t in range(4):
        got = tenc2.tick_wire_async(audio[t])
        if t == 0:
            assert got is None
            continue
        a = tdec2.tick_wire_async(got[0], got[1] > 0, got[1])
        asyn.append((*got, a))
    last = tenc2.flush_wire_async()
    asyn.append((*last, tdec2.tick_wire_async(last[0], last[1] > 0, last[1])))
    drained = tdec2.flush_wire_async()
    assert asyn[0][2] is None
    for t in range(4):
        np.testing.assert_array_equal(asyn[t][0], sync[t][0])
        np.testing.assert_array_equal(asyn[t][1], sync[t][1])
        np.testing.assert_array_equal(
            asyn[t + 1][2] if t < 3 else drained, sync[t][2])

    # Snapshots across packages: JAX → port and port → JAX.
    def host(srv):
        return (state_to_numpy(srv._state) if isinstance(srv, DecoderServer)
                else _np_tree(srv._state))

    for writer, reader in ((jdec, tdec2), (tdec, jdec)):
        path = str(tmp_path / f"pool-{type(writer.servers[0]).__module__}")
        writer.save(path, transport={"jb_heads": [0, 1, 2, 3]})
        assert reader.restore(path) == {"jb_heads": [0, 1, 2, 3]}
        for r, w in zip(reader.servers, writer.servers):
            assert r._by_id == w._by_id
            jax.tree.map(np.testing.assert_array_equal, host(r), host(w))
    wire, sizes = sync[-1][:2]
    a_t = tdec.tick_wire(wire, sizes > 0, sizes)
    a_j = jdec.tick_wire(wire, sizes > 0, sizes)
    assert np.abs(a_t.astype(np.int32) - a_j).max() <= 1

    # Wave mismatches, in both packages, leave the pool untouched.
    three = ServerPool([DecoderServer(2, engine=engines[3])
                        for _ in range(3)])
    three.add_streams(["x", "y", "z"])
    three.save(str(tmp_path / "p3"))
    tdec.save(str(tmp_path / "p2"))
    wide = ServerPool([DecoderServer(3, engine=engines[3]) for _ in range(2)])
    for pool, snap, match in ((tdec, "p3", "more waves"),
                              (three, "p2", "missing wave"),
                              (wide, "p2", "capacity")):
        before = [dict(s._by_id) for s in pool.servers]
        with pytest.raises(ValueError, match=match):
            pool.restore(str(tmp_path / snap))
        assert [s._by_id for s in pool.servers] == before
    with pytest.raises(ValueError, match="more waves"):
        jdec.restore(str(tmp_path / "p3"))


def test_mixer_matches_numpy_oracle_and_jax():
    """The torch mixer (index_add_ on int32) is bitwise equal to
    mix_minus_one_np and to the JAX mixer, saturation included."""
    from lyra_tpu.tools import conference as jax_conference
    from lyra_tpu_torch.tools import conference

    rng = np.random.default_rng(3)
    cap, hop = 16, 8
    for trial in range(4):
        pcm = rng.choice(np.array([-32768, -30000, -5, 0, 7, 30000, 32767],
                                  np.int16), size=(cap, hop)).astype(np.int16)
        if trial % 2:
            pcm = rng.integers(-32768, 32768, (cap, hop)).astype(np.int16)
        rooms = rng.integers(0, 4 + 4 * trial, cap).astype(np.int32)
        exclude = rng.random(cap) < 0.3
        active = rng.random(cap) < 0.9
        want = conference.mix_minus_one_np(pcm, rooms, active & ~exclude,
                                           num_rooms=cap)
        np.testing.assert_array_equal(want, jax_conference.mix_minus_one_np(
            pcm, rooms, active & ~exclude, num_rooms=cap))
        got, state = conference._mix_body(cap)(
            {}, torch.from_numpy(pcm), torch.from_numpy(exclude),
            torch.from_numpy(rooms), torch.from_numpy(active))
        assert state == {} and got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
        ref = np.asarray(jax_conference._mix_step(cap)(
            jnp.asarray(pcm), jnp.asarray(exclude), jnp.asarray(rooms),
            jnp.asarray(active)))
        np.testing.assert_array_equal(got.numpy(), ref)
        if trial == 0:
            assert want.min() == -32768 and want.max() == 32767


def test_conference_bridge_matches_jax(engines, tmp_path):
    """tick_wire, then the tick_wire_async pipeline, from the same
    pre-tick state as the JAX bridge: downlink sizes, comfort-noise flags
    and bad_packets equal, wire bytes equal but at RVQ near-ties (of the
    mix the port decodes, within 1 LSB of the JAX one); every tick also
    equals the port's own servers composed through host PCM and the numpy
    mixer, bit for bit.  Snapshots and one-shard placement match JAX's."""
    from lyra_tpu.tools.conference import ConferenceBridge as JaxBridge
    from lyra_tpu_torch.tools.conference import (
        ConferenceBridge,
        mix_minus_one_np,
    )

    je, jd, te, td = engines
    jb = JaxBridge(CAP, seed=3, dec_engine=jd, enc_engine=je)
    tb = ConferenceBridge(CAP, seed=3, dec_engine=td, enc_engine=te)
    comp_dec = DecoderServer(CAP, engine=td, seed=3)
    comp_enc = EncoderServer(CAP, engine=te, bitrate=3200)
    rooms_by_id = {"p0": "A", "p1": "A", "p2": "A", "p3": "B"}
    for b in (jb, tb):
        assert b.add_participants(rooms_by_id) == {"p0": 0, "p1": 1,
                                                   "p2": 2, "p3": 3}
        b.set_bitrate("p1", 6000)
    for srv in (comp_dec, comp_enc):
        srv.add_streams(rooms_by_id)
    comp_enc.set_bitrate("p1", 6000)
    rooms = np.array([0, 0, 0, 1], np.int32)
    rng = np.random.default_rng(11)
    sizes = np.array([8, 15, 10, 23])  # 10: unknown; 23: over the cap
    ticks = 8
    uplink = [(rng.integers(0, 256, (CAP, 23)).astype(np.uint8),
               rng.random(CAP) < (0.9 if t < 4 else 0.2))
              for t in range(ticks)]

    def submit(t, asynchronous):
        """Sync every server to the JAX bridge's pre-tick state, tick the
        composed port servers, then both bridges."""
        for port, ref in ((tb._dec, jb._dec), (tb._enc, jb._enc),
                          (comp_dec, jb._dec), (comp_enc, jb._enc)):
            _sync_state(port, ref)
        pre = _np_tree(jb._enc._state)
        audio = comp_dec.tick_wire(uplink[t][0], uplink[t][1], sizes)
        mix = mix_minus_one_np(audio, rooms, ~comp_dec._last_comfort, CAP)
        ref = (pre, mix, *comp_enc.tick_wire(mix),
               comp_dec._last_comfort.copy())
        if asynchronous:
            return ref, jb.tick_wire_async(*uplink[t], sizes), \
                tb.tick_wire_async(*uplink[t], sizes)
        return ref, jb.tick_wire(*uplink[t], sizes), \
            tb.tick_wire(*uplink[t], sizes)

    def check(ref, want, got):
        pre, mix, cw, cs, cn = ref
        np.testing.assert_array_equal(got[0], cw)
        np.testing.assert_array_equal(got[1], cs)
        np.testing.assert_array_equal(tb._dec._last_comfort, cn)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(tb._dec._last_comfort,
                                      jb._dec._last_comfort)
        _near_tie_rows(je, pre, mix, got[0], want[0], jb._enc._bits)

    for t in range(ticks):
        check(*submit(t, False))
    assert tb._dec._last_comfort.any()  # the lossy ticks reached CN
    refs = []
    for t in range(ticks):
        ref, want, got = submit(t, True)
        assert (want is None) == (got is None) == (t == 0)
        if got is not None:
            check(refs[-1], want, got)
        refs.append(ref)
    check(refs[-1], jb.flush_async(), tb.flush_async())
    assert tb.flush_async() is None
    np.testing.assert_array_equal(tb.bad_packets, jb.bad_packets)
    assert tb.bad_packets.sum() > 0

    # Snapshots cross the packages; a restore rebuilds the rooms.
    for writer, reader in ((tb, JaxBridge(CAP, dec_engine=jd, enc_engine=je)),
                           (jb, ConferenceBridge(CAP, dec_engine=td,
                                                 enc_engine=te))):
        path = str(tmp_path / f"bridge-{type(writer).__module__}")
        writer.save(path, transport={"jb_heads": [5, 5, 5, 5]})
        assert reader.restore(path) == {"jb_heads": [5, 5, 5, 5]}
        assert {sid: reader.room_of(sid) for sid in rooms_by_id} == rooms_by_id
        np.testing.assert_array_equal(reader._enc._bits, writer._enc._bits)
    # One-shard placement: the pinned room's joiner first, then new rooms
    # largest first; over two shards the JAX bridge's placement.
    for b in (jb, tb):
        b.remove_participant("p3")
        b.remove_participant("p1")
    assert tb.shard_affine_slots({"q": "B", "r": "A"}) == \
        jb.shard_affine_slots({"q": "B", "r": "A"}) == {"r": 1, "q": 3}
    with pytest.raises(RuntimeError):
        tb.shard_affine_slots({"x": "C", "y": "C", "z": "D"})
    assert tb.num_shards == jb.num_shards == 1
    def placed(b, joiners, n):
        try:
            return b.shard_affine_slots(joiners, num_shards=n)
        except (ValueError, RuntimeError) as e:
            return type(e), str(e)

    for joiners in ({"q": "B"}, {"r": "C", "s": "C"}):
        for n in (2, 4):
            assert placed(tb, joiners, n) == placed(jb, joiners, n)
