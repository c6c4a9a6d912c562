"""Multi-device serving in the port (lyra_tpu_torch/parallel/sharding.py)
on CPU meshes, against one engine and against the JAX ShardedEngine.

Port meshes are `["cpu"] * N` (one CPU named N times: N shards, each with
its own replica and rows); JAX meshes come from the 8 forced CPU devices
(tests/conftest.py).  The small synthetic fixture, B = 8, seeded inputs.
Bars:

  * sharded vs one engine, in float and in bf16: encoder indices, wire
    bytes, comfort-noise flags and every state leaf outside the noise
    estimator and the comfort-noise generator bitwise; decoder audio
    bitwise in every hop without comfort noise in it, within 1 int16 LSB
    in those with it.  A row's arithmetic does not depend on how many
    rows a call holds, with one exception: the two DFT matmuls of those
    two modules are BLAS GEMMs (MKL here, cuBLAS on the card), which pick
    their kernel, and so the order of their sums, by the row count
    (chip_smoke.py phase 14 shows the same on the card);
  * port ShardedEngine vs JAX ShardedEngine, float, from the same
    pre-tick state each tick: indices identical but at RVQ near-ties,
    audio within 1 int16 LSB (tests/test_torch_engine.py's bars);
  * snapshots cross sharded ⇄ unsharded, N ⇄ M and JAX ⇄ port.
"""

import os

import jax
import numpy as np
import pytest
import torch

from lyra_tpu.codec.engine import DecoderEngine as JaxDecoder
from lyra_tpu.codec.engine import EncoderEngine as JaxEncoder
from lyra_tpu.parallel import sharding as jax_sharding
from lyra_tpu.tools import stream_server as jax_server
from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import (
    FADE_TO_CNG,
    DecoderEngine,
    EncoderEngine,
)
from lyra_tpu_torch.parallel.dryrun import dryrun_multichip
from lyra_tpu_torch.parallel.sharding import (
    STREAM_AXIS,
    Sharded,
    ShardedEngine,
    batch_sharding,
    make_mesh,
    shard_batch_tree,
    unshard_batch_tree,
)
from lyra_tpu_torch.tools.conference import ConferenceBridge
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils.state import state_from_numpy

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
B, HOPS, NQ = 8, 20, 30
BURST_ROW = 5  # a row of shard 1 (N = 2) / shard 2 (N = 4)
RATES = {"float": 16000, "bf16": 48000}


def _mesh(n):
    return make_mesh(["cpu"] * n)


def _audio(seed, hops, b=B, hop=320):
    rng = np.random.default_rng(seed)
    gain = np.where(rng.random((hops, b, 1)) < 0.7, 4000.0, 40.0)
    return (rng.normal(0.0, 1.0, (hops, b, hop)) * gain).astype(np.float32)


def _received(hops, b=B):
    """Every third packet lost (PLC), and a 12-hop burst on BURST_ROW that
    runs through concealment and the fade into comfort noise."""
    rec = np.ones((hops, b), bool)
    for t in range(hops):
        rec[t, t % 3::3] = False
    rec[6:18, BURST_ROW] = False
    return rec


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_trees_equal(got, want, skip=()):
    """Bitwise, but the floating-point leaves of the subtrees named in
    `skip`."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        if not (k[0] in skip and g[k].is_floating_point()):
            assert torch.equal(g[k].cpu(), w[k].cpu()), k


# The decoder subtrees whose float leaves come out of BLAS GEMMs (their
# counters and flags stay exact: the comfort-noise RNG's lineage).
GEMM_STATE = ("noise", "cng")


def _leaf(state, key):
    if isinstance(state, Sharded):
        return torch.cat([p[key] for p in state.parts])
    return state[key]


def _cn_enters(pre, post):
    """[B] bool: rows whose hop from decoder state `pre` to `post` has
    comfort noise in it (the engine's run_cng)."""
    return ((_leaf(post, "fade_dir") == FADE_TO_CNG)
            | (_leaf(pre, "fade") != 0)).numpy()


def _assert_audio(got, want, cn):
    """Bitwise in rows without comfort noise in the hop, within 1 int16
    LSB in rows with it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got[~cn], want[~cn])
    assert np.abs(got - want).max() <= 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """B = 8 rows leave torch's intra-op threads nothing to share, and in a
    parallel test run one thread per core in every worker oversubscribes
    the machine many times over: one thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    """Port engines per mode: (encoder, decoder)."""
    return {mode: (EncoderEngine(rate, SMALL, mode=mode, device="cpu"),
                   DecoderEngine(rate, SMALL, mode=mode, device="cpu"))
            for mode, rate in RATES.items()}


def _run(enc, dec, audio, received, reset_at=None):
    """Ticks: encode, then decode the encoder's indices; with `reset_at`
    (tick, mask) both re-admit the masked rows before that tick (the
    decoder with seed 3).  → per tick (indices, audio, comfort-noise
    flags, rows with comfort noise in the hop) as numpy, and the final
    states."""
    es, ds = enc.init_state(B), dec.init_state(B, seed=3)
    out = []
    for t in range(audio.shape[0]):
        if reset_at is not None and t == reset_at[0]:
            es = enc.reset_rows(es, reset_at[1])
            ds = dec.reset_rows(ds, reset_at[1], seed=3)
        idx, _, es = enc.step(es, audio[t], NQ)
        idx = np.asarray(idx)
        pre = ds
        pcm, cn, ds = dec.step(ds, idx, received[t])
        out.append((idx, np.asarray(pcm), np.asarray(cn),
                    _cn_enters(pre, ds)))
    return out, es, ds


def _assert_runs_match(got, ref):
    for t, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g[0], r[0], err_msg=f"indices {t}")
        np.testing.assert_array_equal(g[2], r[2], err_msg=f"cn flags {t}")
        np.testing.assert_array_equal(g[3], r[3], err_msg=f"cn rows {t}")
        _assert_audio(g[1], r[1], r[3])


@pytest.fixture(scope="module")
def one_engine_runs(engines):
    """The unsharded reference run of each mode."""
    runs = {}
    for mode, (enc, dec) in engines.items():
        audio = _audio(1, HOPS, hop=RATES[mode] // 50)
        runs[mode] = (audio, _run(enc, dec, audio, _received(HOPS)))
    return runs


# ---- the mesh ------------------------------------------------------------------


class _ToyEngine:
    """Minimal engine contract: init_state + _step_impl over [B] rows."""

    device = torch.device("cpu")
    hop_samples = 4

    def init_state(self, batch_size):
        return {"acc": torch.zeros((batch_size, 4)),
                "count": torch.zeros((batch_size,), dtype=torch.int32)}

    def _step_args(self, *args):
        return args

    def _step_impl(self, state, x, gain):
        acc = state["acc"] + x * gain
        return acc.sum(-1), {"acc": acc, "count": state["count"] + 1}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_spans_n_devices(n):
    mesh = _mesh(n)
    assert mesh.devices.size == n and mesh.axis_name == STREAM_AXIS
    assert mesh == _mesh(n) and mesh != _mesh(n + 1)
    assert len({mesh, _mesh(n)}) == 1


def test_make_mesh_defaults_to_the_cards():
    """Every attached card by default; without one it raises (the CPU is
    asked for, never a fallback), as every entry point of the port."""
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ShardedEngine(_ToyEngine())
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "meta"])


def test_sharded_state_placement_and_inverse():
    mesh = _mesh(4)
    tree = {"a": torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3),
            "sub": {"b": torch.arange(16, dtype=torch.int64)}, "empty": {}}
    sharded = shard_batch_tree(tree, mesh)
    assert isinstance(sharded, Sharded)
    assert sharded.sharding == batch_sharding(mesh)
    for k, part in enumerate(sharded.parts):
        assert part["a"].device == mesh.devices[k]
        np.testing.assert_array_equal(part["a"].numpy(),
                                      tree["a"][4 * k:4 * k + 4].numpy())
        assert part["a"].untyped_storage().data_ptr() != \
            tree["a"].untyped_storage().data_ptr()  # copies, not views
        assert part["empty"] == {}
    back = unshard_batch_tree(sharded)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["sub"]["b"], tree["sub"]["b"])
    assert back["empty"] == {}
    one = shard_batch_tree(np.arange(8), _mesh(2))
    assert one.shape == (8,) and np.asarray(one).tolist() == list(range(8))
    assert shard_batch_tree(one, _mesh(2)) is one
    assert [p.tolist() for p in shard_batch_tree(one, mesh).parts] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]


def test_uneven_batch_rejected_with_the_jax_message():
    port = ShardedEngine(_ToyEngine(), _mesh(4))
    ref = jax_sharding.ShardedEngine(_ToyEngine(), jax_sharding.make_mesh(
        jax.devices()[:4]))
    msgs = []
    for eng in (port, ref):
        with pytest.raises(ValueError) as exc:
            eng.init_state(6)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "batch size 6 must divide evenly over 4 " \
        "devices"
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch_tree({"x": torch.zeros(6)}, _mesh(4))


def test_sharded_toy_step_matches_local():
    eng = _ToyEngine()
    sharded = ShardedEngine(eng, _mesh(4))
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    st, ref = sharded.init_state(16), eng.init_state(16)
    for _ in range(2):
        out, st = sharded.step(st, x, np.float32(2.0))
        r, ref = eng._step_impl(ref, torch.from_numpy(x), 2.0)
        assert isinstance(out, Sharded) and out.mesh == sharded.mesh
        np.testing.assert_array_equal(np.asarray(out), r.numpy())
    _assert_trees_equal(unshard_batch_tree(st), ref)
    with pytest.raises(RuntimeError, match="inside _run"):
        sharded._step_impl(st, x, 2.0)
    # The JAX constructor order; metadata delegated, dunders not.
    assert ShardedEngine(eng, _mesh(2), "streams", True).num_devices == 2
    assert sharded.device == torch.device("cpu")
    assert sharded.hop_samples == 4 and not hasattr(sharded, "__deepcopy__")


# ---- the sharded engines --------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["float", "bf16"])
def test_sharded_engines_equal_one_engine_bitwise(engines, one_engine_runs,
                                                  mode, n):
    """Encoder indices, decoder audio and comfort-noise flags over HOPS
    hops with PLC (every third packet lost) and a burst into comfort
    noise on a row of a later shard, and the final state trees: bitwise
    one engine's."""
    enc, dec = (ShardedEngine(e, _mesh(n)) for e in engines[mode])
    audio, (ref, es_ref, ds_ref) = one_engine_runs[mode]
    got, es, ds = _run(enc, dec, audio, _received(HOPS))
    _assert_runs_match(got, ref)
    assert sum(r[2][BURST_ROW] for r in ref) >= 4  # comfort noise reached
    assert isinstance(es, Sharded) and isinstance(ds, Sharded)
    _assert_trees_equal(unshard_batch_tree(es), es_ref)
    _assert_trees_equal(unshard_batch_tree(ds), ds_ref, skip=GEMM_STATE)


def _decode(dec, state, indices, received):
    out = []
    for t in range(indices.shape[0]):
        pre = state
        pcm, cn, state = dec.step(state, indices[t], received[t])
        out.append((np.asarray(pcm), np.asarray(cn), _cn_enters(pre, state)))
    return out


def test_comfort_noise_lineage_of_a_later_shard(engines):
    """The comfort-noise PCM of BURST_ROW (shard 1 of 2) after its long
    loss burst is the unsharded engine's (within the GEMMs' 1 LSB): the
    fresh state is built at the global batch and split, so the row keeps
    its counter.  A state built per shard (each shard's rows seeded as
    rows 0 … B/2 − 1) gives other noise: the check can fail."""
    dec = engines["float"][1]
    sharded = ShardedEngine(dec, _mesh(2))
    rng = np.random.default_rng(4)
    indices = rng.integers(0, 16, (HOPS, B, 46)).astype(np.int32)
    received = _received(HOPS)
    ref = _decode(dec, dec.init_state(B), indices, received)
    got = _decode(sharded, sharded.init_state(B), indices, received)
    cn_ticks = [t for t in range(HOPS) if ref[t][1][BURST_ROW]]
    assert len(cn_ticks) >= 4
    for t in range(HOPS):
        np.testing.assert_array_equal(got[t][1], ref[t][1])
        _assert_audio(got[t][0], ref[t][0], ref[t][2])

    def twice(tree):
        if isinstance(tree, dict):
            return {k: twice(v) for k, v in tree.items()}
        return torch.cat([tree, tree])

    per_shard = shard_batch_tree(twice(dec.init_state(B // 2)), sharded.mesh)
    other = _decode(sharded, per_shard, indices, received)
    assert max(np.abs(other[t][0][BURST_ROW] - ref[t][0][BURST_ROW]).max()
               for t in cn_ticks) > 100.0


def test_reset_rows_mid_run_equals_one_engine(engines):
    """reset_rows with a seed on a sharded decoder (rows in both shards)
    and a sharded encoder, mid-run: one engine's results."""
    enc, dec = engines["float"]
    audio, received = _audio(5, 12), _received(12)
    mask = np.zeros(B, bool)
    mask[[1, 6]] = True
    ref, _, ds_ref = _run(enc, dec, audio, received, reset_at=(6, mask))
    got, _, ds = _run(ShardedEngine(enc, _mesh(2)),
                      ShardedEngine(dec, _mesh(2)), audio, received,
                      reset_at=(6, mask))
    _assert_runs_match(got, ref)
    _assert_trees_equal(unshard_batch_tree(ds), ds_ref, skip=GEMM_STATE)


def test_no_cross_shard_traffic(engines):
    """The port's analog of the JAX test that the sharded program has no
    tensor collectives: change shard 1's inputs and no bit of shard 0's
    outputs or state moves (and shard 1's do)."""
    enc, dec = (ShardedEngine(e, _mesh(2)) for e in engines["float"])
    audio, received = _audio(6, 8), _received(8)
    audio2, received2 = audio.copy(), received.copy()
    audio2[:, B // 2:] = _audio(7, 8)[:, B // 2:]
    received2[:, B // 2:] = ~received2[:, B // 2:]
    runs = []
    for a, r in ((audio, received), (audio2, received2)):
        es, ds, out = enc.init_state(B), dec.init_state(B), []
        for t in range(8):
            idx, _, es = enc.step(es, a[t], NQ)
            pcm, cn, ds = dec.step(ds, idx, r[t])
            out.append([np.asarray(x) for x in (idx, pcm, cn)])
        runs.append((out, es, ds))
    (o1, es1, ds1), (o2, es2, ds2) = runs
    h = B // 2
    for a, b in zip(o1, o2):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[:h], y[:h])
    _assert_trees_equal(es1.parts[0], es2.parts[0])
    _assert_trees_equal(ds1.parts[0], ds2.parts[0])
    assert not np.array_equal(o1[-1][1][h:], o2[-1][1][h:])


def test_wire_roundtrip_around_sharded_tick(engines):
    """Mirror of tests/test_sharding.py::test_wire_roundtrip_around_
    sharded_tick: the sharded encoder's indices through the host packet
    codec (native), unpacked and fed to a sharded decoder, as a serving
    host does each 20 ms."""
    enc, dec = (ShardedEngine(e, _mesh(4)) for e in engines["float"])
    bits = 120
    nq = np.full(B, bits // config.BITS_PER_QUANTIZER, np.int32)
    audio = np.random.default_rng(2).integers(
        -8000, 8000, (B, 320)).astype(np.float32)
    est, dst = enc.init_state(B), dec.init_state(B)
    for t in range(3):
        idx, _, est = enc.step(est, audio, nq)
        idx = np.asarray(idx)
        pkts = packet.pack_indices_batch(idx[:, :nq[0]], bits)
        assert pkts.shape == (B, config.packet_size(bits))
        back = packet.unpack_indices_batch(pkts, bits)
        np.testing.assert_array_equal(back, idx[:, :nq[0]])
        received = np.ones(B, bool)
        received[t::5] = False
        padded = np.full((B, idx.shape[1]), -1, np.int32)
        padded[:, :nq[0]] = back
        out, _, dst = dec.step(dst, padded, received)
        assert np.asarray(out).shape == (B, 320)


# ---- against the JAX ShardedEngine ---------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_engines():
    return JaxEncoder(16000, SMALL), JaxDecoder(16000, SMALL)


def test_port_sharded_engine_matches_jax_sharded_engine(engines,
                                                        jax_engines):
    """Port ShardedEngine over 4 CPU shards vs the JAX ShardedEngine over 4
    CPU devices, float, 12 ticks, each from the JAX pre-tick state
    (gathered from the JAX mesh and sharded over the port's)."""
    mesh = jax_sharding.make_mesh(jax.devices()[:4])
    jenc, jdec = (jax_sharding.ShardedEngine(e, mesh) for e in jax_engines)
    penc, pdec = (ShardedEngine(e, _mesh(4)) for e in engines["float"])
    audio, received = _audio(8, 12), _received(12)
    jes, jds = jenc.init_state(B), jdec.init_state(B)
    for t in range(12):
        pes = shard_batch_tree(state_from_numpy(_np_tree(jes), "cpu"),
                               penc.mesh)
        pds = shard_batch_tree(state_from_numpy(_np_tree(jds), "cpu"),
                               pdec.mesh)
        jidx, _, jes = jenc.step(jes, audio[t], np.full(B, NQ, np.int32))
        pidx, _, _ = penc.step(pes, audio[t], NQ)
        jidx, pidx = np.asarray(jidx), np.asarray(pidx)
        # A row may differ only at an RVQ near-tie; none does on this data.
        assert (pidx != jidx).any(axis=1).sum() == 0, t
        jout, jcn, jds = jdec.step(jds, jidx, received[t])
        pout, pcn, _ = pdec.step(pds, jidx, received[t])
        assert np.abs(np.asarray(pout) - np.asarray(jout)).max() <= 1.0, t
        np.testing.assert_array_equal(np.asarray(pcn), np.asarray(jcn))


# ---- servers, snapshots and the bridge ---------------------------------------


def _server_run(enc_e, dec_e, audio, received, ticks):
    """tick_wire pairs at capacity B with admissions and evictions (two
    streams evicted at tick 4, two admitted into chosen slots at tick 8),
    then the async pipelines over the same inputs.  → per tick (wire,
    sizes, audio, comfort-noise flags, rows with comfort noise in the
    hop), and the async outputs (wire, sizes, audio) one tick later."""
    outs = []
    for asynchronous in (False, True):
        enc = EncoderServer(B, engine=enc_e, bitrate=6000)
        dec = DecoderServer(B, engine=dec_e)
        for srv in (enc, dec):
            srv.add_streams(range(B))
        run = []
        for t in range(ticks):
            if t == 4:
                for srv in (enc, dec):
                    srv.remove_stream(2)
                    srv.remove_stream(5)
            if t == 8:
                for srv in (enc, dec):
                    srv.add_streams(["x", "y"], slots={"x": 5, "y": 2})
            if asynchronous:
                w = enc.tick_wire_async(audio[t])
                if w is not None:
                    a = dec.tick_wire_async(w[0], received[t] & (w[1] > 0),
                                            w[1])
                    run.append((*w, a))
            else:
                pre = dec._state
                wire, sizes = enc.tick_wire(audio[t])
                a = dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
                run.append((wire, sizes, a, dec._last_comfort.copy(),
                            _cn_enters(pre, dec._state)))
        outs.append(run)
    return outs


def test_servers_over_sharded_engines_equal_unsharded(engines):
    """EncoderServer / DecoderServer over ShardedEngines (2 shards) against
    the unsharded servers through admissions and evictions: wire bytes,
    sizes and comfort-noise flags bitwise, audio by the module's bar;
    the sharded encoder's async pipeline gives its synchronous ticks'
    wire one tick later."""
    enc, dec = engines["float"]
    audio = np.clip(_audio(9, 12), -32768, 32767).astype(np.int16)
    received = _received(12)
    ref, _ = _server_run(enc, dec, audio, received, 12)
    got, got_async = _server_run(ShardedEngine(enc, _mesh(2)),
                                 ShardedEngine(dec, _mesh(2)), audio,
                                 received, 12)
    for r, g in zip(ref, got):
        for k in (0, 1, 3, 4):
            np.testing.assert_array_equal(g[k], r[k])
        _assert_audio(g[2], r[2], r[4])
    assert len(got_async) == 11
    for t, a in enumerate(got_async):
        np.testing.assert_array_equal(a[0], got[t][0])
        np.testing.assert_array_equal(a[1], got[t][1])
    assert got_async[0][2] is None and got_async[1][2].shape == (B, 320)


def _snapshot_pair(dec_e, enc_e, tmp, name, audio, received, ticks=3):
    """Server pair at capacity B: `ticks` tick_wire ticks, then a save.
    → (the pair, the paths)."""
    enc = EncoderServer(B, engine=enc_e, bitrate=6000)
    dec = DecoderServer(B, engine=dec_e)
    for srv in (enc, dec):
        srv.add_streams(range(B))
    for t in range(ticks):
        wire, sizes = enc.tick_wire(audio[t])
        dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
    paths = (os.path.join(tmp, name + ".enc"), os.path.join(tmp, name + ".dec"))
    enc.save(paths[0])
    dec.save(paths[1])
    return (enc, dec), paths


@pytest.mark.parametrize("shards", [(1, 2), (2, 1), (2, 4)])
def test_restore_lands_sharded_and_crosses_meshes(engines, tmp_path, shards):
    """A snapshot of a server pair over N shards (1 = one engine) restores
    into a pair over M shards: the state lands sharded over the new mesh
    (each part on its shard's device, B/M rows), the snapshot holds the
    unsharded layout, and the calls continue bit for bit."""
    enc, dec = engines["float"]

    def over(n, e):
        return e if n == 1 else ShardedEngine(e, _mesh(n))

    audio = np.clip(_audio(10, 6), -32768, 32767).astype(np.int16)
    received = _received(6)
    (src_e, src_d), paths = _snapshot_pair(over(shards[0], dec),
                                           over(shards[0], enc), tmp_path,
                                           "src", audio, received)
    dst_e = EncoderServer(B, engine=over(shards[1], enc), bitrate=6000)
    dst_d = DecoderServer(B, engine=over(shards[1], dec))
    dst_e.restore(paths[0])
    dst_d.restore(paths[1])
    if shards[1] > 1:
        for srv in (dst_e, dst_d):
            assert isinstance(srv._state, Sharded)
            assert srv._state.mesh == _mesh(shards[1])
            leaf = next(iter(_flat(srv._state.parts[-1]).values()))
            assert leaf.shape[0] == B // shards[1]
    for t in range(3, 6):
        outs = []
        pre = src_d._state
        for e, d in ((src_e, src_d), (dst_e, dst_d)):
            wire, sizes = e.tick_wire(audio[t])
            outs.append((wire, sizes, d.tick_wire(
                wire, received[t] & (sizes > 0), sizes)))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        _assert_audio(outs[1][2], outs[0][2], _cn_enters(pre, src_d._state))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_jax_and_port_sharded(engines, jax_engines,
                                              tmp_path, writer):
    """A float snapshot of a decoder server over the JAX ShardedEngine (4
    CPU devices) resumes on the port's over 4 CPU shards, and back: the
    next ticks agree within 1 int16 LSB, the comfort-noise flags equal."""
    jmesh = jax_sharding.make_mesh(jax.devices()[:4])
    jdec = jax_server.DecoderServer(B, engine=jax_sharding.ShardedEngine(
        jax_engines[1], jmesh))
    pdec = DecoderServer(B, engine=ShardedEngine(engines["float"][1],
                                                 _mesh(4)))
    rng = np.random.default_rng(11)
    wire = rng.integers(0, 256, (8, B, 15), dtype=np.uint8)
    received = _received(8)
    src, dst = (jdec, pdec) if writer == "jax" else (pdec, jdec)
    src.add_streams(range(B))
    for t in range(4):
        src.tick_wire(wire[t], received[t])
    snap = str(tmp_path / "snap")
    src.save(snap)
    dst.restore(snap)
    if writer == "jax":
        assert isinstance(pdec._state, Sharded)
    for t in range(4, 8):
        a, b = (s.tick_wire(wire[t], received[t]) for s in (jdec, pdec))
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(jdec._last_comfort, pdec._last_comfort)


def _bridge(engines, n, cap=B):
    enc, dec = engines["float"]
    if n > 1:
        enc, dec = ShardedEngine(enc, _mesh(n)), ShardedEngine(dec, _mesh(n))
    return ConferenceBridge(cap, dec_engine=dec, enc_engine=enc)


def test_sharded_bridge_matches_unsharded(engines):
    """Mirror of tests/test_sharding.py::test_sharded_bridge_matches_
    unsharded: rooms of 2 placed by shard_affine_slots on a 2-shard bridge
    (the same slots on the unsharded one), 10 tick_wire ticks of mixed-
    size uplinks with loss, then the async pipeline: the downlink bitwise
    the unsharded bridge's in every room none of whose uplinks has had
    comfort noise in it yet (the module's bar, carried through the mix
    and the re-encode), and so are the comfort-noise flags."""
    sharded, one = _bridge(engines, 2), _bridge(engines, 1)
    assert (sharded.num_shards, one.num_shards) == (2, 1)
    rooms = {f"p{i}": i // 2 for i in range(B)}
    slots = sharded.shard_affine_slots(rooms)
    for b in (sharded, one):
        assert b.add_participants(rooms, slots=slots) == slots
    room_of = np.zeros(B, np.int64)
    for sid, slot in slots.items():
        room_of[slot] = rooms[sid]
    tainted = np.zeros(B // 2, bool)
    rng = np.random.default_rng(12)
    sizes = np.array([8, 15, 23])[np.arange(B) % 3].astype(np.int32)

    def compare(outs):
        clean = ~tainted[room_of]
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x[clean], y[clean])

    for t in range(10):
        pkts = rng.integers(0, 256, (B, 23), dtype=np.uint8)
        received = rng.random(B) > 0.2
        pre = one._dec._state
        outs = [b.tick_wire(pkts, received, sizes) for b in (sharded, one)]
        tainted[room_of[_cn_enters(pre, one._dec._state)]] = True
        compare(outs)
        np.testing.assert_array_equal(sharded._dec._last_comfort,
                                      one._dec._last_comfort)
    assert not tainted.all()
    for t in range(3):  # the async pipeline: two submits, then the flush
        pre = one._dec._state
        if t < 2:
            outs = [b.tick_wire_async(pkts, received, sizes)
                    for b in (sharded, one)]
            tainted[room_of[_cn_enters(pre, one._dec._state)]] = True
        else:
            outs = [b.flush_async() for b in (sharded, one)]
        if t == 0:
            assert outs == [None, None]
        else:
            compare(outs)


def test_sharded_bridge_refuses_straddling_room(engines):
    """A room admitted across the shard boundary is refused at the tick
    (the shard-local mixer would mis-mix it), before any program runs."""
    bridge = _bridge(engines, 2)
    bridge.add_participants({"a": 0, "b": 0, "c": 1, "d": 1},
                            slots={"a": 3, "b": 4, "c": 0, "d": 1})
    with pytest.raises(ValueError, match="straddles mesh shards 0 and 1"):
        bridge.tick_wire(np.zeros((B, 8), np.uint8), np.ones(B, bool))
    with pytest.raises(ValueError, match="already straddles"):
        bridge.shard_affine_slots({"e": 0})


def test_sharded_bridge_rejects_mismatched_meshes(engines):
    enc, dec = engines["float"]
    with pytest.raises(ValueError, match="share one mesh"):
        ConferenceBridge(B, dec_engine=ShardedEngine(dec, _mesh(2)),
                         enc_engine=ShardedEngine(enc, _mesh(4)))
    with pytest.raises(ValueError, match="share one mesh"):
        ConferenceBridge(B, dec_engine=ShardedEngine(dec, _mesh(2)),
                         enc_engine=enc)
    with pytest.raises(ValueError, match="divide evenly"):
        ConferenceBridge(6, dec_engine=ShardedEngine(dec, _mesh(4)),
                         enc_engine=ShardedEngine(enc, _mesh(4)))


def test_shard_affine_slots_keep_rooms_inside_shards(engines):
    """Largest rooms first into the emptiest shard, sitting rooms pinned
    to their shard, all or nothing."""
    bridge = _bridge(engines, 4, cap=16)
    rooms = {"a0": "A", "a1": "A", "a2": "A", "b0": "B", "b1": "B",
             "c0": "C"}
    slots = bridge.shard_affine_slots(rooms)
    shard = {sid: s // 4 for sid, s in slots.items()}
    for room in "ABC":
        assert len({shard[s] for s in rooms if rooms[s] == room}) == 1
    assert len({shard["a0"], shard["b0"], shard["c0"]}) == 3
    bridge.add_participants(rooms, slots=slots)
    more = bridge.shard_affine_slots({"a3": "A", "d0": "D"})
    assert more["a3"] // 4 == shard["a0"]
    assert more["d0"] // 4 not in {shard["a0"], shard["b0"], shard["c0"]}
    with pytest.raises(RuntimeError, match="do not fit in shard"):
        bridge.shard_affine_slots({f"e{i}": "E" for i in range(5)})
    assert bridge.num_active == 6  # nothing was placed


def test_dryrun_multichip_on_a_cpu_mesh():
    dryrun_multichip(4, devices=["cpu"] * 4, model_path=SMALL)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        dryrun_multichip(4, devices=["cpu"] * 2, model_path=SMALL)
