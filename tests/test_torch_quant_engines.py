"""The port's engines in the quantized modes vs the JAX engines, on the CPU.

EncoderEngine → DecoderEngine on backend "plain" (the JAX "xla"), which
alone runs these modes, on the small islands fixture (tests/golden/
synthetic_lyra_islands/small), inputs made from a numpy seed:

  * int8, fakequant and int8 state storage (float and bf16) and fp8
    boundaries (float and bf16): each tick from the JAX engines' pre-hop
    state, features within 1e-5 × max|ref| (3e-2 in bf16 and with fp8
    boundaries), indices from the JAX features bitwise, decoder audio on
    the JAX indices within 1 int16 LSB (3e-2 × max|ref| in bf16 and with
    fp8 boundaries), the state trees' layout (`{"q", "s"}` leaves);
    (the small fixture has no intermediate of the 1024 elements an fp8
    boundary needs: tests/test_torch_quant_f8.py holds f8 at full width);
  * compressed snapshots in both directions, their bytes at full width,
    and a ShardedEngine over two CPU shards with compressed state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu.codec.engine import DecoderEngine as JaxDecoder
from lyra_tpu.codec.engine import EncoderEngine as JaxEncoder
from lyra_tpu.utils import checkpoint as jax_checkpoint
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.parallel.sharding import ShardedEngine, make_mesh
from lyra_tpu_torch.utils import checkpoint
from lyra_tpu_torch.utils.state import state_from_numpy, state_to_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ISLANDS = os.path.join(GOLDEN, "synthetic_lyra_islands")
SMALL = os.path.join(ISLANDS, "small")
FULL = os.path.join(ISLANDS, "full")
B, HOPS, NQ = 4, 6, 30
BF16_BAR = 3e-2  # × max|ref|, as tests/test_torch_bf16.py
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread for the module: tier-1 runs six test
    workers on the machine's cores, and these small ops gain nothing from
    more threads (measured: the same time alone) but lose several times
    over to the others' oversubscription."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(hops, seed=7, b=B):
    rng = np.random.default_rng(seed)
    gain = np.where(rng.random((hops, b, 1)) < 0.7, 4000.0, 40.0)
    return (rng.normal(0.0, 1.0, (hops, b, 320)) * gain).astype(np.float32)


def _received(hops, b=B):
    rec = np.ones((hops, b), bool)
    rec[3:6, 1] = False
    rec[np.arange(hops) % 4 == 2, 3] = False
    return rec


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, prefix + k + "/")]
    return [(prefix[:-1], tree)]


def _same_leaves(a, b):
    """Two numpy state trees: the same paths, dtypes and bits."""
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b) and any(p.endswith("/q") for p in a)
    for p, v in a.items():
        assert v.dtype == np.asarray(b[p]).dtype, p
        np.testing.assert_array_equal(v, np.asarray(b[p]), err_msg=p)


@pytest.mark.parametrize("kw", [
    {"state_compression": "int8"}, {"state_compression": "int8",
                                    "mode": "bf16"},
    {"boundary_store": "f8"}, {"boundary_store": "f8", "mode": "bf16"},
    {"mode": "int8"}, {"mode": "fakequant"}], ids=lambda kw: "-".join(
        f"{v}" for v in kw.values()))
def test_engines_match_jax(kw):
    """HOPS ticks at B=4 with losses, the port's engines (backend "xla",
    the port's "plain") from the JAX engines' pre-hop state each tick: the
    state trees' paths, shapes and dtypes (`{"q", "s"}` leaves under
    compression); features within 1e-5 × max|ref| (3e-2 in bf16 and with
    fp8 boundaries); the RVQ search (the kernel's CPU version) on the JAX
    features bitwise the JAX indices; audio on the JAX indices within 1
    int16 LSB (3e-2 × max|ref| in bf16 and with fp8 boundaries) and
    comfort-noise flags equal."""
    je, jd = JaxEncoder(16000, SMALL, **kw), JaxDecoder(16000, SMALL, **kw)
    te = EncoderEngine(16000, SMALL, backend="xla", **kw, **CPU)
    td = DecoderEngine(16000, SMALL, backend="xla", **kw, **CPU)
    assert te._rvq_method == "kernel"
    jes, jds = je.init_state(B), jd.init_state(B, seed=3)
    for ours, theirs in ((te.init_state(B), jes), (td.init_state(B, seed=3),
                                                   jds)):
        assert sorted((p, v.shape, str(v.dtype))
                      for p, v in _leaves(state_to_numpy(ours))) == sorted(
            (p, v.shape, str(v.dtype)) for p, v in _leaves(_host(theirs)))
    if kw.get("state_compression"):
        assert any(p.endswith("/q") for p, _ in _leaves(jds))
    float_bar = kw.get("mode") == "bf16" or kw.get("boundary_store")
    extract = jax.jit(je.soundstream.extract)
    audio, rec = _audio(HOPS), _received(HOPS)
    for t in range(HOPS):
        unit = audio[t] / 32768.0
        jf = np.asarray(extract(jes["soundstream"], jnp.asarray(unit))[0])
        tf, _ = te.soundstream.extract(
            state_from_numpy(_host(jes["soundstream"]), "cpu"),
            torch.from_numpy(unit))
        rel = BF16_BAR if float_bar else 1e-5
        assert np.abs(tf.numpy() - jf).max() <= rel * np.abs(jf).max(), t
        jidx, jnoise, jes2 = je.step(jes, audio[t], NQ)
        tidx = te.rvq.quantize(torch.from_numpy(jf), NQ, method="kernel")
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        ja, jcn, jds2 = jd.step(jds, jidx, rec[t])
        ta, tcn, tds = td.step(state_from_numpy(_host(jds), "cpu"),
                               torch.from_numpy(np.asarray(jidx)),
                               torch.from_numpy(rec[t]))
        ja = np.asarray(ja)
        bar = BF16_BAR * np.abs(ja).max() if float_bar else 1.0
        assert np.abs(ta.numpy() - ja).max() <= bar, t
        np.testing.assert_array_equal(tcn.numpy(), np.asarray(jcn))
        jes, jds = jes2, jds2


def test_compressed_snapshots_cross_packages_and_shards(tmp_path):
    """state_compression="int8": a JAX snapshot restores in the port and a
    port snapshot in the JAX package, leaf for leaf bitwise ({"q", "s"}
    included); the compressed decoder state is under 0.55 × the float
    state's bytes (tests/test_checkpoint.py's bar); a ShardedEngine over
    two CPU shards steps the compressed state as one engine does, its
    `s` leaves split by rows."""
    jd = JaxDecoder(16000, SMALL, state_compression="int8")
    td = DecoderEngine(16000, SMALL, backend="plain",
                       state_compression="int8", **CPU)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 16, (B, td.rvq.num_stages)).astype(np.int32)
    rec = np.array([True, True, False, True])
    js = jd.init_state(B, seed=1)
    for _ in range(3):
        _, _, js = jd.step(js, idx, rec)
    jax_checkpoint.save_state(str(tmp_path / "jax"), js)
    back, _ = checkpoint.load_state(str(tmp_path / "jax"))
    ts = state_from_numpy(back, "cpu")
    _same_leaves(_host(js), state_to_numpy(ts))
    _, _, ts = td.step(ts, torch.from_numpy(idx), torch.from_numpy(rec))
    checkpoint.save_state(str(tmp_path / "port"), ts)
    jback, _ = jax_checkpoint.load_state(str(tmp_path / "port"))
    _same_leaves(state_to_numpy(ts), jback)
    sizes = {}
    for comp in (None, "int8"):  # at full width, as the JAX test
        full = DecoderEngine(16000, FULL, backend="plain",
                             state_compression=comp, **CPU)
        checkpoint.save_state(str(tmp_path / f"{comp}"), full.init_state(2))
        sizes[comp] = (tmp_path / f"{comp}.npz").stat().st_size
    assert sizes["int8"] < 0.55 * sizes[None], sizes

    sharded = ShardedEngine(td, make_mesh(["cpu"] * 2))
    st, one = sharded.init_state(B), td.init_state(B)
    assert [tuple(p["gan"][k]["s"].shape) for p in st.parts
            for k in td.gan._compress_keys][:1] == [(B // 2,)]
    for _ in range(3):
        a_s, cn_s, st = sharded.step(st, idx, rec)
        a_1, cn_1, one = td.step(one, torch.from_numpy(idx),
                                 torch.from_numpy(rec))
        assert np.abs(np.asarray(a_s) - a_1.numpy()).max() <= 1.0
        np.testing.assert_array_equal(np.asarray(cn_s), cn_1.numpy())
