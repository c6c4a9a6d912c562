"""The port's lockstep codec tick vs the JAX engines, stage by stage.

Encoder and decoder engines of both packages run on the small synthetic
fixture for 60 hops with a loss pattern that reaches concealment, the fade
and comfort noise (an 8-hop burst, plus every 7th hop lost on some
streams).  The port starts from the JAX state after 10 warm ticks
(`state_from_numpy`), then each stage is compared from identical inputs so
float drift cannot flip a discrete decision:

  * SoundStream features within float32 tolerance;
  * RVQ indices and wire bytes from the JAX features: identical;
  * decoded audio from the JAX indices: within 1 int16 LSB;
  * is_comfort_noise and the PLC counters: equal.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu import config as jax_config
from lyra_tpu import packet as jax_packet
from lyra_tpu.codec.engine import DecoderEngine as JaxDecoder
from lyra_tpu.codec.engine import EncoderEngine as JaxEncoder
from lyra_tpu.dsp import utils as jax_dsp_utils
from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import (
    BACKEND_NAMES,
    DecoderEngine,
    EncoderEngine,
)
from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.utils.state import state_from_numpy, state_to_numpy

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
B, WARM, HOPS, NUM_BITS = 4, 10, 60, 120
NQ = NUM_BITS // 4


def _audio(seed, hops, b=B):
    """Int16-scale noise with loud and quiet stretches per stream."""
    rng = np.random.default_rng(seed)
    gain = np.where(rng.random((hops, b, 1)) < 0.7, 4000.0, 40.0)
    return (rng.normal(0.0, 1.0, (hops, b, 320)) * gain).astype(np.float32)


def _received(hops, b=B):
    rec = np.ones((hops, b), bool)
    rec[WARM + 12:WARM + 20, :] = False      # 8-hop burst: fade → CNG
    rec[np.arange(hops) % 7 == 3, 1::2] = False  # every 7th, odd streams
    return rec


def _tree_shapes(tree):
    return jax.tree.map(lambda x: tuple(np.shape(x)), tree)


@pytest.fixture(scope="module")
def jax_engines():
    return JaxEncoder(16000, SMALL), JaxDecoder(16000, SMALL)


@pytest.fixture(scope="module")
def jax_run(jax_engines):
    """The JAX slice over HOPS ticks: the state after WARM ticks, then per
    tick the features, indices, DTX flags, audio, comfort-noise flags and
    decoder state."""
    je, jd = jax_engines
    extract = jax.jit(je.soundstream.extract)
    audio, rec = _audio(0, HOPS), _received(HOPS)
    jes, jds = je.init_state(B), jd.init_state(B, seed=5)
    for t in range(WARM):
        idx, _, jes = je.step(jes, audio[t], NQ)
        _, _, jds = jd.step(jds, idx, rec[t])
    warm = (jax.tree.map(np.asarray, jes), jax.tree.map(np.asarray, jds))
    ticks = []
    for t in range(WARM, HOPS):
        feats, _ = extract(jes["soundstream"],
                           jax_dsp_utils.int16_to_unit(jnp.asarray(audio[t])))
        idx, noise, jes = je.step(jes, audio[t], NQ)
        out, cn, jds = jd.step(jds, idx, rec[t])
        ticks.append(jax.tree.map(np.array, (feats, idx, noise, out, cn, jds)))
    return audio, rec, warm, ticks


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_slice_matches_jax_stage_by_stage(jax_run, backend):
    te = EncoderEngine(16000, SMALL, backend=backend, device="cpu")
    td = DecoderEngine(16000, SMALL, backend=backend, device="cpu")
    audio, rec, (jes, jds), ticks = jax_run
    assert _tree_shapes(state_to_numpy(te.init_state(B))) == _tree_shapes(jes)
    assert _tree_shapes(state_to_numpy(td.init_state(B, seed=5))) == \
        _tree_shapes(jds)
    tes, tds = state_from_numpy(jes, "cpu"), state_from_numpy(jds, "cpu")

    reached = set()
    for t, (jf, jidx, jnoise, ja, jcn, jds) in zip(range(WARM, HOPS), ticks):
        x = torch.from_numpy(audio[t])
        # Encoder: features from the port's own carried state.
        tf, _ = te.soundstream.extract(tes["soundstream"],
                                       dsp_utils.int16_to_unit(x))
        assert np.abs(tf.numpy() - jf).max() <= 1e-5 * np.abs(jf).max(), t
        _, tnoise, tes = te.step(tes, x, NQ)
        np.testing.assert_array_equal(tnoise.numpy(), jnoise)
        # Indices and wire bytes from identical features.
        tidx = te.rvq.quantize(torch.from_numpy(jf), NQ,
                               method="kernel" if backend == "kernel" else "fast")
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        wire = packet.pack_wire_device(tidx, NUM_BITS)
        np.testing.assert_array_equal(
            wire.numpy(), jax_packet.pack_indices_batch_np(jidx, NUM_BITS))
        dec_idx = torch.full((B, 46), -1, dtype=torch.int32)
        dec_idx[:, :NQ] = packet.unpack_wire_device(wire, NUM_BITS)
        # Decoder from identical indices, its own carried state.
        ta, tcn, tds = td.step(tds, dec_idx, torch.from_numpy(rec[t]))
        assert np.abs(ta.numpy() - ja).max() <= 1.0, t
        np.testing.assert_array_equal(tcn.numpy(), jcn)
        for k in ("concealment", "fade", "fade_dir"):
            np.testing.assert_array_equal(tds[k].numpy(), jds[k])
        np.testing.assert_array_equal(
            tds["cng"]["ctr"].numpy().astype(np.uint32), jds["cng"]["ctr"])
        reached.update(zip(tds["fade"].numpy().tolist(),
                           tds["concealment"].numpy().tolist()))
    fades = {f for f, _ in reached}
    assert {0, 640} <= fades and fades - {0, 640}, fades  # fade, full CNG
    assert max(c for _, c in reached) == 1280  # saturated concealment


def test_dtx_noise_decisions_match_jax():
    je = JaxEncoder(16000, SMALL, enable_dtx=True)
    te = EncoderEngine(16000, SMALL, enable_dtx=True, device="cpu")
    rng = np.random.default_rng(1)
    hops = 30
    gain = np.where((np.arange(hops) // 5) % 2 == 0, 5000.0, 2.0)
    audio = (rng.normal(0, 1, (hops, B, 320)) * gain[:, None, None]).astype(
        np.float32)
    jes = je.init_state(B)
    tes = state_from_numpy(jax.tree.map(np.asarray, jes), "cpu")
    seen = set()
    for t in range(hops):
        # Classify from the JAX pre-tick noise state, so a near-threshold
        # float difference cannot carry into later decisions.
        tes["noise"] = state_from_numpy(
            jax.tree.map(np.asarray, jes["noise"]), "cpu")
        jidx, jn, jes = je.step(jes, audio[t], NQ)
        tidx, tn, tes = te.step(tes, torch.from_numpy(audio[t]), NQ)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        # A noise hop leaves the SoundStream state untouched.
        js = state_to_numpy(tes["soundstream"])
        for k, v in jes["soundstream"].items():
            np.testing.assert_allclose(js[k], np.asarray(v), rtol=1e-5,
                                       atol=1e-5)
        seen.update(tn.numpy().tolist())
    assert seen == {True, False}


def test_max_bitrate_and_int16_emit_are_exact():
    audio, rec = _audio(2, 12), _received(12)
    enc = EncoderEngine(16000, SMALL, device="cpu")
    enc_cap = EncoderEngine(16000, SMALL, max_bitrate=6000, device="cpu")
    dec = DecoderEngine(16000, SMALL, device="cpu")
    dec_cap = DecoderEngine(16000, SMALL, max_bitrate=6000, emit_dtype="int16",
                            device="cpu")
    es, ecs = enc.init_state(B), enc_cap.init_state(B)
    ds, dcs = dec.init_state(B), dec_cap.init_state(B)
    for t in range(12):
        x = torch.from_numpy(audio[t])
        idx, _, es = enc.step(es, x, NQ)
        idx_c, _, ecs = enc_cap.step(ecs, x, NQ)
        assert torch.equal(idx, idx_c)
        a, cn, ds = dec.step(ds, idx, torch.from_numpy(rec[t]))
        a_c, cn_c, dcs = dec_cap.step(dcs, idx_c, torch.from_numpy(rec[t]))
        assert a_c.dtype == torch.int16
        assert torch.equal(a.to(torch.int16), a_c) and torch.equal(cn, cn_c)
    with pytest.raises(ValueError):
        EncoderEngine(16000, SMALL, max_bitrate=1234, device="cpu")
    with pytest.raises(ValueError):
        DecoderEngine(44100, SMALL, device="cpu")


def test_reset_rows_matches_jax(jax_engines):
    je, jd = jax_engines
    te = EncoderEngine(16000, SMALL, device="cpu")
    td = DecoderEngine(16000, SMALL, device="cpu")
    audio, rec = _audio(3, 6), _received(6)
    jes, jds = je.init_state(B), jd.init_state(B, seed=2)
    for t in range(6):
        idx, _, jes = je.step(jes, audio[t], NQ)
        _, _, jds = jd.step(jds, idx, rec[t])
    mask = np.array([False, True, False, True])
    for eng, jeng, st, kw in ((te, je, jes, {}), (td, jd, jds, {"seed": 2})):
        ours = state_to_numpy(eng.reset_rows(
            state_from_numpy(jax.tree.map(np.asarray, st), "cpu"),
            torch.from_numpy(mask), **kw))
        ref = jax.tree.map(np.asarray, jeng.reset_rows(st, jnp.asarray(mask),
                                                       **kw))
        jax.tree.map(np.testing.assert_array_equal, ours, ref)
        fresh = jax.tree.map(np.asarray, jeng.init_state(B, **kw))
        jax.tree.map(lambda o, f: np.testing.assert_array_equal(o[1], f[1]),
                     ours, fresh)


def test_state_roundtrip_keeps_jax_dtypes(jax_engines):
    _, jd = jax_engines
    st = jax.tree.map(np.asarray, jd.init_state(B, seed=9))
    back = state_to_numpy(state_from_numpy(st, "cpu"))
    jax.tree.map(lambda a, b: (np.testing.assert_array_equal(a, b),
                               np.testing.assert_equal(a.dtype, b.dtype)),
                 back, st)
    assert back["cng"]["ctr"].dtype == np.uint32


def test_engines_default_to_the_card():
    """Without device= an engine runs on the card; on a torch that sees no
    CUDA device it raises and names device="cpu", never falls back."""
    if torch.cuda.is_available():
        assert EncoderEngine(16000, SMALL).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        EncoderEngine(16000, SMALL)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DecoderEngine(16000, SMALL)
    assert EncoderEngine(16000, SMALL, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("engines", [(DecoderEngine, JaxDecoder),
                                     (EncoderEngine, JaxEncoder)])
def test_constructors_take_the_jax_parameters_in_order(engines):
    """The same parameters in the same order with the same defaults, but
    for `backend` (the port's "kernel", JAX's "xla") and the port's
    keyword-only `device`; `model_path` defaults to each package's
    config.DEFAULT_MODEL_PATH."""
    ours, ref = (inspect.signature(e.__init__).parameters for e in engines)
    assert list(ours)[:-1] == list(ref)
    for name, p in ref.items():
        assert ours[name].kind == p.kind, name
        if name not in ("backend", "model_path"):
            assert ours[name].default == p.default, name
    assert ours["backend"].default == "kernel"
    assert ours["model_path"].default == config.DEFAULT_MODEL_PATH
    assert ref["model_path"].default == jax_config.DEFAULT_MODEL_PATH
    assert ours["device"].kind == inspect.Parameter.KEYWORD_ONLY
    assert ours["device"].default is None


def test_positional_mode_and_jax_backend_names():
    dec = DecoderEngine(16000, SMALL, "bf16", device="cpu")
    assert dec._decode_dtype == torch.bfloat16 and dec.backend == "kernel"
    enc = EncoderEngine(16000, SMALL, False, "bf16", "xla", device="cpu")
    assert enc.backend == "plain" and enc._rvq_method == "fast"
    assert BACKEND_NAMES == {"kernel": "kernel", "plain": "plain",
                             "fused": "kernel", "xla": "plain"}
    for name, port in BACKEND_NAMES.items():
        assert EncoderEngine(16000, SMALL, backend=name,
                             device="cpu").backend == port
        assert DecoderEngine(16000, SMALL, backend=name,
                             device="cpu").backend == port
    for engine in (EncoderEngine, DecoderEngine):
        with pytest.raises(ValueError) as err:
            engine(16000, SMALL, backend="pallas", device="cpu")
        assert all(repr(n) in str(err.value) for n in BACKEND_NAMES)
    with pytest.raises(TypeError):
        DecoderEngine(16000, SMALL, gate_idle_stages="yes", device="cpu")


def test_gate_idle_stages_changes_no_bit():
    """The port always synthesizes comfort noise, so both values give the
    same ticks, through concealment, the fade and comfort noise (the JAX
    package pins the same equality for its gate:
    test_codec_engine.py::test_idle_stage_gating_is_bit_identical)."""
    hops = 16
    audio = _audio(4, hops)
    rec = np.ones((hops, B), bool)
    rec[3:13, ::2] = False  # 10 lost hops: concealment, fade, comfort noise
    enc = EncoderEngine(16000, SMALL, device="cpu")
    decs = [DecoderEngine(16000, SMALL, gate_idle_stages=g, device="cpu")
            for g in (True, False)]
    es = enc.init_state(B)
    ds = [d.init_state(B, seed=3) for d in decs]
    fades = set()
    for t in range(hops):
        idx, _, es = enc.step(es, torch.from_numpy(audio[t]), NQ)
        outs = []
        for i, d in enumerate(decs):
            a, cn, ds[i] = d.step(ds[i], idx, torch.from_numpy(rec[t]))
            outs.append((a, cn))
        assert torch.equal(outs[0][0], outs[1][0]), t
        assert torch.equal(outs[0][1], outs[1][1]), t
        fades.update(ds[0]["fade"].tolist())
    assert {0, 640} <= fades and fades - {0, 640}, fades
