"""The port's resampler and its 8/32/48 kHz engines vs the JAX package.

  * `Resampler.resample` (strided conv) vs JAX `Resampler.resample` at all
    six rate pairs, state carried over 20 hop-sized blocks: ≤ 1e-3 at
    int16 scale (float32, different summation order); vs the pinned
    goldens (tests/golden/resampler_goldens.npz): ≤ 0.05, the JAX
    package's own bar; vs its own general-ratio gather (the oracle).
  * The host-side numpy paths (`resample_stream_np`, `StreamingResampler`)
    vs the JAX package's: equal (the same numpy code).
  * float engines at 8/32/48 kHz vs the JAX engines, stage by stage from
    the JAX pre-tick state: features within float32 tolerance, indices from
    the JAX features identical, audio from the JAX indices within 1 int16
    LSB, PLC counters equal, and the state tree (with its "resampler"
    leaf) of the JAX engine's keys, shapes and dtypes.
"""

import os

import jax
import numpy as np
import pytest
import torch

from lyra_tpu.codec.engine import DecoderEngine as JaxDecoder
from lyra_tpu.codec.engine import EncoderEngine as JaxEncoder
from lyra_tpu.dsp import resampler as jax_resampler
from lyra_tpu.dsp import utils as jax_dsp_utils
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.dsp.resampler import (Resampler, StreamingResampler,
                                          design_polyphase_taps)
from lyra_tpu_torch.utils.state import state_from_numpy, state_to_numpy

GOLDENS = os.path.join(os.path.dirname(__file__), "golden",
                       "resampler_goldens.npz")
SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
PAIRS = [(8000, 16000), (16000, 8000), (16000, 32000), (32000, 16000),
         (16000, 48000), (48000, 16000)]
JAX_TOL, GOLDEN_TOL = 1e-3, 0.05


def _blocks(in_rate, n_blocks, b=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1000.0, (b, n_blocks * in_rate // 50))
    return np.clip(x, -32768, 32767).astype(np.float32)


@pytest.mark.parametrize("rates", PAIRS)
def test_resample_matches_jax_over_20_blocks(rates):
    block = rates[0] // 50
    x = _blocks(rates[0], 20)
    jr, tr = jax_resampler.Resampler(*rates), Resampler(*rates, device="cpu")
    np.testing.assert_array_equal(tr._taps, jr._taps)
    np.testing.assert_array_equal(
        design_polyphase_taps(tr.up, tr.down),
        jax_resampler.design_polyphase_taps(tr.up, tr.down))
    js, ts = jr.init_state(3), tr.init_state(3)
    jstep = jax.jit(jr.resample)
    for i in range(20):
        blk = x[:, i * block:(i + 1) * block]
        jy, js = jstep(js, blk)
        ty, ts = tr.resample(ts, torch.from_numpy(blk))
        assert ty.shape == jy.shape and ty.dtype == torch.float32
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= JAX_TOL, i
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("rates", PAIRS)
def test_resample_matches_goldens(rates):
    data = np.load(GOLDENS)
    key = f"{rates[0]}_{rates[1]}"
    x, want = data[f"in_{key}"], data[f"out_{key}"]
    r = Resampler(*rates, device="cpu")
    block = rates[0] // 50
    state, got = r.init_state(x.shape[0]), []
    for i in range(x.shape[1] // block):
        y, state = r.resample(state, torch.from_numpy(x[:, i * block:(i + 1) * block]))
        got.append(y.numpy())
    got = np.concatenate(got, axis=1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GOLDEN_TOL
    host = np.stack([r.resample_np(row) for row in x])
    assert np.abs(host - want).max() <= GOLDEN_TOL


@pytest.mark.parametrize("rates", PAIRS)
def test_conv_path_matches_gather_oracle(rates):
    r = Resampler(*rates, device="cpu")
    assert r.up == 1 or r.down == 1  # every supported pair is a pure ratio
    rng = np.random.default_rng(3)
    n_in = 2 * rates[0] // 50
    x = torch.from_numpy(rng.uniform(-20000, 20000, (3, n_in)).astype(np.float32))
    state = torch.from_numpy(
        rng.uniform(-20000, 20000, (3, 2 * r.radius)).astype(np.float32))
    y, new_state = r.resample(state, x)
    ext = torch.cat([state, x], dim=1)
    ref = r.resample_gather(ext, r.output_length(n_in))
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=2e-2)
    assert torch.equal(new_state, ext[:, -2 * r.radius:])


@pytest.mark.parametrize("rates", PAIRS)
def test_host_paths_match_jax(rates):
    x = _blocks(rates[0], 3, b=1, seed=4)[0]
    jr, tr = jax_resampler.Resampler(*rates), Resampler(*rates, device="cpu")
    np.testing.assert_array_equal(tr.resample_np(x), jr.resample_np(x))
    assert tr.samples_until_steady_state() == jr.samples_until_steady_state()
    js = jax_resampler.StreamingResampler(*rates)
    ts = StreamingResampler(*rates)
    pcm = x.astype(np.int16)
    block = rates[0] // 50
    for i in range(3):
        got = ts.resample(pcm[i * block:(i + 1) * block])
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, js.resample(pcm[i * block:(i + 1) * block]))
    np.testing.assert_array_equal(
        dsp_utils.clip_to_int16_np(x * 9.0), jax_dsp_utils.clip_to_int16_np(x * 9.0))


B, WARM, HOPS, NQ = 3, 4, 16, 30


def _engine_inputs(rate):
    rng = np.random.default_rng(rate)
    gain = np.where(rng.random((HOPS, B, 1)) < 0.7, 4000.0, 40.0)
    audio = (rng.normal(0.0, 1.0, (HOPS, B, rate // 50)) * gain).astype(np.float32)
    rec = np.ones((HOPS, B), bool)
    rec[WARM + 2:WARM + 10, 0] = False  # 8-hop burst: fade → comfort noise
    rec[np.arange(HOPS) % 5 == 3, 2] = False
    return audio, rec


def _dtypes(tree):
    return jax.tree.map(lambda x: (tuple(np.shape(x)), np.asarray(x).dtype.name), tree)


@pytest.mark.parametrize("rate", [8000, 32000, 48000])
def test_float_engines_at_rate_match_jax(rate):
    je, jd = JaxEncoder(rate, SMALL), JaxDecoder(rate, SMALL)
    te = EncoderEngine(rate, SMALL, device="cpu")
    td = DecoderEngine(rate, SMALL, device="cpu")
    assert te.hop_samples == jd.hop_samples == rate // 50
    extract = jax.jit(je.soundstream.extract)
    resample = jax.jit(je.resampler.resample)
    audio, rec = _engine_inputs(rate)
    jes, jds = je.init_state(B), jd.init_state(B, seed=1)
    assert _dtypes(state_to_numpy(te.init_state(B))) == _dtypes(jes)
    assert _dtypes(state_to_numpy(td.init_state(B, seed=1))) == _dtypes(jds)
    reached = set()
    for t in range(HOPS):
        pre_e = jax.tree.map(np.asarray, jes)
        pre_d = jax.tree.map(np.asarray, jds)
        jidx, _, jes = je.step(jes, audio[t], NQ)
        ja, jcn, jds = jd.step(jds, jidx, rec[t])
        if t < WARM:
            continue
        # Encoder, from the JAX pre-tick state: resample → features.
        tes = state_from_numpy(pre_e, "cpu")
        x16, _ = resample(pre_e["resampler"], audio[t])
        jf, _ = extract(pre_e["soundstream"], jax_dsp_utils.int16_to_unit(
            jax_dsp_utils.clip_to_int16(x16)))
        jf = np.array(jf)
        tidx, _, tes_new = te.step(tes, torch.from_numpy(audio[t]), NQ)
        t16, _ = te.resampler.resample(tes["resampler"], torch.from_numpy(audio[t]))
        tf, _ = te.soundstream.extract(tes["soundstream"], dsp_utils.int16_to_unit(
            dsp_utils.clip_to_int16(t16)))
        assert np.abs(tf.numpy() - jf).max() <= 1e-5 * np.abs(jf).max(), t
        np.testing.assert_array_equal(
            te.rvq.quantize(torch.from_numpy(jf), NQ).numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tes_new["resampler"].numpy(),
                                      np.asarray(jes["resampler"]))
        # Decoder, from the JAX pre-tick state and the JAX indices.
        ta, tcn, tds = td.step(state_from_numpy(pre_d, "cpu"),
                               torch.from_numpy(np.array(jidx)),
                               torch.from_numpy(rec[t]))
        assert ta.shape == (B, rate // 50)
        assert np.abs(ta.numpy() - np.asarray(ja)).max() <= 1.0, t
        np.testing.assert_array_equal(tcn.numpy(), np.asarray(jcn))
        for k in ("concealment", "fade", "fade_dir"):
            np.testing.assert_array_equal(tds[k].numpy(), np.asarray(jds[k]))
        assert np.abs(tds["resampler"].numpy()
                      - np.asarray(jds["resampler"])).max() <= 1.0
        reached.update(tds["fade"].numpy().tolist())
    assert {0, 640} <= reached  # received hops and full comfort noise
