"""The port's single-stream codec (codec/encoder.py, codec/decoder.py,
dsp/buffered_resampler.py, testing/fakes.py) vs the JAX package's, on the
small synthetic fixture from numpy-seeded inputs, on the CPU.

  * LyraEncoder at 16 and 48 kHz, DTX off and on, 3200/6000/9200 bps
    (set_bitrate mid-stream): packets identical; a packet may differ only
    where the JAX features show an RVQ near-tie at the first differing
    stage.
  * LyraDecoder on the same packets with a loss burst (concealment, fade,
    comfort noise), Gilbert losses and randomized request sizes: audio
    within 1 int16 LSB, is_comfort_noise equal after every request.
  * The PLC state machine of tests/test_decoder_plc.py on the port's
    make_fake_decoder, and one random loss and request schedule through
    both packages' fakes: identical int16.
  * BufferedResampler at every rate pair, and convert_num_samples over a
    grid: identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu import packet as jax_packet
from lyra_tpu.codec.decoder import LyraDecoder as JaxDecoder
from lyra_tpu.codec.encoder import LyraEncoder as JaxEncoder
from lyra_tpu.dsp import utils as jax_dsp_utils
from lyra_tpu.dsp.buffered_resampler import BufferedResampler as JaxBuffered
from lyra_tpu.testing import fakes as jax_fakes
from lyra_tpu_torch import config
from lyra_tpu_torch.codec import LyraDecoder, LyraEncoder
from lyra_tpu_torch.codec.engine import (
    CONCEALMENT_SAMPLES,
    FADE_SAMPLES,
    INTERNAL_HOP,
)
from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.dsp.buffered_resampler import BufferedResampler
from lyra_tpu_torch.testing import ConstantHopFn, make_fake_decoder
from lyra_tpu_torch.tools.packet_loss import GilbertModel

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
HOPS = 24
BITRATES = (3200, 6000, 9200)
MODEL_VALUE, CNG_VALUE = 1000, 4000
PACKET = bytes(config.packet_size(64))  # all-zero 3.2 kbps packet


def _speech(seed, rate, hops=HOPS):
    """int16 noise, loud and near-silent in turns of 4 hops, so DTX both
    sends and suppresses."""
    hop = config.num_samples_per_hop(rate)
    rng = np.random.default_rng(seed)
    gain = np.where((np.arange(hops) // 4) % 2 == 0, 5000.0, 2.0)
    return (rng.normal(0.0, 1.0, (hops, hop)) * gain[:, None]).astype(np.int16)


def _jax_features(engine, state, audio):
    """The JAX encoder engine's SoundStream features for one hop from its
    pre-hop state (resampled and clipped to 16 kHz first, as its step)."""
    x = jnp.asarray(audio, jnp.float32)[None]
    if engine.resampler is not None:
        x, _ = engine.resampler.resample(state["resampler"], x)
        x = jax_dsp_utils.clip_to_int16(x).astype(jnp.float32)
    feats, _ = engine.soundstream.extract(state["soundstream"],
                                          jax_dsp_utils.int16_to_unit(x))
    return np.asarray(feats[0], np.float64)


def _assert_near_tie(got: bytes, want: bytes, feats, codebooks):
    """Two packets of one size that differ must first differ at a stage
    whose two codewords score within float32 noise of each other."""
    assert len(got) == len(want) > 0, (got, want)
    a, b = jax_packet.unpack_indices(got), jax_packet.unpack_indices(want)
    s = int(np.flatnonzero(a != b)[0])
    cbs = np.asarray(codebooks, np.float64)
    resid = feats - sum((cbs[j, b[j]] for j in range(s)),
                        np.zeros(cbs.shape[-1]))
    scores = (cbs[s] ** 2).sum(-1) - 2.0 * cbs[s] @ resid
    gap = abs(scores[a[s]] - scores[b[s]])
    assert gap <= 1e-4 * max(abs(scores).max(), 1.0), (s, gap)


@pytest.mark.parametrize("rate", [16000, 48000])
@pytest.mark.parametrize("dtx", [False, True])
def test_encoder_matches_jax(rate, dtx):
    je = JaxEncoder(rate, 1, BITRATES[0], enable_dtx=dtx, model_path=SMALL)
    te = LyraEncoder(rate, 1, BITRATES[0], enable_dtx=dtx, model_path=SMALL,
                     device="cpu")
    audio = _speech(rate, rate)
    near, empty = 0, 0
    for t, hop in enumerate(audio):
        if t % 8 == 0:
            bitrate = BITRATES[t // 8]
            assert je.set_bitrate(bitrate) and te.set_bitrate(bitrate)
            assert te.bitrate == je.bitrate == bitrate
        pre = je._state
        want, got = je.encode(hop), te.encode(hop)
        empty += want == b""
        if got != want:
            near += 1
            _assert_near_tie(got, want, _jax_features(je._engine, pre, hop),
                             je._engine.rvq.codebooks)
        if want:
            assert len(got) == config.bitrate_to_packet_size(te.bitrate)
    assert near <= 1, near
    assert (empty > 0) == dtx, empty
    assert te.encode(audio[0][:-1]) is None  # a wrong shape
    assert not te.set_bitrate(1234)
    assert (te.sample_rate_hz, te.num_channels, te.frame_rate) == \
        (je.sample_rate_hz, je.num_channels, je.frame_rate)


def _schedule(seed, rate, hops):
    """Per hop: received?, and the request sizes that serve the hop (the
    CLI's randomized requests, from a seeded rng)."""
    hop = config.num_samples_per_hop(rate)
    rng = np.random.RandomState(seed)
    gilbert = GilbertModel.create(0.1, 2.0)
    received = np.array([gilbert.is_packet_received() for _ in range(hops)])
    received[8:18] = False  # concealment, the fade, comfort noise
    requests = []
    for _ in range(hops):
        sizes, done = [], 0
        while done < hop:
            n = min(int(rng.randint(1, hop + 1)), hop - done)
            sizes.append(n)
            done += n
        requests.append(sizes)
    return received, requests


@pytest.mark.parametrize("rate", [16000, 48000])
def test_decoder_matches_jax(rate):
    enc = LyraEncoder(rate, 1, 6000, model_path=SMALL, device="cpu")
    packets = [enc.encode(h) for h in _speech(7, rate, 30)]
    received, requests = _schedule(rate, rate, len(packets))
    jd = JaxDecoder(rate, 1, SMALL, seed=3)
    td = LyraDecoder(rate, 1, SMALL, seed=3, device="cpu")
    states = set()
    for pkt, rec, sizes in zip(packets, received, requests):
        if rec:
            assert jd.set_encoded_packet(pkt) and td.set_encoded_packet(pkt)
        for n in sizes:
            want, got = jd.decode_samples(n), td.decode_samples(n)
            assert got.dtype == np.int16 and got.shape == (n,)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            assert td.is_comfort_noise() == jd.is_comfort_noise()
            states.add((td._fade, td._concealment))
    assert not td.set_encoded_packet(b"\x00" * 3)
    fades = {f for f, _ in states}
    assert {0, FADE_SAMPLES} <= fades and fades - {0, FADE_SAMPLES}, fades
    assert max(c for _, c in states) == CONCEALMENT_SAMPLES


# -- the PLC state machine on the port's fakes (tests/test_decoder_plc.py) ----
class _ModelHop:
    """Real packets decode to MODEL_VALUE, estimated (zero) features to
    MODEL_VALUE + 1, so the tests can tell them apart."""

    def __init__(self):
        self.estimated = 0

    def __call__(self, features):
        if features[0] == 0.0:
            self.estimated += 1
        v = MODEL_VALUE if features[0] == 7.0 else MODEL_VALUE + 1
        return np.full(INTERNAL_HOP, v, np.int16)


def _fake(rate=16000):
    model = _ModelHop()
    d = make_fake_decoder(rate, model, ConstantHopFn(CNG_VALUE))
    return d, model


def _fade(start, direction, n=INTERNAL_HOP, model=MODEL_VALUE):
    i = np.arange(n, dtype=np.float64)
    w = (1.0 + np.cos((start + direction * i) * np.pi / FADE_SAMPLES)) / 2.0
    return (model * w + CNG_VALUE * (1.0 - w)).astype(np.int16)


def _receives(d):
    return d._noise.receive_calls


def _plc_normal():
    d, _ = _fake()
    assert d.set_encoded_packet(PACKET)
    np.testing.assert_array_equal(d.decode_samples(INTERNAL_HOP),
                                  np.full(INTERNAL_HOP, MODEL_VALUE))
    assert _receives(d) == 1 and not d.is_comfort_noise()


def _plc_bad_sizes():
    d, _ = _fake()
    assert not d.set_encoded_packet(b"\x00" * 3)
    assert not d.set_encoded_packet(b"")


def _plc_conceal_fade_cng():
    d, model = _fake()
    conceal, fade = CONCEALMENT_SAMPLES // INTERNAL_HOP, FADE_SAMPLES // INTERNAL_HOP
    for _ in range(conceal):
        np.testing.assert_array_equal(d.decode_samples(INTERNAL_HOP),
                                      np.full(INTERNAL_HOP, MODEL_VALUE + 1))
        assert not d.is_comfort_noise()
    assert model.estimated == conceal
    for h in range(fade):
        np.testing.assert_array_equal(
            d.decode_samples(INTERNAL_HOP),
            _fade(h * INTERNAL_HOP, +1, model=MODEL_VALUE + 1))
    assert d.is_comfort_noise()
    added = model.estimated
    np.testing.assert_array_equal(d.decode_samples(INTERNAL_HOP),
                                  np.full(INTERNAL_HOP, CNG_VALUE))
    assert model.estimated == added and d.is_comfort_noise()


def _plc_fade_back():
    d, _ = _fake()
    for _ in range((CONCEALMENT_SAMPLES + FADE_SAMPLES) // INTERNAL_HOP + 2):
        d.decode_samples(INTERNAL_HOP)
    assert d.is_comfort_noise()
    for h in range(FADE_SAMPLES // INTERNAL_HOP):
        assert d.set_encoded_packet(PACKET)
        np.testing.assert_array_equal(
            d.decode_samples(INTERNAL_HOP),
            _fade(FADE_SAMPLES - h * INTERNAL_HOP, -1))
    assert not d.is_comfort_noise()
    before = _receives(d)
    assert d.set_encoded_packet(PACKET)
    np.testing.assert_array_equal(d.decode_samples(INTERNAL_HOP),
                                  np.full(INTERNAL_HOP, MODEL_VALUE))
    assert _receives(d) == before + 1


def _plc_many_hops_one_request():
    d, _ = _fake()
    for _ in range(4):
        assert d.set_encoded_packet(PACKET)
    np.testing.assert_array_equal(d.decode_samples(4 * INTERNAL_HOP),
                                  np.full(4 * INTERNAL_HOP, MODEL_VALUE))
    assert _receives(d) == 4 and not d.is_comfort_noise()


def _plc_subhop_requests():
    (da, _), (db, _) = _fake(), _fake()
    for d in (da, db):
        d.set_encoded_packet(PACKET)
        d.set_encoded_packet(PACKET)
    a = np.concatenate([da.decode_samples(INTERNAL_HOP) for _ in range(8)])
    chunks, got, k, sizes = [], 0, 0, [37, 100, 283, 320, 1, 479]
    while got < 8 * INTERNAL_HOP:
        n = min(sizes[k % len(sizes)], 8 * INTERNAL_HOP - got)
        k += 1
        chunks.append(db.decode_samples(n))
        got += n
    np.testing.assert_array_equal(a, np.concatenate(chunks))


def _plc_finish_fake_packet():
    d, _ = _fake()
    np.testing.assert_array_equal(d.decode_samples(100),
                                  np.full(100, MODEL_VALUE + 1))
    assert d.set_encoded_packet(PACKET)
    assert d._concealment == -(INTERNAL_HOP - 100)
    out = d.decode_samples(INTERNAL_HOP)
    np.testing.assert_array_equal(out[:INTERNAL_HOP - 100],
                                  np.full(INTERNAL_HOP - 100, MODEL_VALUE + 1))
    np.testing.assert_array_equal(out[INTERNAL_HOP - 100:],
                                  np.full(100, MODEL_VALUE))
    assert d._concealment == 0


def _plc_resampled(rate, factor):
    d, _ = _fake(rate)
    d.set_encoded_packet(PACKET)
    hop = config.num_samples_per_hop(rate)
    out = d.decode_samples(hop)
    assert out.shape == (hop,)
    assert np.all(np.abs(out[factor * 40:].astype(int) - MODEL_VALUE) <= 1)


@pytest.mark.parametrize("case", [
    _plc_normal, _plc_bad_sizes, _plc_conceal_fade_cng, _plc_fade_back,
    _plc_many_hops_one_request, _plc_subhop_requests, _plc_finish_fake_packet,
    lambda: _plc_resampled(32000, 2), lambda: _plc_resampled(48000, 3),
], ids=["normal", "bad_sizes", "conceal_fade_cng", "fade_back",
        "many_hops_one_request", "subhop_requests", "finish_fake_packet",
        "resampled_32k", "resampled_48k"])
def test_plc_state_machine_on_fakes(case):
    case()


@pytest.mark.parametrize("rate", [16000, 48000])
def test_fakes_match_jax_fakes_on_a_random_schedule(rate):
    received, requests = _schedule(11, rate, 60)
    ours = make_fake_decoder(rate)
    ref = jax_fakes.make_fake_decoder(rate)
    for rec, sizes in zip(received, requests):
        if rec:
            assert ours.set_encoded_packet(PACKET) == \
                ref.set_encoded_packet(PACKET)
        for n in sizes:
            np.testing.assert_array_equal(ours.decode_samples(n),
                                          ref.decode_samples(n))
            assert ours.is_comfort_noise() == ref.is_comfort_noise()
    assert ours._model._hop_fn.calls == ref._model._hop_fn.calls
    assert ours._comfort._hop_fn.calls == ref._comfort._hop_fn.calls
    assert ours._noise.receive_calls == ref._noise.receive_calls


RATE_PAIRS = [(a, b) for a in config.SUPPORTED_SAMPLE_RATES
              for b in config.SUPPORTED_SAMPLE_RATES
              if max(a, b) % min(a, b) == 0]


@pytest.mark.parametrize("internal,external", RATE_PAIRS)
def test_buffered_resampler_matches_jax(internal, external):
    ours = BufferedResampler(internal, external)
    ref = JaxBuffered(internal, external)
    source = np.random.default_rng(internal + external).normal(
        0.0, 6000.0, 100_000).clip(-32768, 32767).astype(np.int16)
    pos = {"ours": 0, "ref": 0}

    def generator(who):
        def gen(n):
            out = source[pos[who]:pos[who] + n]
            pos[who] += n
            return out
        return gen

    rng = np.random.default_rng(5)
    for _ in range(40):
        n = int(rng.integers(0, 400))
        assert ours.get_internal_num_samples_to_generate(n) == \
            ref.get_internal_num_samples_to_generate(n)
        np.testing.assert_array_equal(ours.filter_and_buffer(generator("ours"), n),
                                      ref.filter_and_buffer(generator("ref"), n))
    # A failing generator leaves the leftovers untouched in both.
    assert ours.filter_and_buffer(lambda n: None, 1000) is None
    assert ref.filter_and_buffer(lambda n: None, 1000) is None
    np.testing.assert_array_equal(ours._leftover, ref._leftover)
    with pytest.raises(ValueError):
        BufferedResampler(16000, 44100)


def test_convert_num_samples_and_spectral_distance_match_jax():
    for n in range(0, 2000, 7):
        for a in config.SUPPORTED_SAMPLE_RATES + (44100, 11025):
            for b in config.SUPPORTED_SAMPLE_RATES:
                assert dsp_utils.convert_num_samples(n, a, b) == \
                    jax_dsp_utils.convert_num_samples(n, a, b), (n, a, b)
    rng = np.random.default_rng(0)
    a, b = rng.normal(0, 2, (3, 160)), rng.normal(0, 2, (3, 160))
    want = jax_dsp_utils.log_spectral_distance(a, b)
    np.testing.assert_array_equal(dsp_utils.log_spectral_distance(a, b), want)
    got = dsp_utils.log_spectral_distance(torch.tensor(a, dtype=torch.float32),
                                          torch.tensor(b, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_facades_default_to_the_card(monkeypatch, tmp_path):
    """Without a CUDA device, a facade built with no `device=`, or a CLI's
    `main` called without one, raises the utils/device.py error instead
    of running on the CPU."""
    from lyra_tpu_torch.tools import encoder_main
    from lyra_tpu_torch.utils import wav

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        LyraEncoder(16000, model_path=SMALL)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        LyraDecoder(16000, model_path=SMALL)
    src = str(tmp_path / "a.wav")
    wav.write_wav_int16(src, np.zeros(640, np.int16), 16000)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        encoder_main.main([f"--input_path={src}", f"--output_dir={tmp_path}",
                           f"--model_path={SMALL}"])
