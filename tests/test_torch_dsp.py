"""The port's DSP, PLC helpers and wire codec vs the JAX package.

Inputs are numpy arrays from a seed, fed to both packages.  Float paths
compare within float32 tolerance over 60 hops; the comfort-noise phase
hash must be bit-exact, and the device wire codec must match the host
codec byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu import packet as jax_packet
from lyra_tpu.codec.comfort_noise import ComfortNoiseGenerator as JaxCng
from lyra_tpu.codec.noise_estimator import NoiseEstimator as JaxNoise
from lyra_tpu.dsp import melspec as jax_melspec
from lyra_tpu.dsp import utils as jax_dsp_utils
from lyra_tpu_torch import packet
from lyra_tpu_torch.codec import comfort_noise
from lyra_tpu_torch.codec.comfort_noise import ComfortNoiseGenerator
from lyra_tpu_torch.codec.feature_estimator import (
    DecayingFeatureEstimator,
    LastFrameFeatureEstimator,
)
from lyra_tpu_torch.codec.noise_estimator import NoiseEstimator
from lyra_tpu_torch.dsp import melspec
from lyra_tpu_torch.dsp import utils as dsp_utils

B, HOPS = 6, 60


def _speechlike(seed, hops=HOPS, b=B):
    """Bursty noise at int16 scale: loud stretches and near-silence, so the
    noise estimator sees both classes."""
    rng = np.random.default_rng(seed)
    gain = np.where(rng.random((hops, b, 1)) < 0.5, 3000.0, 30.0)
    return (rng.normal(0.0, 1.0, (hops, b, 320)) * gain).astype(np.float32)


def test_int16_conversions_match_jax():
    x = np.random.default_rng(0).normal(0, 1.5, (4, 320)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(dsp_utils.unit_to_int16(t).numpy(),
                                  np.asarray(jax_dsp_utils.unit_to_int16(jnp.asarray(x))))
    y = x * 30000
    np.testing.assert_array_equal(
        dsp_utils.clip_to_int16(torch.from_numpy(y)).numpy(),
        np.asarray(jax_dsp_utils.clip_to_int16(jnp.asarray(y))))
    np.testing.assert_array_equal(
        dsp_utils.int16_to_unit(torch.from_numpy(y)).numpy(),
        np.asarray(jax_dsp_utils.int16_to_unit(jnp.asarray(y))))


def test_mel_builders_match_jax():
    cfg = melspec.MelConfig.for_rate(16000)
    np.testing.assert_array_equal(
        melspec.mel_weight_matrix(cfg.num_fft_bins, 16000, 160),
        jax_melspec.mel_weight_matrix(cfg.num_fft_bins, 16000, 160))
    for a, b in zip(melspec.dft_matrices(640, 1024),
                    jax_melspec.dft_matrices(640, 1024)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(melspec.idft_matrices(1024),
                    jax_melspec.idft_matrices(1024)):
        np.testing.assert_array_equal(a, b)


def test_log_mel_matches_jax_over_60_hops():
    cfg = melspec.MelConfig.for_rate(16000)
    ours = melspec.LogMelExtractor(cfg, device="cpu")
    ref = jax_melspec.LogMelExtractor(jax_melspec.MelConfig.for_rate(16000))
    s, rs = ours.init_state(B), ref.init_state(B)
    for hop in _speechlike(1):
        f, s = ours.extract(s, torch.from_numpy(hop))
        rf, rs = ref.extract(rs, jnp.asarray(hop))
        np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_noise_estimator_matches_jax_over_60_hops():
    ours, ref = NoiseEstimator(16000, device="cpu"), JaxNoise(16000)
    s, rs = ours.init_state(B), ref.init_state(B)
    seen = set()
    for hop in _speechlike(2):
        s = ours.receive_hop(s, torch.from_numpy(hop))
        rs = ref.receive_hop(rs, jnp.asarray(hop))
        np.testing.assert_array_equal(s["is_noise"].numpy(),
                                      np.asarray(rs["is_noise"]))
        np.testing.assert_array_equal(s["hops_received"].numpy(),
                                      np.asarray(rs["hops_received"]))
        for k in ("noise_estimate", "smoothed", "squared_smoothed"):
            np.testing.assert_allclose(s[k].numpy(), np.asarray(rs[k]),
                                       rtol=1e-4, atol=1e-4)
        # bound = 0.9·sqrt(max(0, sq − sm²)·ln 160): the f32 cancellation
        # residue (~1e-7 of features ~1) under the sqrt reaches ~7e-4 in
        # both packages, in different orders.
        np.testing.assert_allclose(s["noise_bound"].numpy(),
                                   np.asarray(rs["noise_bound"]),
                                   rtol=1e-4, atol=2e-3)
        seen.update(s["is_noise"].numpy().tolist())
    assert seen == {True, False}  # both branches ran


def test_cng_phase_hash_is_bit_exact():
    ctr = np.array([0, 1, 0x9E3779B9, 0xFFFFFFFF, 0x80000000, 12345],
                   np.uint32)
    got = comfort_noise.random_phases(
        torch.from_numpy(ctr.astype(np.int64)), 512).numpy()
    ref = np.asarray(JaxCng._random_phases(jnp.asarray(ctr), 512))
    np.testing.assert_array_equal(got, ref)
    # Counter lineage: init (with wraparound) and per-hop advance.
    ours, jref = ComfortNoiseGenerator(16000, device="cpu"), JaxCng(16000)
    for seed in (0, 7, 0xFFFFFFF0):
        np.testing.assert_array_equal(
            ours.init_state(4096, seed=seed)["ctr"].numpy().astype(np.uint32),
            np.asarray(jref.init_state(4096, seed=seed)["ctr"]))


def test_cng_hops_match_jax_over_60_hops():
    ours, ref = ComfortNoiseGenerator(16000, device="cpu"), JaxCng(16000)
    s, rs = ours.init_state(B, seed=3), ref.init_state(B, seed=3)
    feats = np.random.default_rng(4).uniform(0.7, 1.1, (B, 160)).astype(
        np.float32)
    for _ in range(HOPS):
        hop, s = ours.generate_hop(s, torch.from_numpy(feats))
        rhop, rs = ref.generate_hop(rs, jnp.asarray(feats))
        r = np.asarray(rhop)
        np.testing.assert_allclose(hop.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
        np.testing.assert_array_equal(s["ctr"].numpy().astype(np.uint32),
                                      np.asarray(rs["ctr"]))


def test_feature_estimators():
    st = torch.zeros(2, 64)
    f = torch.ones(2, 64)
    mask = torch.tensor([True, False])
    last = LastFrameFeatureEstimator(device="cpu").update(st, f, mask)
    assert torch.equal(last[0], f[0]) and torch.equal(last[1], st[1])
    dec = DecayingFeatureEstimator(0.5, device="cpu")
    s = dec.update(f, f, torch.tensor([False, False]))
    assert torch.allclose(s, 0.5 * f)


@pytest.mark.parametrize("num_bits", [64, 120, 184])
def test_wire_codec_matches_host_codec(num_bits):
    n = num_bits // 4
    idx = np.random.default_rng(num_bits).integers(0, 16, (9, 46)).astype(
        np.int32)
    wire = packet.pack_wire_device(torch.from_numpy(idx), num_bits)
    assert wire.dtype == torch.uint8
    np.testing.assert_array_equal(
        wire.numpy(), jax_packet.pack_indices_batch_np(idx, num_bits))
    np.testing.assert_array_equal(
        packet.unpack_wire_device(wire, num_bits).numpy(), idx[:, :n])
    # Out-of-range values wrap to a nibble, as in the JAX device codec.
    bad = idx.copy()
    bad[0, 0], bad[1, 1] = -1, 17
    np.testing.assert_array_equal(
        packet.pack_wire_device(torch.from_numpy(bad), num_bits).numpy(),
        np.asarray(jax_packet.pack_wire_device(jnp.asarray(bad), num_bits)))


def test_mixed_wire_codec_matches_jax():
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 16, (6, 46)).astype(np.int32)
    nq = np.array([16, 30, 46, 16, 46, 30], np.int32)
    got = packet.pack_wire_device_mixed(torch.from_numpy(idx),
                                        torch.from_numpy(nq), 184)
    ref = np.asarray(jax_packet.pack_wire_device_mixed(
        jnp.asarray(idx), jnp.asarray(nq), 184))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = packet.unpack_wire_device_mixed(got, torch.from_numpy(nq))
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_packet.unpack_wire_device_mixed(jnp.asarray(ref), jnp.asarray(nq))))
