"""Fake codec components for deterministic tests (no model weights) — the
port's copy of lyra_tpu/testing/fakes.py.

Mirrors the role of the reference's lyra/testing/ mocks: constant-valued
generators that still exercise the real queue/cursor and PLC control logic.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.codec.decoder import HopGenerator, LyraDecoder
from lyra_tpu_torch.codec.engine import FADE_FROM_CNG, INTERNAL_HOP
from lyra_tpu_torch.codec.feature_estimator import ZeroFeatureEstimator
from lyra_tpu_torch.dsp.buffered_resampler import BufferedResampler


class ConstantHopFn:
    """Hop function returning a constant value; counts invocations."""

    def __init__(self, value: int, hop: int = INTERNAL_HOP):
        self.value = value
        self.hop = hop
        self.calls = 0

    def __call__(self, features: np.ndarray) -> np.ndarray:
        self.calls += 1
        return np.full(self.hop, self.value, np.int16)


class FakeRvq:
    """Decode returns a constant feature vector; tracks call count."""

    num_stages = config.MAX_NUM_QUANTIZERS

    def __init__(self, feature_value: float = 7.0):
        self.feature_value = feature_value
        self.calls = 0

    def decode(self, indices):
        self.calls += 1
        return np.full((1, config.NUM_FEATURES), self.feature_value, np.float32)


class FakeNoiseEstimator:
    """noise_estimate returns a constant log-mel vector; counts receives."""

    def __init__(self, value: float = 0.5):
        self.value = value
        self.receive_calls = 0

    def noise_estimate(self, state):
        return np.full((1, config.NUM_MEL_BINS), self.value, np.float32)


def make_fake_decoder(
    sample_rate_hz: int = 16000,
    model_hop_fn: Optional[Callable] = None,
    cng_hop_fn: Optional[Callable] = None,
) -> LyraDecoder:
    """LyraDecoder wired with fakes — the analog of the reference's
    LyraDecoderPeer construction with mocks (lyra/lyra_decoder_test.cc:52-91)."""
    d = object.__new__(LyraDecoder)
    d._sample_rate_hz = sample_rate_hz
    d._num_channels = 1
    d._model = HopGenerator(model_hop_fn or ConstantHopFn(1000),
                            config.NUM_FEATURES)
    d._comfort = HopGenerator(cng_hop_fn or ConstantHopFn(4000),
                              config.NUM_MEL_BINS)
    d._resampler = BufferedResampler(config.INTERNAL_SAMPLE_RATE, sample_rate_hz)
    d._concealment = 0
    d._fade = 0
    d._fade_dir = FADE_FROM_CNG
    d._estimator = ZeroFeatureEstimator(device="cpu")
    d._est_state = d._estimator.init_state(1)
    rvq = FakeRvq()
    d._rvq = rvq
    d._rvq_decode = rvq.decode
    noise = FakeNoiseEstimator()
    d._noise = noise
    d._noise_state = None
    d._noise_buffer = np.zeros(0, np.float32)

    def _receive(samples):
        noise.receive_calls += 1

    d._noise_receive_samples = _receive
    return d
