"""Single-stream LyraDecoder facade with the reference API surface — port
of lyra_tpu/codec/decoder.py.

API parity target: `LyraDecoder::Create / SetEncodedPacket / DecodeSamples /
is_comfort_noise` plus the 6-state PLC/fade machine at *sample* granularity
(reference: lyra/lyra_decoder.{h,cc}).  Use this class for drop-in,
arbitrary-request-size decoding (CLIs, tests, interactive apps); use
`codec.engine.DecoderEngine` when serving many streams in hop lockstep.

Structure: the learned models run as batch-of-1 hop functions on the
device — LyraGAN's `decode_hop`, comfort noise's `generate_hop`, the noise
estimator's `receive_hop` and the RVQ `decode` — each one CUDA-graph replay
on the card (utils/capture.py, the counterpart of the JAX facade's four
`jax.jit`s), eager on the CPU.  Each hop's result is copied to the host
right after its replay.  The queue/cursor protocol of the reference's
GenerativeModel base class (reference:
lyra/generative_model_interface.h:45-134), the PLC sample accounting, the
float64 cos² crossfade, the feature estimator and the pull-resampler live
in host code, as in the JAX facade — dynamic per-request control flow is
exactly what should not be captured.

The four hop functions share one graph cache: the GAN, comfort-noise and
noise-estimator state trees have different signatures, so each keeps its
own pair of static trees, and each call feeds its function the tree the
previous call returned.  RVQ decode has no state and runs over an empty
tree.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.comfort_noise import ComfortNoiseGenerator
from lyra_tpu_torch.codec.engine import (
    CONCEALMENT_SAMPLES,
    FADE_FROM_CNG,
    FADE_SAMPLES,
    FADE_TO_CNG,
    INTERNAL_HOP,
)
from lyra_tpu_torch.codec.feature_estimator import ZeroFeatureEstimator
from lyra_tpu_torch.codec.noise_estimator import NoiseEstimator
from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.dsp.buffered_resampler import BufferedResampler
from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer
from lyra_tpu_torch.models.streaming import LyraGanModel
from lyra_tpu_torch.utils.capture import GraphCache, replay
from lyra_tpu_torch.utils.device import resolve


class HopGenerator:
    """Feature FIFO + per-hop sample cursor around a hop function.

    Host-side mirror of the reference's GenerativeModel protocol
    (reference: lyra/generative_model_interface.h:45-134): features are
    queued by `add_features`, the expensive hop computation runs lazily at
    the first sample of each hop, and `generate_samples` serves slices that
    never straddle hop boundaries.
    """

    def __init__(self, hop_fn: Callable, num_features: int,
                 hop_samples: int = INTERNAL_HOP):
        self._hop_fn = hop_fn  # features [F] -> [hop] int16-scale np array
        self._num_features = num_features
        self._hop_samples = hop_samples
        self._queue: deque = deque()
        self._next_sample = 0
        self._current_hop: Optional[np.ndarray] = None

    def add_features(self, features: np.ndarray) -> bool:
        features = np.asarray(features, np.float32)
        if features.shape != (self._num_features,):
            return False
        self._queue.append(features)
        return True

    def num_samples_available(self) -> int:
        return len(self._queue) * self._hop_samples - self._next_sample

    def generate_samples(self, num_samples: int) -> Optional[np.ndarray]:
        if num_samples < 0:
            return None
        if num_samples == 0:
            return np.zeros(0, np.int16)
        if self.num_samples_available() == 0:
            return None
        # Reject before running the hop: _hop_fn advances the streaming
        # conv state, so a rejected oversized request must not leave that
        # state one hop ahead of the feature queue (reference validates
        # first too, generative_model_interface.h:84-89).
        remaining = self._hop_samples - self._next_sample
        if num_samples > remaining:
            return None
        if self._next_sample == 0:
            self._current_hop = self._hop_fn(self._queue[0])
        out = self._current_hop[self._next_sample:self._next_sample + num_samples]
        self._next_sample += num_samples
        if self._next_sample == self._hop_samples:
            self._next_sample = 0
            self._queue.popleft()
        return np.asarray(out, np.int16)


def _host(x) -> np.ndarray:
    """A hop function's result as a host array (one copy from the card)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class LyraDecoder:
    """Reference-parity streaming decoder for one stream."""

    def __init__(self, sample_rate_hz: int, num_channels: int = 1,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 mode: str = "float", seed: int = 0, *, device=None):
        config.check_params_supported(sample_rate_hz, num_channels, model_path)
        self._sample_rate_hz = sample_rate_hz
        self._num_channels = num_channels
        self._device = dev = resolve(device)
        self._graphs = GraphCache(dev) if dev.type == "cuda" else None

        gan = LyraGanModel(model_path, mode=mode, device=dev)
        self._gan = gan
        self._gan_state = gan.init_state(1)

        cng = ComfortNoiseGenerator(config.INTERNAL_SAMPLE_RATE, device=dev)
        self._cng = cng
        self._cng_state = cng.init_state(1, seed=seed)

        noise = NoiseEstimator(config.INTERNAL_SAMPLE_RATE, device=dev)
        self._noise = noise
        self._noise_state = noise.init_state(1)
        self._noise_buffer = np.zeros(0, np.float32)

        self._rvq = ResidualVectorQuantizer.from_model_path(model_path, dev)
        # The estimator's inputs and outputs live on the host: its state
        # does too.
        self._estimator = ZeroFeatureEstimator(device="cpu")
        self._est_state = self._estimator.init_state(1)

        self._resampler = BufferedResampler(
            config.INTERNAL_SAMPLE_RATE, sample_rate_hz)

        self._model = HopGenerator(self._run_gan_hop, config.NUM_FEATURES)
        self._comfort = HopGenerator(self._run_cng_hop, config.NUM_MEL_BINS)

        self._concealment = 0  # samples; negative = finishing a fake packet
        self._fade = 0  # samples in [0, FADE_SAMPLES]
        self._fade_dir = FADE_FROM_CNG

    # -- hop functions (batch of 1): one replay each on the card --------------
    def _run(self, fn: Callable, key: str, state, *inputs):
        return replay(self._graphs, self._device, fn, key, state, *inputs)

    def _gan_hop(self, state, features):
        unit, state = self._gan.decode_hop(state, features)
        return dsp_utils.unit_to_int16(unit[0]), state

    def _cng_hop(self, state, features):
        hop, state = self._cng.generate_hop(state, features)
        return dsp_utils.clip_to_int16(hop[0]), state

    def _noise_hop(self, state, samples):
        return (self._noise.receive_hop(state, samples),)

    def _rvq_hop(self, state, indices):
        return self._rvq.decode(indices), state

    def _run_gan_hop(self, features: np.ndarray) -> np.ndarray:
        hop, self._gan_state = self._run(self._gan_hop, "gan", self._gan_state,
                                         features[None])
        return _host(hop)

    def _run_cng_hop(self, features: np.ndarray) -> np.ndarray:
        hop, self._cng_state = self._run(self._cng_hop, "cng", self._cng_state,
                                         features[None])
        return _host(hop)

    def _rvq_decode(self, indices: np.ndarray) -> np.ndarray:
        """[1, num_stages] int32 stage indices → [1, F] features (host)."""
        features, _ = self._run(self._rvq_hop, "rvq", {}, indices)
        return _host(features)

    # -- public API ------------------------------------------------------------
    def set_encoded_packet(self, encoded: bytes) -> bool:
        """Unpack a wire packet, dequantize, and queue its features
        (reference: lyra/lyra_decoder.cc:172-209)."""
        try:
            indices = packet.unpack_indices(encoded)  # rejects bad sizes
        except ValueError:
            return False

        # Finish playing out any fake (concealment / comfort-noise) packet
        # before this one's features reach the model.
        if self._concealment == CONCEALMENT_SAMPLES:
            self._concealment = -self._comfort.num_samples_available()
        elif self._concealment > 0:
            self._concealment = -self._model.num_samples_available()

        padded = np.full(self._rvq.num_stages, -1, np.int32)
        padded[: indices.size] = indices
        features = np.asarray(self._rvq_decode(padded[None]))[0]
        if not self._model.add_features(features):
            return False
        self._est_state = self._estimator.update(
            self._est_state, torch.from_numpy(features[None]),
            torch.tensor([True]))
        return True

    def decode_samples(self, num_samples: int) -> Optional[np.ndarray]:
        return self._resampler.filter_and_buffer(
            self._decode_samples_internal, num_samples)

    @property
    def sample_rate_hz(self) -> int:
        return self._sample_rate_hz

    @property
    def num_channels(self) -> int:
        return self._num_channels

    @property
    def frame_rate(self) -> int:
        return config.FRAME_RATE

    def is_comfort_noise(self) -> bool:
        return self._fade == FADE_SAMPLES

    # -- PLC core (reference: lyra/lyra_decoder.cc:228-315) --------------------
    def _num_samples_to_generate(self, num_requested: int, generated: int) -> int:
        if self._concealment < 0:
            remaining = -self._concealment
        elif self._concealment < CONCEALMENT_SAMPLES:
            remaining = self._model.num_samples_available() % INTERNAL_HOP
        else:
            remaining = self._comfort.num_samples_available()
        if remaining == 0:
            remaining = INTERNAL_HOP
        return min(num_requested - generated, remaining)

    def _decode_samples_internal(self, num_samples: int) -> Optional[np.ndarray]:
        result = np.empty(num_samples, np.int16)
        generated = 0
        while generated < num_samples:
            n = self._num_samples_to_generate(num_samples, generated)
            is_packet_received = (
                self._model.num_samples_available() > 0 and self._concealment == 0)

            if is_packet_received:
                self._fade_dir = FADE_FROM_CNG
            elif self._concealment == CONCEALMENT_SAMPLES:
                self._fade_dir = FADE_TO_CNG
            else:
                self._concealment += n

            cng_n = model_n = n
            next_fade = self._fade + self._fade_dir * n
            if self._fade_dir == FADE_TO_CNG and self._fade == FADE_SAMPLES:
                next_fade, model_n = FADE_SAMPLES, 0
            elif self._fade_dir == FADE_FROM_CNG and self._fade == 0:
                next_fade, cng_n = 0, 0

            audio = self._run_generative_model(model_n)
            if audio is None:
                return None
            comfort = self._run_comfort_noise(cng_n)
            if comfort is None:
                return None

            segment = self._overlap(audio, comfort)
            result[generated:generated + n] = segment
            generated += n
            self._fade = next_fade

            if is_packet_received:
                self._noise_receive_samples(audio)
        return result

    def _run_generative_model(self, num_samples: int) -> Optional[np.ndarray]:
        if num_samples > 0 and self._model.num_samples_available() == 0:
            est = _host(self._estimator.estimate(self._est_state))[0]
            if not self._model.add_features(est):
                return None
        return self._model.generate_samples(num_samples)

    def _run_comfort_noise(self, num_samples: int) -> Optional[np.ndarray]:
        if num_samples > 0 and self._comfort.num_samples_available() == 0:
            noise = _host(self._noise.noise_estimate(self._noise_state))[0]
            if not self._comfort.add_features(noise):
                return None
        return self._comfort.generate_samples(num_samples)

    def _overlap(self, audio: np.ndarray, comfort: np.ndarray) -> np.ndarray:
        """cos^2 crossfade (reference: lyra/lyra_decoder.cc:342-373)."""
        if comfort.size == 0:
            return audio
        if audio.size == 0:
            return comfort
        i = np.arange(audio.size, dtype=np.float64)
        progress = self._fade + self._fade_dir * i
        w = (1.0 + np.cos(progress * np.pi / FADE_SAMPLES)) / 2.0
        return (audio * w + comfort * (1.0 - w)).astype(np.int16)

    def _noise_receive_samples(self, samples: np.ndarray):
        """Buffer arbitrary sample counts into whole hops for the batched
        noise estimator (reference NoiseEstimator::ReceiveSamples buffers
        the same way, lyra/noise_estimator.cc:142-173)."""
        buf = np.concatenate([self._noise_buffer, np.asarray(samples, np.float32)])
        while buf.size >= INTERNAL_HOP:
            hop, buf = buf[:INTERNAL_HOP], buf[INTERNAL_HOP:]
            (self._noise_state,) = self._run(self._noise_hop, "noise",
                                             self._noise_state, hop[None])
        self._noise_buffer = buf
