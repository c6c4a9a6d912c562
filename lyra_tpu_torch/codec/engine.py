"""Batched lockstep codec engines — port of lyra_tpu/codec/engine.py.

One `step()` advances B streams by one 20 ms hop.  EncoderEngine: (DTX
noise gate) → SoundStream features → RVQ stage indices.  DecoderEngine:
RVQ decode → feature estimator → LyraGAN, the 6-state PLC machine, the
decoder-side noise estimator, comfort noise and the cos² crossfade.  Every
per-stream scalar is a `[B]` tensor and every branch a `torch.where` mask,
so streams in different PLC states batch together.

State is an explicit dict tree with the JAX engine's keys and shapes
(utils/state.py converts between the two).  Steps are pure: they return a
new tree and leave the input tree untouched.

`backend="kernel"` (the default) runs the conv stacks through the
conv-stack kernels and the RVQ search through its kernel; on CPU tensors
those wrappers run their plain versions.  `backend="plain"` runs the
executor lowering and the `"fast"` RVQ search — the plain reference on
either device.  The JAX engines' names map onto these (`BACKEND_NAMES`):
`"fused"`, the JAX kernel path, is `"kernel"`, and `"xla"`, the JAX per-op
lowering, is `"plain"`.  The constructors take the JAX engines' parameters
in the JAX order; `device` is keyword-only.

`mode` is "float" or "bf16" (the JAX package's serving mode: the conv
stacks compute in bf16 and the decoder's RVQ decode rounds the codebooks
to bf16).  `sample_rate_hz` is any of `config.SUPPORTED_SAMPLE_RATES`: the
codec runs at 16 kHz and a `"resampler"` state leaf carries the
polyphase filter's history at the stream's rate, as in the JAX engines.

Both engines run on the card unless `device=` names another device; without
a card the default raises (utils/device.py), so CPU callers pass
`device="cpu"`.

Differences from the JAX engines: int8 and fakequant modes, int8 state
storage and fp8 boundaries are not ported and are refused; comfort noise
is always synthesized, so `gate_idle_stages` is accepted and changes no
bit (the JAX engine skips it with a `lax.cond` when no stream needs it —
the masked result is bit-identical, and testing `any()` on the host would
cost a device sync every tick).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from lyra_tpu_torch import config
from lyra_tpu_torch.codec.comfort_noise import ComfortNoiseGenerator
from lyra_tpu_torch.codec.feature_estimator import (
    DecayingFeatureEstimator,
    LastFrameFeatureEstimator,
    ZeroFeatureEstimator,
)
from lyra_tpu_torch.codec.noise_estimator import NoiseEstimator
from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.dsp.resampler import Resampler
from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer
from lyra_tpu_torch.models.streaming import (
    LyraGanModel,
    SoundStreamEncoder,
    mask_tree,
)
from lyra_tpu_torch.tflite.executor import compute_dtype
from lyra_tpu_torch.utils.device import resolve

State = Dict[str, Any]

# PLC timing (reference: lyra/lyra_decoder.cc:42-61): 0.08 s of pure
# concealment, then a 0.04 s cos² fade into comfort noise.
INTERNAL_HOP = config.num_samples_per_hop(config.INTERNAL_SAMPLE_RATE)
CONCEALMENT_SAMPLES = int(0.08 * config.INTERNAL_SAMPLE_RATE)
FADE_SAMPLES = int(0.04 * config.INTERNAL_SAMPLE_RATE)
FADE_TO_CNG = 1
FADE_FROM_CNG = -1

_ESTIMATORS = {
    "zero": ZeroFeatureEstimator,
    "last_frame": LastFrameFeatureEstimator,
    "decaying": DecayingFeatureEstimator,
}
# Every backend name the engines take → the port's backend.
BACKEND_NAMES = {
    "kernel": "kernel",
    "plain": "plain",
    "fused": "kernel",  # the JAX kernel path
    "xla": "plain",  # the JAX per-op lowering
}


def has_model_assets(model_path: str) -> bool:
    """True when `model_path` holds every model file the engines load."""
    return all(os.path.exists(os.path.join(model_path, a))
               for a in config.ASSETS)


def _checked_common(sample_rate_hz: int, model_path: str, backend: str,
                    mode: str, state_compression, boundary_store) -> str:
    """Checks the parameters both engines share; returns the port's
    backend for `backend`."""
    config.check_params_supported(sample_rate_hz, config.NUM_CHANNELS,
                                  model_path)
    if backend not in BACKEND_NAMES:
        raise ValueError(f"backend must be one of {sorted(BACKEND_NAMES)}, "
                         f"got {backend!r}")
    compute_dtype(mode)  # float and bf16; int8 / fakequant raise
    if state_compression is not None:
        raise NotImplementedError(
            "state_compression: int8 state storage is not ported")
    if boundary_store is not None:
        raise NotImplementedError(
            "boundary_store: fp8 boundary storage is not ported")
    return BACKEND_NAMES[backend]


def _resampler(input_rate: int, target_rate: int, device):
    """None at 16 kHz, else the polyphase resampler between the rates."""
    if input_rate == target_rate:
        return None
    return Resampler(input_rate, target_rate, device=device)


def _max_stages(rvq: ResidualVectorQuantizer, max_bitrate):
    if max_bitrate is None:
        return None
    bits = config.bitrate_to_num_quantized_bits(max_bitrate)
    if bits < 0:
        raise ValueError(f"bitrate {max_bitrate} is not supported "
                         f"(choose from {config.SUPPORTED_BITRATES})")
    return rvq.num_bits_to_stages(bits)


def fade_weights(fade_progress: torch.Tensor, fade_direction: torch.Tensor,
                 num_samples: int) -> torch.Tensor:
    """Per-sample cos² crossfade weights [B, num_samples]:
    (1 + cos((fade + dir·i)·π / FADE_SAMPLES)) / 2."""
    i = torch.arange(num_samples, dtype=torch.float32,
                     device=fade_progress.device)[None, :]
    p = (fade_progress.float()[:, None]
         + fade_direction.float()[:, None] * i)
    return (1.0 + torch.cos(p * torch.pi / FADE_SAMPLES)) / 2.0


class DecoderEngine:
    """Batched hop-lockstep Lyra decoder over `[B]` concurrent streams."""

    def __init__(self, sample_rate_hz: int = config.INTERNAL_SAMPLE_RATE,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 mode: str = "float", backend: str = "kernel",
                 feature_estimator: str = "zero",
                 max_bitrate: int | None = None,
                 gate_idle_stages: bool = True,
                 state_compression: str | None = None,
                 boundary_store: str | None = None,
                 emit_dtype: str = "float32", *, device=None):
        backend = _checked_common(sample_rate_hz, model_path, backend, mode,
                                  state_compression, boundary_store)
        if not isinstance(gate_idle_stages, bool):
            raise TypeError(f"gate_idle_stages must be a bool, got "
                            f"{gate_idle_stages!r}")
        if emit_dtype not in ("float32", "int16"):
            raise ValueError(
                f"emit_dtype must be 'float32' or 'int16', got {emit_dtype!r}")
        if feature_estimator not in _ESTIMATORS:
            raise ValueError(
                f"unknown feature_estimator {feature_estimator!r}; "
                f"choose from {sorted(_ESTIMATORS)}")
        self.device = device = resolve(device)
        self.backend = backend
        self.sample_rate_hz = sample_rate_hz
        self.hop_samples = config.num_samples_per_hop(sample_rate_hz)
        self._emit_int16 = emit_dtype == "int16"
        self.gan = LyraGanModel(model_path, backend=backend, mode=mode,
                                device=device)
        self.rvq = ResidualVectorQuantizer.from_model_path(model_path, device)
        self._max_stages = _max_stages(self.rvq, max_bitrate)
        self._decode_dtype = compute_dtype(mode)
        self.resampler = _resampler(config.INTERNAL_SAMPLE_RATE,
                                    sample_rate_hz, device)
        self.cng = ComfortNoiseGenerator(config.INTERNAL_SAMPLE_RATE,
                                         device=device)
        self.noise = NoiseEstimator(config.INTERNAL_SAMPLE_RATE, device=device)
        self.estimator = _ESTIMATORS[feature_estimator](device=device)

    def init_state(self, batch_size: int, seed: int = 0) -> State:
        b, dev = batch_size, self.device
        state = {
            "gan": self.gan.init_state(b),
            "cng": self.cng.init_state(b, seed=seed),
            "noise": self.noise.init_state(b),
            "est": self.estimator.init_state(b),
            "concealment": torch.zeros((b,), dtype=torch.int32, device=dev),
            "fade": torch.zeros((b,), dtype=torch.int32, device=dev),
            "fade_dir": torch.full((b,), FADE_FROM_CNG, dtype=torch.int32,
                                   device=dev),
        }
        if self.resampler is not None:
            state["resampler"] = self.resampler.init_state(b)
        return state

    def reset_rows(self, state: State, mask: torch.Tensor,
                   seed: int = 0) -> State:
        """Re-initialize streams where `mask` is set (stream admission);
        `seed` must match init_state's to keep the per-stream RNG lineage."""
        mask = mask.to(device=self.device, dtype=torch.bool)
        return mask_tree(mask, self.init_state(mask.shape[0], seed=seed), state)

    def step(self, state: State, indices: torch.Tensor,
             received: torch.Tensor):
        """Advance every stream by one 20 ms hop.

        indices:  [B, num_stages] int RVQ stage indices (−1 beyond the
                  stream's bitrate; ignored where not received).
        received: [B] bool — False means lost (or a DTX empty packet).

        Returns (audio [B, hop_samples] at int16 scale — float32, or int16
        with emit_dtype="int16"; is_comfort_noise [B] bool; new_state).
        """
        received = received.to(device=self.device, dtype=torch.bool)
        lossy = self.rvq.decode(indices.to(self.device),
                                dtype=self._decode_dtype,
                                max_stages=self._max_stages)
        est_state = self.estimator.update(state["est"], lossy, received)

        # PLC state update (reference: lyra/lyra_decoder.cc:249-265).
        conceal_sat = state["concealment"] >= CONCEALMENT_SAMPLES
        fade_dir = torch.where(
            received, FADE_FROM_CNG,
            torch.where(conceal_sat, FADE_TO_CNG, state["fade_dir"])
        ).to(torch.int32)
        concealment = torch.where(
            received, 0,
            torch.where(conceal_sat, state["concealment"],
                        state["concealment"] + INTERNAL_HOP)
        ).to(torch.int32)

        # Saturation gates (reference: lyra/lyra_decoder.cc:267-282).
        run_model = ~((fade_dir == FADE_TO_CNG) & (state["fade"] == FADE_SAMPLES))
        run_cng = ~((fade_dir == FADE_FROM_CNG) & (state["fade"] == 0))

        feats = torch.where(received[:, None], lossy,
                            self.estimator.estimate(est_state))
        model_unit, gan_state = self.gan.decode_hop(state["gan"], feats)
        gan_state = mask_tree(run_model, gan_state, state["gan"])
        model_hop = dsp_utils.unit_to_int16(model_unit).float()

        cng_hop, cng_state = self.cng.generate_hop(
            state["cng"], self.noise.noise_estimate(state["noise"]))
        cng_hop = dsp_utils.clip_to_int16(cng_hop).float()
        cng_state = mask_tree(run_cng, cng_state, state["cng"])

        # cos² crossfade (reference: lyra/lyra_decoder.cc:342-373).
        w = fade_weights(state["fade"], fade_dir, INTERNAL_HOP)
        blended = w * model_hop + (1.0 - w) * cng_hop
        both = run_model & run_cng
        audio = torch.where(both[:, None], blended,
                            torch.where(run_model[:, None], model_hop, cng_hop))
        audio = dsp_utils.clip_to_int16(audio).float()

        fade = torch.clamp(state["fade"] + fade_dir * INTERNAL_HOP, 0,
                           FADE_SAMPLES).to(torch.int32)

        # The noise estimator listens to received hops' model output only.
        noise_state = self.noise.receive_hop(state["noise"], model_hop)
        noise_state = mask_tree(received, noise_state, state["noise"])

        new_state = {
            "gan": gan_state,
            "cng": cng_state,
            "noise": noise_state,
            "est": est_state,
            "concealment": concealment,
            "fade": fade,
            "fade_dir": fade_dir,
        }
        if self.resampler is not None:
            audio, new_state["resampler"] = self.resampler.resample(
                state["resampler"], audio)
            audio = dsp_utils.clip_to_int16(audio).float()
        is_comfort_noise = fade == FADE_SAMPLES
        if self._emit_int16:
            audio = audio.to(torch.int16)
        return audio, is_comfort_noise, new_state


class EncoderEngine:
    """Batched hop-lockstep Lyra encoder over `[B]` concurrent streams."""

    def __init__(self, sample_rate_hz: int = config.INTERNAL_SAMPLE_RATE,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 enable_dtx: bool = False, mode: str = "float",
                 backend: str = "kernel", max_bitrate: int | None = None,
                 state_compression: str | None = None,
                 boundary_store: str | None = None, *, device=None):
        backend = _checked_common(sample_rate_hz, model_path, backend, mode,
                                  state_compression, boundary_store)
        self.device = device = resolve(device)
        self.backend = backend
        self.sample_rate_hz = sample_rate_hz
        self.hop_samples = config.num_samples_per_hop(sample_rate_hz)
        self.enable_dtx = enable_dtx
        self.soundstream = SoundStreamEncoder(model_path, backend=backend,
                                              mode=mode, device=device)
        self.rvq = ResidualVectorQuantizer.from_model_path(model_path, device)
        self._rvq_method = "kernel" if backend == "kernel" else "fast"
        self._max_stages = _max_stages(self.rvq, max_bitrate)
        self.noise = (NoiseEstimator(config.INTERNAL_SAMPLE_RATE, device=device)
                      if enable_dtx else None)
        self.resampler = _resampler(sample_rate_hz,
                                    config.INTERNAL_SAMPLE_RATE, device)

    def init_state(self, batch_size: int) -> State:
        state = {"soundstream": self.soundstream.init_state(batch_size)}
        if self.noise is not None:
            state["noise"] = self.noise.init_state(batch_size)
        if self.resampler is not None:
            state["resampler"] = self.resampler.init_state(batch_size)
        return state

    def reset_rows(self, state: State, mask: torch.Tensor) -> State:
        mask = mask.to(device=self.device, dtype=torch.bool)
        return mask_tree(mask, self.init_state(mask.shape[0]), state)

    def step(self, state: State, audio: torch.Tensor, num_quantizers):
        """audio [B, hop_samples] at int16 scale; num_quantizers scalar
        or [B].

        Returns (indices [B, num_stages] int32, −1 beyond each stream's
        bitrate; is_noise [B] bool; new_state).  A DTX noise hop leaves the
        stream's SoundStream state untouched (the host sends an empty
        packet)."""
        new_state = dict(state)
        x = audio.to(device=self.device, dtype=torch.float32)
        if self.resampler is not None:
            x, new_state["resampler"] = self.resampler.resample(
                state["resampler"], x)
            x = dsp_utils.clip_to_int16(x).float()
        if self.noise is not None:
            noise_state = self.noise.receive_hop(state["noise"], x)
            is_noise = self.noise.is_noise(noise_state)
            new_state["noise"] = noise_state
        else:
            is_noise = torch.zeros((x.shape[0],), dtype=torch.bool,
                                   device=self.device)
        feats, ss_state = self.soundstream.extract(
            state["soundstream"], dsp_utils.int16_to_unit(x))
        new_state["soundstream"] = mask_tree(~is_noise, ss_state,
                                             state["soundstream"])
        indices = self.rvq.quantize(feats, num_quantizers,
                                    method=self._rvq_method,
                                    max_stages=self._max_stages)
        return indices, is_noise, new_state
