"""Batched lockstep codec engines — port of lyra_tpu/codec/engine.py.

One `step()` advances B streams by one 20 ms hop.  EncoderEngine: (DTX
noise gate) → SoundStream features → RVQ stage indices.  DecoderEngine:
RVQ decode → feature estimator → LyraGAN, the 6-state PLC machine, the
decoder-side noise estimator, comfort noise and the cos² crossfade.  Every
per-stream scalar is a `[B]` tensor and every branch a `torch.where` mask,
so streams in different PLC states batch together.

State is an explicit dict tree with the JAX engine's keys and shapes
(utils/state.py converts between the two).  `_step_impl` is pure: it
returns a new tree and leaves the input tree untouched.

`step` is `_step_impl` compiled, the counterpart of the JAX engines'
`jax.jit(self._step_impl)`: on the card each step is one CUDA-graph replay
(utils/capture.py, through `engine.graphs`), and the tree it returns stays
valid until two more steps have run (the capture's ping-pong trees; the
analog of donating the state).  Where `graphs` is None — always on the
CPU, and on the card where a caller sets it so, as the checks of the
captured path do — `step` runs `_step_impl` eagerly.  `reset_rows` on the
card is one replay too, under the same rule.  The engine's graph cache
serves one state lineage at a time; a holder of its own lineage (a
server) runs the same programs in a cache of its own (`own_graphs`).

`backend="kernel"` (the default) runs the conv stacks through the
conv-stack kernels and the RVQ search through its kernel; on CPU tensors
those wrappers run their plain versions.  `backend="plain"` runs the
executor lowering and the `"fast"` RVQ search — the plain reference on
either device.  The JAX engines' names map onto these (`BACKEND_NAMES`):
`"fused"`, the JAX kernel path, is `"kernel"`, and `"xla"`, the JAX per-op
lowering, is `"plain"`.  The constructors take the JAX engines' parameters
in the JAX order; `device` is keyword-only.

`mode` is "float", "bf16" (the JAX package's serving mode: the conv
stacks compute in bf16 and the decoder's RVQ decode rounds the codebooks
to bf16), "int8" (TFLite's integer-kernel arithmetic in the int8 islands)
or "fakequant" (float ops snapped to the int8 grid).
`state_compression="int8"` stores the conv stacks' state between steps as
int8 with a per-stream scale (nested `{"q", "s"}` leaves; half the bytes
of a snapshot), and `boundary_store="f8"` stores the graphs' large
intermediates as fp8 e4m3 inside a step.  These four run their graphs on
the plain backend only, as the JAX package's run on its xla lowering: the
kernel backend refuses them with a ValueError that names
`backend="plain"`.  Their RVQ search, which they do not change, runs on its
kernel (`rvq_encode`) all the same.

`sample_rate_hz` is any of `config.SUPPORTED_SAMPLE_RATES`: the codec runs
at 16 kHz and a `"resampler"` state leaf carries the polyphase filter's
history at the stream's rate, as in the JAX engines.

Both engines run on the card unless `device=` names another device; without
a card the default raises (utils/device.py), so CPU callers pass
`device="cpu"`.

Each `_step_impl` marks its modules' boundaries for the tracer
(utils/trace.py `mark`): the decoder's `dec.rvq_decode`, `dec.plc`,
LyraGAN's `gan.*` (ops/fused_stack.py), `dec.gan_select`, `dec.cng`,
`dec.crossfade`, `dec.noise`, `dec.resample` and `dec.out`; the encoder's
`enc.in`, `enc.resample`, `enc.noise`, SoundStream's `ss.*`,
`enc.ss_select` and `enc.rvq`.  Markers launch only while tracing is on.
The decoder's step counts `dec.rows_run`, the rows its loss concealment
and comfort noise run over (every row: both are masked per row, not
skipped).

Differences from the JAX engines: comfort noise is always synthesized,
so `gate_idle_stages` is accepted and changes no bit (the JAX engine skips
it with a `lax.cond` when no stream needs it — the masked result is
bit-identical, and testing `any()` on the host would cost a device sync
every tick).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

import numpy as np
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
from lyra_tpu_torch.ops.fused_stack import refuse_kernel_backend
from lyra_tpu_torch.tflite.executor import (
    QUANT_MODES,
    check_boundary,
    compute_dtype,
)
from lyra_tpu_torch.utils import trace
from lyra_tpu_torch.utils.capture import GraphCache, as_input, replay
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
    compute_dtype(mode)  # an unknown mode raises
    if state_compression not in (None, "int8"):
        raise ValueError(
            f"unsupported state_compression {state_compression!r}")
    check_boundary(mode, boundary_store, 1.0)
    if BACKEND_NAMES[backend] == "kernel":
        refuse_kernel_backend(mode, state_compression, boundary_store)
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


class _Compiled:
    """What both engines share: running a pure function of the state as
    one CUDA-graph replay on the card (or eagerly), and the admission
    template."""

    device: torch.device
    graphs: GraphCache | None

    def _compile_on(self, device: torch.device) -> None:
        self.graphs = GraphCache(device) if device.type == "cuda" else None
        self._fresh: Dict[tuple, State] = {}

    def own_graphs(self) -> GraphCache | None:
        """A graph cache for one holder of a long-lived state (a server):
        its state trees are its own, so holders on one engine never write
        each other's state; it shares this engine's memory pool.  None
        where the engine runs eagerly."""
        if self.graphs is None:
            return None
        return GraphCache(self.device, pool=self.graphs.pool)

    def replica(self, device) -> "_Compiled":
        """The same engine built anew on `device` (its weights loaded
        there): a shard's engine in parallel/sharding.py."""
        return type(self)(**self._ctor, device=device)

    def _step_args(self, *args) -> tuple:
        """`step`'s inputs as its program takes them."""
        return args

    def _run(self, fn: Callable, key, state: State, *inputs,
             graphs: GraphCache | None = None):
        """`fn(state, *inputs) -> (*outputs, new_state)` as one replay of
        its graph for `key` (its static arguments) in `graphs` (by default
        the engine's own), or eagerly where the engine's `graphs` is None.
        Inputs may be numpy arrays or tensors on any device."""
        if self.graphs is None:
            graphs = None  # eager: the CPU, or where a caller chose so
        return replay(graphs or self.graphs, self.device, fn, key, state,
                      *inputs)

    def _reset(self, state: State, mask, graphs: GraphCache | None = None,
               **init) -> State:
        mask = as_input(mask).bool()
        b = int(mask.shape[0])
        key = (b, *sorted(init.items()))
        if key not in self._fresh:
            self._fresh[key] = self.init_state(b, **init)
        fresh = self._fresh[key]
        return self._run(lambda s, m: (mask_tree(m, fresh, s),),
                         ("reset", key), state, mask, graphs=graphs)[0]


class DecoderEngine(_Compiled):
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
        self._ctor = dict(
            sample_rate_hz=sample_rate_hz, model_path=model_path, mode=mode,
            backend=backend, feature_estimator=feature_estimator,
            max_bitrate=max_bitrate, gate_idle_stages=gate_idle_stages,
            state_compression=state_compression,
            boundary_store=boundary_store, emit_dtype=emit_dtype)
        self.device = device = resolve(device)
        self.backend = backend
        self.sample_rate_hz = sample_rate_hz
        self.hop_samples = config.num_samples_per_hop(sample_rate_hz)
        self._emit_int16 = emit_dtype == "int16"
        self.gan = LyraGanModel(model_path, backend=backend, mode=mode,
                                device=device, state_dtype=state_compression,
                                boundary_store=boundary_store)
        self.rvq = ResidualVectorQuantizer.from_model_path(model_path, device)
        self._max_stages = _max_stages(self.rvq, max_bitrate)
        # The JAX engine's: bf16 codewords in bf16 mode, else float32.
        self._decode_dtype = (torch.bfloat16 if mode == "bf16"
                              else torch.float32)
        self.resampler = _resampler(config.INTERNAL_SAMPLE_RATE,
                                    sample_rate_hz, device)
        self.cng = ComfortNoiseGenerator(config.INTERNAL_SAMPLE_RATE,
                                         device=device)
        self.noise = NoiseEstimator(config.INTERNAL_SAMPLE_RATE, device=device)
        self.estimator = _ESTIMATORS[feature_estimator](device=device)
        self._compile_on(device)

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
        """Re-initialize streams where `mask` ([B] bool) is set (stream
        admission); `seed` must match init_state's to keep the per-stream
        RNG lineage.  The rows come from a cached fresh tree; on the card
        the select is one replay (the JAX engine's jitted reset), under
        `step`'s rule for the tree it returns."""
        return self._reset(state, mask, seed=seed)

    def step(self, state: State, indices, received):
        """Advance every stream by one 20 ms hop (one replay on the card;
        see the module docstring).

        indices:  [B, num_stages] int RVQ stage indices (−1 beyond the
                  stream's bitrate; ignored where not received).
        received: [B] bool — False means lost (or a DTX empty packet).
        Both may be numpy arrays or tensors.

        Returns (audio [B, hop_samples] at int16 scale — float32, or int16
        with emit_dtype="int16"; is_comfort_noise [B] bool; new_state).
        On the card audio and is_comfort_noise are the graph's output
        buffers, overwritten by the next step.
        """
        return self._run(self._step_impl, "step", state, indices, received)

    def _step_impl(self, state: State, indices: torch.Tensor,
                   received: torch.Tensor):
        """The step itself, pure and eager over device tensors: what the
        card's graph captures, and the CPU path."""
        trace.mark("dec.rvq_decode", indices)
        received = received.bool()
        lossy = self.rvq.decode(indices, dtype=self._decode_dtype,
                                max_stages=self._max_stages)
        trace.mark("dec.plc", indices)
        # The rows loss concealment and comfort noise run over: all of them.
        trace.count("dec.rows_run", lossy.shape[0])
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
        trace.mark("dec.gan_select", indices)
        gan_state = mask_tree(run_model, gan_state, state["gan"])
        model_hop = dsp_utils.unit_to_int16(model_unit).float()

        trace.mark("dec.cng", indices)
        cng_hop, cng_state = self.cng.generate_hop(
            state["cng"], self.noise.noise_estimate(state["noise"]))
        cng_hop = dsp_utils.clip_to_int16(cng_hop).float()
        cng_state = mask_tree(run_cng, cng_state, state["cng"])

        # cos² crossfade (reference: lyra/lyra_decoder.cc:342-373).
        trace.mark("dec.crossfade", indices)
        w = fade_weights(state["fade"], fade_dir, INTERNAL_HOP)
        blended = w * model_hop + (1.0 - w) * cng_hop
        both = run_model & run_cng
        audio = torch.where(both[:, None], blended,
                            torch.where(run_model[:, None], model_hop, cng_hop))
        audio = dsp_utils.clip_to_int16(audio).float()

        fade = torch.clamp(state["fade"] + fade_dir * INTERNAL_HOP, 0,
                           FADE_SAMPLES).to(torch.int32)

        # The noise estimator listens to received hops' model output only.
        trace.mark("dec.noise", indices)
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
            trace.mark("dec.resample", indices)
            audio, new_state["resampler"] = self.resampler.resample(
                state["resampler"], audio)
            audio = dsp_utils.clip_to_int16(audio).float()
        trace.mark("dec.out", indices)
        is_comfort_noise = fade == FADE_SAMPLES
        if self._emit_int16:
            audio = audio.to(torch.int16)
        return audio, is_comfort_noise, new_state


class EncoderEngine(_Compiled):
    """Batched hop-lockstep Lyra encoder over `[B]` concurrent streams."""

    def __init__(self, sample_rate_hz: int = config.INTERNAL_SAMPLE_RATE,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 enable_dtx: bool = False, mode: str = "float",
                 backend: str = "kernel", max_bitrate: int | None = None,
                 state_compression: str | None = None,
                 boundary_store: str | None = None, *, device=None):
        backend = _checked_common(sample_rate_hz, model_path, backend, mode,
                                  state_compression, boundary_store)
        self._ctor = dict(
            sample_rate_hz=sample_rate_hz, model_path=model_path,
            enable_dtx=enable_dtx, mode=mode, backend=backend,
            max_bitrate=max_bitrate, state_compression=state_compression,
            boundary_store=boundary_store)
        self.device = device = resolve(device)
        self.backend = backend
        self.sample_rate_hz = sample_rate_hz
        self.hop_samples = config.num_samples_per_hop(sample_rate_hz)
        self.enable_dtx = enable_dtx
        self.soundstream = SoundStreamEncoder(
            model_path, backend=backend, mode=mode, device=device,
            state_dtype=state_compression, boundary_store=boundary_store)
        self.rvq = ResidualVectorQuantizer.from_model_path(model_path, device)
        # The "fast" torch search in the plain reference of float and bf16;
        # the kernel on the kernel backend and in the configurations only
        # the plain backend runs (their graphs have no kernel; the search
        # does not change with them).
        plain_only = (mode in QUANT_MODES or state_compression is not None
                      or boundary_store is not None)
        self._rvq_method = ("kernel" if backend == "kernel" or plain_only
                            else "fast")
        self._max_stages = _max_stages(self.rvq, max_bitrate)
        self.noise = (NoiseEstimator(config.INTERNAL_SAMPLE_RATE, device=device)
                      if enable_dtx else None)
        self.resampler = _resampler(sample_rate_hz,
                                    config.INTERNAL_SAMPLE_RATE, device)
        self._compile_on(device)

    def init_state(self, batch_size: int) -> State:
        state = {"soundstream": self.soundstream.init_state(batch_size)}
        if self.noise is not None:
            state["noise"] = self.noise.init_state(batch_size)
        if self.resampler is not None:
            state["resampler"] = self.resampler.init_state(batch_size)
        return state

    def reset_rows(self, state: State, mask) -> State:
        """See DecoderEngine.reset_rows."""
        return self._reset(state, mask)

    def step(self, state: State, audio, num_quantizers):
        """audio [B, hop_samples] at int16 scale (float32 or int16);
        num_quantizers an int or [B] (numpy or tensor).  One replay on the
        card (see the module docstring).

        Returns (indices [B, num_stages] int32, −1 beyond each stream's
        bitrate; is_noise [B] bool; new_state).  A DTX noise hop leaves the
        stream's SoundStream state untouched (the host sends an empty
        packet)."""
        return self._run(self._step_impl, "step", state,
                         *self._step_args(audio, num_quantizers))

    def _step_args(self, audio, num_quantizers) -> tuple:
        """(audio, num_quantizers as [B] int32)."""
        b = int(audio.shape[0])
        if isinstance(num_quantizers, torch.Tensor):
            nq = num_quantizers.to(torch.int32).expand(b)
        else:
            nq = np.broadcast_to(np.asarray(num_quantizers, np.int32), (b,))
        return audio, nq

    def _step_impl(self, state: State, audio: torch.Tensor,
                   num_quantizers: torch.Tensor):
        """The step itself, pure and eager over device tensors
        (num_quantizers [B] int32): what the card's graph captures, and
        the CPU path."""
        trace.mark("enc.in", audio)
        new_state = dict(state)
        x = audio.float()
        if self.resampler is not None:
            trace.mark("enc.resample", audio)
            x, new_state["resampler"] = self.resampler.resample(
                state["resampler"], x)
            x = dsp_utils.clip_to_int16(x).float()
        if self.noise is not None:
            trace.mark("enc.noise", audio)
            noise_state = self.noise.receive_hop(state["noise"], x)
            is_noise = self.noise.is_noise(noise_state)
            new_state["noise"] = noise_state
        else:
            is_noise = torch.zeros((x.shape[0],), dtype=torch.bool,
                                   device=self.device)
        feats, ss_state = self.soundstream.extract(
            state["soundstream"], dsp_utils.int16_to_unit(x))
        trace.mark("enc.ss_select", audio)
        new_state["soundstream"] = mask_tree(~is_noise, ss_state,
                                             state["soundstream"])
        trace.mark("enc.rvq", audio)
        indices = self.rvq.quantize(feats, num_quantizers,
                                    method=self._rvq_method,
                                    max_stages=self._max_stages)
        return indices, is_noise, new_state
