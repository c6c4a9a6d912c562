# The step logic below follows EncoderEngine._step_impl and
# DecoderEngine._step_impl of lyra_tpu_torch/codec/engine.py at commit
# d33c86f8529266b8cfd7b29e220ae5f0401d98aa (the PLC machine, the comfort
# noise and the crossfade of lyra/lyra_decoder.cc), written over the
# reference's own plain pieces: float32 graphs, float32 codebooks, no DTX.
"""The plain Lyra v2 codec for a few streams, one 20 ms hop per call.

`Encoder.step(state, pcm)` → (features [R, 64], state): the resampler to
16 kHz where the stream's rate differs, int16 clipping, SoundStream.
`Decoder.step(state, codes, received)` → (pcm [R, hop] int16 values as
float32, state): RVQ decode of the received codes (zeros where lost, the
engine's default estimator), LyraGAN, the six-state PLC machine, the
decoder's noise estimator, comfort noise and the cos² crossfade, then the
resampler to the stream's rate.  `rows` are the streams' slot numbers in
the server: the comfort-noise RNG counter starts from them and the
server's seed.  The Lyra configurations name this module as their
`reference` (the interface is in portbench/compare.py's docstring).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import constants, dsp_utils, graph
from portbench.reference.comfort_noise import ComfortNoiseGenerator
from portbench.reference.noise_estimator import NoiseEstimator
from portbench.reference.resampler import Resampler

INTERNAL = constants.INTERNAL_SAMPLE_RATE
INTERNAL_HOP = constants.num_samples_per_hop(INTERNAL)
CONCEALMENT_SAMPLES = int(0.08 * INTERNAL)
FADE_SAMPLES = int(0.04 * INTERNAL)
FADE_TO_CNG, FADE_FROM_CNG = 1, -1


def _where_tree(mask, new, old):
    if isinstance(new, dict):
        return {k: _where_tree(mask, v, old[k]) for k, v in new.items()}
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def stages_of(bits):
    """RVQ stages a packet of `bits` quantized bits carries: 4 bits a
    stage (an int, or an integer array elementwise)."""
    return bits // 4


def unpack_wire(wire: np.ndarray, stages: int) -> np.ndarray:
    """[R, bytes] packets → [R, stages] int32 codes: 4 bits a stage, the
    first stage in the first byte's high nibble."""
    w = np.asarray(wire, np.uint8)
    nib = np.stack([w >> 4, w & 15], axis=-1).reshape(w.shape[0], -1)
    return nib[:, :stages].astype(np.int32)


class Encoder:
    def __init__(self, model_dir: str, sample_rate_hz: int, device):
        self.device = torch.device(device)
        self.model = graph.Graph(
            os.path.join(model_dir, "soundstream_encoder.tflite"), device)
        self.resampler = (None if sample_rate_hz == INTERNAL else
                          Resampler(sample_rate_hz, INTERNAL, device=device))

    def init_state(self, rows: int) -> Dict:
        state = {"model": self.model.init_state(rows)}
        if self.resampler is not None:
            state["resampler"] = self.resampler.init_state(rows)
        return state

    def features(self, pcm, spans, warm: int = 32,
                 chunk: int = 256) -> List[torch.Tensor]:
        """[stop − start, 64] features of each lane's ticks, where lane l
        runs from the initial state at tick start_l (`spans` [(start_l,
        stop_l)]) and `pcm(ticks, lanes)` is [K, hop] int16: lane lanes[k]'s
        PCM at tick ticks[k] (numpy).  SoundStream and the resampler hold
        only a finite history of their inputs (their state is input rows,
        no feedback), so a run that starts from the initial state `warm`
        ticks before a tick gives that tick's features as the run from the
        lane's start does.  Each lane's ticks are cut into chunks run side
        by side as rows of one batch, each from `warm` ticks before its
        start (a lane's first from its start itself): a few hundred steps
        instead of one per tick."""
        parts = []  # (lane, chunk start, first tick fed), chunk-major
        for c in range(max(-(-(b - a) // chunk) for a, b in spans)):
            parts += [(ln, a + c * chunk, a if c == 0 else a + c * chunk - warm)
                      for ln, (a, b) in enumerate(spans) if a + c * chunk < b]
        lane = np.array([p[0] for p in parts])
        s0 = np.array([p[1] for p in parts])
        begin = np.array([p[2] for p in parts])
        stop = np.array([spans[ln][1] for ln in lane])
        k = len(parts)
        hop = pcm(s0[:1], lane[:1]).shape[1]
        state = self.init_state(k)
        out = torch.empty((k, chunk, self.model.sg.tensors[
            self.model._out].shape[-1]), device=self.device)
        for j in range(-warm, chunk):
            t = s0 + j
            fed = (begin <= t) & (t < stop)
            x = np.zeros((k, hop), np.int16)
            if fed.any():
                x[fed] = pcm(t[fed], lane[fed])
            feats, new = self.step(state, torch.as_tensor(x, device=self.device))
            # A chunk that starts at its lane's start has no steps before.
            state = _where_tree(torch.as_tensor(
                begin <= t, device=self.device), new, state) if j < 0 else new
            if j >= 0:
                out[:, j] = feats
        return [torch.cat([out[i, :min(chunk, spans[ln][1] - s0[i])]
                           for i in np.flatnonzero(lane == ln)])
                for ln in range(len(spans))]

    def step(self, state: Dict, pcm: torch.Tensor):
        new = dict(state)
        x = pcm.float()
        if self.resampler is not None:
            x, new["resampler"] = self.resampler.resample(state["resampler"], x)
            x = dsp_utils.clip_to_int16(x).float()
        feats, new["model"] = self.model(state["model"],
                                         dsp_utils.int16_to_unit(x))
        return feats[:, 0, :], new


class Decoder:
    def __init__(self, model_dir: str, sample_rate_hz: int, device):
        self.device = torch.device(device)
        self.model = graph.Graph(os.path.join(model_dir, "lyragan.tflite"),
                                 device)
        self.codebooks = torch.tensor(graph.codebooks(
            os.path.join(model_dir, "quantizer.tflite")), device=device)
        self.cng = ComfortNoiseGenerator(INTERNAL, device=device)
        self.noise = NoiseEstimator(INTERNAL, device=device)
        self.resampler = (None if sample_rate_hz == INTERNAL else
                          Resampler(INTERNAL, sample_rate_hz, device=device))

    def init_state(self, rows, seed: int = 0) -> Dict:
        """`rows`: the streams' slot numbers in the server."""
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        b, dev = int(rows.shape[0]), self.device
        cng = self.cng.init_state(b, seed=seed)
        # The counter of slot r: r · 0x9E3779B9 + seed, mod 2³² (the
        # generator's init_state numbers rows from 0).
        lo = rows * (0x9E3779B9 & 0xFFFF)
        hi = ((rows * (0x9E3779B9 >> 16)) & 0xFFFF) << 16
        cng["ctr"] = (((lo + hi) & 0xFFFFFFFF) + (seed & 0xFFFFFFFF)) \
            & 0xFFFFFFFF
        state = {
            "model": self.model.init_state(b),
            "cng": cng,
            "noise": self.noise.init_state(b),
            "concealment": torch.zeros((b,), dtype=torch.int32, device=dev),
            "fade": torch.zeros((b,), dtype=torch.int32, device=dev),
            "fade_dir": torch.full((b,), FADE_FROM_CNG, dtype=torch.int32,
                                   device=dev),
        }
        if self.resampler is not None:
            state["resampler"] = self.resampler.init_state(b)
        return state

    def features(self, codes: torch.Tensor) -> torch.Tensor:
        """[R, n] codes → [R, 64]: the sum of each stage's codeword; a code
        of −1 (a stage past the row's bitrate) adds nothing."""
        stages = torch.arange(codes.shape[1], device=codes.device)[None, :]
        words = self.codebooks[stages, codes.long().clamp_min(0)]
        return torch.where((codes >= 0)[..., None], words, 0.0).sum(dim=1)

    def step(self, state: Dict, codes: torch.Tensor, received: torch.Tensor):
        received = received.bool()
        lossy = self.features(codes)
        conceal_sat = state["concealment"] >= CONCEALMENT_SAMPLES
        fade_dir = torch.where(
            received, FADE_FROM_CNG,
            torch.where(conceal_sat, FADE_TO_CNG, state["fade_dir"])
        ).to(torch.int32)
        concealment = torch.where(
            received, 0,
            torch.where(conceal_sat, state["concealment"],
                        state["concealment"] + INTERNAL_HOP)).to(torch.int32)
        run_model = ~((fade_dir == FADE_TO_CNG)
                      & (state["fade"] == FADE_SAMPLES))
        run_cng = ~((fade_dir == FADE_FROM_CNG) & (state["fade"] == 0))

        feats = torch.where(received[:, None], lossy, torch.zeros_like(lossy))
        unit, model_state = self.model(state["model"], feats[:, None, :])
        model_state = _where_tree(run_model, model_state, state["model"])
        model_hop = dsp_utils.unit_to_int16(unit).float()

        cng_hop, cng_state = self.cng.generate_hop(
            state["cng"], state["noise"]["noise_estimate"])
        cng_hop = dsp_utils.clip_to_int16(cng_hop).float()
        cng_state = _where_tree(run_cng, cng_state, state["cng"])

        i = torch.arange(INTERNAL_HOP, dtype=torch.float32,
                         device=self.device)[None, :]
        p = state["fade"].float()[:, None] + fade_dir.float()[:, None] * i
        w = (1.0 + torch.cos(p * torch.pi / FADE_SAMPLES)) / 2.0
        blended = w * model_hop + (1.0 - w) * cng_hop
        audio = torch.where((run_model & run_cng)[:, None], blended,
                            torch.where(run_model[:, None], model_hop, cng_hop))
        audio = dsp_utils.clip_to_int16(audio).float()
        fade = torch.clamp(state["fade"] + fade_dir * INTERNAL_HOP, 0,
                           FADE_SAMPLES).to(torch.int32)
        noise_state = _where_tree(
            received, self.noise.receive_hop(state["noise"], model_hop),
            state["noise"])
        new = {"model": model_state, "cng": cng_state, "noise": noise_state,
               "concealment": concealment, "fade": fade, "fade_dir": fade_dir}
        if self.resampler is not None:
            audio, new["resampler"] = self.resampler.resample(
                state["resampler"], audio)
            audio = dsp_utils.clip_to_int16(audio).float()
        return audio, new


def code_gaps(features: torch.Tensor, codes: torch.Tensor,
              codebooks: torch.Tensor) -> torch.Tensor:
    """How far each stage's code lies from the best codeword, following the
    given codes, as a share of the features' norm: for stage s with
    residual r = x − Σ_{j<s} c_j[codes_j], (‖r − c_k‖² − min_j ‖r − c_j‖²)
    / (2 ‖c_k − c_best‖ · ‖x‖), 0 where k is a best codeword.  A search on
    features x + δ can only choose a k whose gap is ≤ ‖δ‖ / ‖x‖, so this
    reads the relative error of the features behind each code.  float64.
    features [N, 64], codes [N, S] → [N, S]."""
    x = features.double()
    cb = codebooks[:codes.shape[1]].double()  # [S, 16, F]
    stages = torch.arange(codes.shape[1], device=codes.device)[None, :]
    chosen = cb[stages, codes.long()]  # [N, S, F]
    before = torch.cumsum(chosen, dim=1) - chosen
    resid = x[:, None, :] - before  # [N, S, F]
    d = ((resid * resid).sum(-1)[..., None]
         - 2.0 * torch.einsum("nsf,skf->nsk", resid, cb)
         + (cb * cb).sum(-1)[None])  # [N, S, 16]
    best = d.argmin(-1)
    gap = d.gather(2, codes.long()[..., None])[..., 0] - d.min(-1).values
    apart = (chosen - cb[stages, best]).norm(dim=-1)
    scale = 2.0 * apart * x.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.where(apart > 0, gap / scale, torch.zeros_like(gap))
