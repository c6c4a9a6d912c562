# Frozen copy of lyra_tpu_torch/codec/noise_estimator.py at commit d33c86f8529266b8cfd7b29e220ae5f0401d98aa, for the
# benchmark's plain reference; only the imports differ.
"""Minimum-statistics noise estimation in the log-mel domain, batched.

Port of lyra_tpu/codec/noise_estimator.py: per 20 ms hop, 160 log-mel
features, a noise/speech decision against `noise_estimate ± noise_bound`,
running minima of smoothed power with a 1 s update period, and an
exponentially decaying bound during sustained noise.  Every per-stream
scalar is a `[B]` tensor and the branches are `torch.where` masks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import constants as config
from portbench.reference import melspec
from torch import device as resolve

_POW_DIFF = 0.3
_BOUND_FACTOR = 0.9
_MAX_SMOOTHING_HALFLIFE_SECS = 0.7
_UPDATE_TIME_SECS = 1.0
_BOUND_HALFLIFE_SECS = 1.0

State = Dict[str, torch.Tensor]


class NoiseEstimator:
    def __init__(self, sample_rate_hz: int,
                 num_features: int = config.NUM_MEL_BINS, device=None):
        hop = config.num_samples_per_hop(sample_rate_hz)
        self.device = resolve(device)
        self.num_features = num_features
        self.cfg = melspec.MelConfig.for_rate(sample_rate_hz, num_features)
        self._mel = melspec.LogMelExtractor(self.cfg, device=self.device)
        secs_per_hop = hop / sample_rate_hz
        self.num_hops_per_update = int(round(_UPDATE_TIME_SECS / secs_per_hop))
        self.max_smoothing = 0.5 ** (secs_per_hop / _MAX_SMOOTHING_HALFLIFE_SECS)
        self.bound_decay = 0.5 ** (secs_per_hop / _BOUND_HALFLIFE_SECS)
        self._log_f = float(np.log(float(num_features)))

    def init_state(self, batch_size: int) -> State:
        b, f, dev = batch_size, self.num_features, self.device
        z = torch.zeros((b, f), dtype=torch.float32, device=dev)
        return {
            "mel": self._mel.init_state(batch_size),
            "smoothed": z,
            "squared_smoothed": z,
            "tmp_min": z,
            "noise_estimate": z,
            "noise_bound": z,
            "is_noise": torch.ones((b,), dtype=torch.bool, device=dev),
            "hops_received": torch.zeros((b,), dtype=torch.int32, device=dev),
            "initialized": torch.zeros((b,), dtype=torch.bool, device=dev),
        }

    def receive_hop(self, state: State, hop_samples: torch.Tensor) -> State:
        """Consume one hop of int16-scale samples per stream."""
        feats, mel_state = self._mel.extract(state["mel"], hop_samples)
        state = self.receive_features(state, feats)
        return {**state, "mel": mel_state}

    @staticmethod
    def compute_is_noise(state: State, cur: torch.Tensor) -> torch.Tensor:
        """Noise iff every bin lies within `estimate ± bound`."""
        return torch.all(
            torch.abs(cur - state["noise_estimate"]) <= state["noise_bound"],
            dim=-1)

    def receive_features(self, state: State, cur: torch.Tensor) -> State:
        """Classify against the previous estimate/bound, then update the
        estimate (speech) or decay the bound (noise)."""
        is_noise = self.compute_is_noise(state, cur)

        m = (~state["initialized"])[:, None]
        smoothed = torch.where(m, cur, state["smoothed"])
        squared = torch.where(m, cur * cur, state["squared_smoothed"])
        tmp_min = torch.where(m, cur, state["tmp_min"])

        correction = torch.exp(-torch.square(
            (smoothed.mean(-1) - cur.mean(-1)) / _POW_DIFF))[:, None]
        sf = (self.max_smoothing * correction * torch.exp(-torch.square(
            (smoothed - state["noise_estimate"]) / _POW_DIFF)))
        new_smoothed = sf * smoothed + (1.0 - sf) * cur
        new_squared = sf * squared + (1.0 - sf) * cur * cur

        au = (state["hops_received"] == 0)[:, None]
        new_noise_est = torch.where(
            au, torch.minimum(tmp_min, new_smoothed),
            torch.minimum(state["noise_estimate"], new_smoothed))
        new_tmp = torch.where(au, new_smoothed,
                              torch.minimum(tmp_min, new_smoothed))

        variance = torch.clamp(new_squared - torch.square(new_smoothed), min=0.0)
        new_bound = _BOUND_FACTOR * torch.sqrt(variance * self._log_f)
        new_hops = (state["hops_received"] + 1) % self.num_hops_per_update

        decayed_bound = state["noise_bound"] * self.bound_decay

        n = is_noise[:, None]
        return {
            "mel": state["mel"],
            "smoothed": torch.where(n, smoothed, new_smoothed),
            "squared_smoothed": torch.where(n, squared, new_squared),
            "tmp_min": torch.where(n, tmp_min, new_tmp),
            "noise_estimate": torch.where(n, state["noise_estimate"],
                                          new_noise_est),
            "noise_bound": torch.where(n, decayed_bound, new_bound),
            "is_noise": is_noise,
            "hops_received": torch.where(is_noise, state["hops_received"],
                                         new_hops),
            "initialized": state["initialized"] | ~is_noise,
        }

    @staticmethod
    def noise_estimate(state: State) -> torch.Tensor:
        return state["noise_estimate"]

    @staticmethod
    def is_noise(state: State) -> torch.Tensor:
        return state["is_noise"]
