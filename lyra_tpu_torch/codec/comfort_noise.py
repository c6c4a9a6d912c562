"""Comfort-noise generation from log-mel noise features, batched.

Port of lyra_tpu/codec/comfort_noise.py: 160 log-mel features → exp →
mel-to-linear spectrum (channel-mass-normalized pseudo-inverse) → random
phases → inverse real DFT (two matmuls) → overlap-added hop of int16-scale
samples.  Per-stream state: the overlap-add carry and a phase-RNG counter.

The JAX package keeps the counter as uint32 and hashes it in uint32.  torch
lacks `>>` and `+` for uint32 on the CPU, so here the counter is an int64
holding the same uint32 value and the hash runs in int64, masked to 32
bits.  Products are split into 16-bit halves so no int64 product
overflows; the phases are bit-identical to the JAX ones.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lyra_tpu_torch import config
from lyra_tpu_torch.dsp import melspec
from lyra_tpu_torch.utils.device import resolve

State = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def random_phases(ctr: torch.Tensor, num_bins: int) -> torch.Tensor:
    """[B] counters (uint32 values in int64) → [B, num_bins] uniform phases
    in [0, 2π): the murmur3-finalizer hash of the JAX package."""
    k = torch.arange(num_bins, dtype=torch.int64, device=ctr.device)[None, :]
    x = ctr[:, None] ^ ((_mul32(k, 0x85EBCA6B) + 0xC2B2AE35) & _M32)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * np.float32(2.0 * np.pi / 4294967296.0)


class ComfortNoiseGenerator:
    def __init__(self, sample_rate_hz: int,
                 num_mel_bins: int = config.NUM_MEL_BINS, device=None):
        self.device = resolve(device)
        self.cfg = melspec.MelConfig.for_rate(sample_rate_hz, num_mel_bins)
        a = melspec.mel_weight_matrix(self.cfg.num_fft_bins, sample_rate_hz,
                                      num_mel_bins)  # [bins, mels]
        mass = a.sum(axis=0)
        inv_mass = np.where(mass > 0, 1.0 / np.maximum(mass, 1e-12), 0.0)
        inv = a * inv_mass[None, :]
        self._num_used_bins = melspec.num_used_fft_bins(
            inv, self.cfg.num_fft_bins)
        ci, si = melspec.idft_matrices(self.cfg.fft_size)
        u = self._num_used_bins
        t = lambda m: torch.tensor(np.ascontiguousarray(m), device=self.device)
        self._inverse_t = t(inv[:u].astype(np.float32).T)  # [mels, bins]
        self._idft_cos = t(ci[:u])  # [bins, fft]
        self._idft_sin = t(si[:u])

    def init_state(self, batch_size: int, seed: int = 0) -> State:
        carry_len = self.cfg.fft_size - self.cfg.hop
        rows = torch.arange(batch_size, dtype=torch.int64, device=self.device)
        ctr = (_mul32(rows, 0x9E3779B9) + (seed & _M32)) & _M32
        return {
            "carry": torch.zeros((batch_size, carry_len), dtype=torch.float32,
                                 device=self.device),
            "ctr": ctr,
        }

    def generate_hop(self, state: State, features: torch.Tensor):
        """features [B, mels] log-mel noise estimate → ([B, hop] samples at
        int16 scale, unclipped, new_state)."""
        mel = torch.exp(features * melspec.NORM)
        mag = mel @ self._inverse_t  # [B, bins]
        ctr = state["ctr"]
        phases = random_phases(ctr, self._num_used_bins)
        frame = ((mag * torch.cos(phases)) @ self._idft_cos
                 + (mag * torch.sin(phases)) @ self._idft_sin)  # [B, fft]
        hop = self.cfg.hop
        carry = state["carry"]
        n = carry.shape[1]
        ola = torch.cat([frame[:, :n] + carry, frame[:, n:]], dim=1)
        return ola[:, :hop], {"carry": ola[:, hop:],
                              "ctr": (ctr + 0x6A09E667) & _M32}
