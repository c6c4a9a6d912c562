# Frozen copy of lyra_tpu_torch/dsp/melspec.py at commit d33c86f8529266b8cfd7b29e220ae5f0401d98aa, for the
# benchmark's plain reference; only the imports differ.
"""Streaming log-mel spectrogram extraction (port of lyra_tpu/dsp/melspec.py).

The numpy matrix builders are copied from the JAX module, which imports jax
at its top and so cannot be imported here.  Features = log(max(mel, 500))
/ 10 over a periodic-Hann-windowed real DFT (as two matmuls) of the last
`window` samples at int16 scale; the carried state is the previous
`window − hop` samples per stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import constants as config
from torch import device as resolve

LOG_FLOOR = 500.0
NORM = 10.0
UPPER_FREQ_FACTOR = 0.495
LOWER_FREQ_LIMIT = 0.0


def _freq_to_mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def next_power_of_two(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def mel_weight_matrix(num_fft_bins: int, sample_rate: int, num_mel_bins: int,
                      lower_limit: float = LOWER_FREQ_LIMIT,
                      upper_limit: float | None = None) -> np.ndarray:
    """audio_dsp::MelFilterbank weights as a dense [num_fft_bins, mels]
    matrix, applied to the magnitude spectrum."""
    if upper_limit is None:
        upper_limit = UPPER_FREQ_FACTOR * sample_rate
    mel_low = _freq_to_mel(lower_limit)
    mel_hi = _freq_to_mel(upper_limit)
    spacing = (mel_hi - mel_low) / (num_mel_bins + 1)
    centers = mel_low + spacing * (np.arange(num_mel_bins + 1) + 1)

    hz_per_bin = 0.5 * sample_rate / (num_fft_bins - 1)
    start_index = int(1.5 + lower_limit / hz_per_bin)
    end_index = int(upper_limit / hz_per_bin)

    a = np.zeros((num_fft_bins, num_mel_bins), np.float64)
    channel = 0
    for i in range(num_fft_bins):
        if i < start_index or i > end_index:
            continue
        melf = _freq_to_mel(i * hz_per_bin)
        while channel < num_mel_bins and centers[channel] < melf:
            channel += 1
        band = channel - 1  # may be -1
        if band >= 0:
            w = (centers[band + 1] - melf) / (centers[band + 1] - centers[band])
        else:
            w = (centers[0] - melf) / (centers[0] - mel_low)
        if band >= 0:
            a[i, band] += w
        if band + 1 < num_mel_bins:
            a[i, band + 1] += 1.0 - w
    return a


def hann_window(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@dataclasses.dataclass
class MelConfig:
    sample_rate: int
    hop: int
    window: int
    num_mel_bins: int

    @classmethod
    def for_rate(cls, sample_rate: int, num_mel_bins: int = config.NUM_MEL_BINS):
        hop = config.num_samples_per_hop(sample_rate)
        return cls(sample_rate, hop, config.OVERLAP_FACTOR * hop, num_mel_bins)

    @property
    def fft_size(self) -> int:
        return next_power_of_two(self.window)

    @property
    def num_fft_bins(self) -> int:
        return self.fft_size // 2 + 1


def dft_matrices(window: int, fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Real DFT as two [window, bins] matrices: X = x@C + i·x@S."""
    bins = fft_size // 2 + 1
    n = np.arange(window)[:, None]
    k = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * n * k / fft_size
    return (np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32))


def idft_matrices(fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse real DFT as two [bins, fft_size] matrices: the exact irfft."""
    bins = fft_size // 2 + 1
    k = np.arange(bins)[:, None]
    n = np.arange(fft_size)[None, :]
    ang = 2.0 * np.pi * k * n / fft_size
    w = np.full((bins, 1), 2.0 / fft_size)
    w[0] = w[-1] = 1.0 / fft_size
    return ((np.cos(ang) * w).astype(np.float32),
            (-np.sin(ang) * w).astype(np.float32))


def num_used_fft_bins(weights: np.ndarray, num_fft_bins: int) -> int:
    """Last FFT bin carrying nonzero mel mass, as a bin count; truncating
    the DFTs to it is exact."""
    nz = np.flatnonzero(np.abs(np.asarray(weights)).sum(axis=1) > 0)
    return int(nz[-1]) + 1 if nz.size else num_fft_bins


class LogMelExtractor:
    """Batched f32 log-mel over [num_streams, hop] frames on `device`."""

    def __init__(self, cfg: MelConfig, device=None):
        self.cfg = cfg
        self.device = resolve(device)
        mel = mel_weight_matrix(cfg.num_fft_bins, cfg.sample_rate,
                                cfg.num_mel_bins).astype(np.float32)
        used = num_used_fft_bins(mel, cfg.num_fft_bins)
        c, s = dft_matrices(cfg.window, cfg.fft_size)
        t = lambda a: torch.tensor(np.ascontiguousarray(a), device=self.device)
        self._win = t(hann_window(cfg.window).astype(np.float32))
        self._mel = t(mel[:used])
        self._dft_cos = t(c[:, :used])
        self._dft_sin = t(s[:, :used])

    def init_state(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((batch_size, self.cfg.window - self.cfg.hop),
                           dtype=torch.float32, device=self.device)

    def extract(self, state: torch.Tensor, frames: torch.Tensor):
        """frames [B, hop] int16-scale → ([B, mels], new_state)."""
        full = torch.cat([state, frames.float()], dim=1)  # [B, window]
        new_state = full[:, self.cfg.hop:]
        xw = full * self._win[None]
        re = xw @ self._dft_cos
        im = xw @ self._dft_sin
        mel = torch.sqrt(re * re + im * im) @ self._mel
        return torch.log(torch.clamp(mel, min=LOG_FLOOR)) / NORM, new_state
