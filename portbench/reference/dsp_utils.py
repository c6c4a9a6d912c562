# Frozen copy of lyra_tpu_torch/dsp/utils.py at commit d33c86f8529266b8cfd7b29e220ae5f0401d98aa, for the
# benchmark's plain reference; only the imports differ.
"""Sample-format conversions and spectral metrics (port of
lyra_tpu/dsp/utils.py, torch flavor).

Unit-float ↔ int16 scaling uses 32768 as the scale, clamps to
[-32768, 32767], and quantizes with C-style truncation toward zero.
"""

from __future__ import annotations

import numpy as np
import torch

_INT16_SCALE = 32768.0
_INT16_MIN = -32768.0
_INT16_MAX = 32767.0


def int16_to_unit(samples: torch.Tensor) -> torch.Tensor:
    return samples.float() / _INT16_SCALE


def unit_to_int16(values: torch.Tensor) -> torch.Tensor:
    scaled = values.float() * _INT16_SCALE
    return torch.trunc(torch.clamp(scaled, _INT16_MIN, _INT16_MAX)).to(torch.int16)


def clip_to_int16(values: torch.Tensor) -> torch.Tensor:
    clipped = torch.clamp(values.float(), _INT16_MIN, _INT16_MAX)
    return torch.trunc(clipped).to(torch.int16)


def clip_to_int16_np(values: np.ndarray) -> np.ndarray:
    clipped = np.clip(np.asarray(values, np.float32), _INT16_MIN, _INT16_MAX)
    return np.trunc(clipped).astype(np.int16)


def convert_num_samples(source_num: int, source_rate: int, target_rate: int) -> int:
    """ceil(source_num * target/source) using f32 arithmetic like the reference."""
    return int(np.ceil(np.float32(source_num) * np.float32(target_rate) / np.float32(source_rate)))


def log_spectral_distance(a, b):
    """10 * sqrt(mean((a-b)^2)) over log-spectra; works on numpy or torch.

    Reference metric: lyra/dsp_utils.cc:27-41.  Last axis is the spectrum.
    """
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return 10.0 * torch.sqrt(torch.mean(torch.square(a.float() - b.float()), dim=-1))
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return 10.0 * np.sqrt(np.mean(np.square(a - b), axis=-1))
