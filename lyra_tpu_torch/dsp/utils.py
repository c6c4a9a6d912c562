"""Sample-format conversions (port of lyra_tpu/dsp/utils.py, torch flavor).

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
