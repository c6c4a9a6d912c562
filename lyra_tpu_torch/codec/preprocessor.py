"""Pre-encode hook (reference: lyra/no_op_preprocessor.h:40-49,
lyra/preprocessor_interface.h): an optional stage between wav input and the
encoder; the reference ships only an identity implementation.  The port's
copy of lyra_tpu/codec/preprocessor.py."""

from __future__ import annotations

import numpy as np


class NoOpPreprocessor:
    def process(self, audio: np.ndarray, sample_rate_hz: int) -> np.ndarray:
        del sample_rate_hz
        return np.asarray(audio, np.int16)
