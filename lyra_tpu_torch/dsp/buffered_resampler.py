"""Pull-style buffered resampler (host-side, single stream) — port of
lyra_tpu/dsp/buffered_resampler.py over the port's numpy
`StreamingResampler`.

Inverts the push resampler for the decoder's playout path, mirroring the
reference's BufferedResampler (reference: lyra/buffered_resampler.cc:63-147):
given a request for N external-rate samples, compute how many internal-rate
samples must be generated, pull them from a generator closure, resample, serve
any banked leftovers first, and bank the overflow.  Integer rate ratios only
(reference: lyra/buffered_resampler.cc:48-60).

This is deliberate host code: request sizes are dynamic and stream-specific,
which is exactly what should stay off the accelerator.  The batched lockstep
engine (`codec/engine.py`) never needs it — hop-in/hop-out serving has static
shapes, so its resampling runs inside the captured step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.dsp.resampler import StreamingResampler


class BufferedResampler:
    def __init__(self, internal_sample_rate: int, external_sample_rate: int):
        if external_sample_rate > internal_sample_rate:
            if external_sample_rate % internal_sample_rate != 0:
                raise ValueError("upsampling ratio must be integer")
        elif internal_sample_rate % external_sample_rate != 0:
            raise ValueError("downsampling ratio must be integer")
        self._internal_rate = internal_sample_rate
        self._external_rate = external_sample_rate
        self._resampler = (
            None if internal_sample_rate == external_sample_rate
            else StreamingResampler(internal_sample_rate, external_sample_rate)
        )
        self._leftover = np.zeros(0, np.int16)

    def get_internal_num_samples_to_generate(self, num_external: int) -> int:
        """Internal samples needed to serve `num_external` after leftovers
        (reference: lyra/buffered_resampler.cc:92-105, same f32 ceil math —
        the single multiply-then-divide of dsp_utils.convert_num_samples,
        not a two-step rounding)."""
        if num_external <= self._leftover.size:
            return 0
        needed = num_external - self._leftover.size
        return dsp_utils.convert_num_samples(
            needed, self._external_rate, self._internal_rate)

    def filter_and_buffer(
        self,
        sample_generator: Callable[[int], Optional[np.ndarray]],
        num_external_samples: int,
    ) -> Optional[np.ndarray]:
        internal_n = self.get_internal_num_samples_to_generate(num_external_samples)

        # Run the fallible generator BEFORE touching any buffered state: on
        # failure the leftovers (and FIR state) must survive intact so the
        # caller can retry without losing playout samples (reference:
        # lyra/buffered_resampler.cc:63-90 generates first, banks after).
        internal = sample_generator(internal_n)
        if internal is None:
            return None
        internal = np.asarray(internal, np.int16)
        if internal.size != internal_n:
            raise ValueError(
                f"generator returned {internal.size} samples, expected {internal_n}")

        external = (internal if self._resampler is None
                    else self._resampler.resample(internal))
        out = np.empty(num_external_samples, np.int16)
        used = min(self._leftover.size, num_external_samples)
        out[:used] = self._leftover[:used]
        to_copy = num_external_samples - used
        out[used:] = external[:to_copy]
        self._leftover = np.concatenate(
            [self._leftover[used:], external[to_copy:]])
        return out
