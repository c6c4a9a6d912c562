# Frozen copy of lyra_tpu_torch/dsp/resampler.py at commit d33c86f8529266b8cfd7b29e220ae5f0401d98aa, for the
# benchmark's plain reference; only the imports differ.
"""Rational polyphase resampler (streaming, batched) — port of
lyra_tpu/dsp/resampler.py.

Kaiser-windowed-sinc polyphase filtering with a kernel radius of 17 input
samples, cutoff at 0.9 of the lower Nyquist, and fully-primed reset
semantics (2·radius input samples of latency): the JAX package's filter,
whose taps `design_polyphase_taps` computes here with the same numpy code
(the JAX module imports jax, so it is copied, not imported).

`Resampler.resample` runs pure up and down ratios (every supported rate
against 16 kHz) as one strided `conv1d` over the `[B, T]` block, as the JAX
package runs them through `lax.conv_general_dilated`; other ratios take
the general polyphase gather, which is also the conv path's test oracle.
The conv runs with cuDNN's TF32 off, whatever the global flag says: TF32
keeps about three decimal digits, tens of LSB at int16 scale.

`resample_np` / `resample_stream_np` and `StreamingResampler` are the
single-stream numpy paths for host-side use, as in the JAX package.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import dsp_utils as utils
from torch import device as resolve

KERNEL_RADIUS_INPUT_SAMPLES = 17
CUTOFF_PROPORTION = 0.9
KAISER_BETA = 5.658


def _kaiser(tau: np.ndarray, radius: float, beta: float) -> np.ndarray:
    x = np.clip(tau / radius, -1.0, 1.0)
    return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta)


def design_polyphase_taps(up: int, down: int) -> np.ndarray:
    """Taps [up, 2R+1] for phases p: y[n] uses input window at offset
    floor(n*down/up) with fractional shift (n*down mod up)/up."""
    radius = KERNEL_RADIUS_INPUT_SAMPLES
    # cutoff in cycles/input-sample: 0.45 for upsampling, 0.45*up/down for
    # downsampling (anti-aliasing at the output Nyquist).
    cutoff = 0.5 * CUTOFF_PROPORTION * min(1.0, up / down)
    j = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.zeros((up, 2 * radius + 1), np.float64)
    for p in range(up):
        frac = p / up
        tau = j - frac  # kernel sample positions relative to window start
        h = 2 * cutoff * np.sinc(2 * cutoff * tau) * _kaiser(tau, radius + 1.0, KAISER_BETA)
        taps[p] = h / h.sum()  # unit DC gain per phase
    return taps.astype(np.float32)


class Resampler:
    """Streaming rational resampler over a stream batch on `device`.

    State is the trailing 2·R input samples per stream, `[B, 2R]` float32
    (zeros = fully primed reset), the JAX package's state leaf.
    """

    def __init__(self, input_rate: int, target_rate: int, device=None):
        if input_rate <= 0 or target_rate <= 0:
            raise ValueError("rates must be positive")
        self.input_rate = input_rate
        self.target_rate = target_rate
        frac = Fraction(target_rate, input_rate)
        self.up, self.down = frac.numerator, frac.denominator
        self._taps = design_polyphase_taps(self.up, self.down)  # [L, K]
        self.radius = KERNEL_RADIUS_INPUT_SAMPLES
        self._hist = 2 * self.radius
        self.device = resolve(device)
        self.taps = torch.tensor(self._taps, device=self.device)
        # The gather path's window index and phase per output count, made
        # on the host once (a per-call host→device copy cannot be captured
        # in a CUDA graph): the 20 ms hop's here, any other on first use.
        self._gather = {}
        if not (self.up == 1 or self.down == 1) and input_rate % 50 == 0:
            self._gather_index(self.output_length(input_rate // 50))

    @property
    def identity(self) -> bool:
        return self.up == 1 and self.down == 1

    def samples_until_steady_state(self) -> int:
        """2·radius input samples expressed at the output rate (the
        reference API's value; the filter's group delay is radius)."""
        return int(2.0 * self.radius * self.target_rate / self.input_rate)

    def init_state(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((batch_size, self._hist), dtype=torch.float32,
                           device=self.device)

    def output_length(self, num_input: int) -> int:
        n = num_input * self.up
        if n % self.down != 0:
            raise ValueError(
                f"block of {num_input} samples not aligned to ratio "
                f"{self.up}/{self.down}"
            )
        return n // self.down

    def resample(self, state: torch.Tensor, x: torch.Tensor):
        """x [B, n_in] float samples → ([B, n_out], new_state)."""
        b, n_in = x.shape
        n_out = self.output_length(n_in)
        ext = torch.cat([state, x.float()], dim=1)
        new_state = ext[:, -self._hist:]
        if self.up == 1 or self.down == 1:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                out = F.conv1d(ext[:, None, :], self.taps[:, None, :],
                               stride=self.down if self.up == 1 else 1)
            if self.up == 1:
                return out[:, 0, :n_out], new_state
            m = n_out // self.up  # phase p of window m lands at m*up + p
            return out[:, :, :m].transpose(1, 2).reshape(b, n_out), new_state
        return self.resample_gather(ext, n_out), new_state

    def resample_gather(self, ext: torch.Tensor, n_out: int) -> torch.Tensor:
        """General-ratio polyphase gather over ext = [state, x]: explicit
        [B, n_out, K] windows times each output's phase taps."""
        idx, taps = self._gather_index(n_out)
        return torch.einsum("bnk,nk->bn", ext[:, idx], taps)

    def _gather_index(self, n_out: int):
        """([n_out, K] window index into ext, [n_out, K] phase taps)."""
        if n_out not in self._gather:
            n = np.arange(n_out)
            offs = (n * self.down) // self.up  # window start in ext coords
            phase = torch.as_tensor((n * self.down) % self.up,
                                    device=self.device)
            idx = torch.as_tensor(
                offs[:, None] + np.arange(self._taps.shape[1])[None, :],
                device=self.device)
            self._gather[n_out] = (idx, self.taps[phase])
        return self._gather[n_out]

    def resample_np(self, x: np.ndarray) -> np.ndarray:
        """Single-shot numpy path for host-side use (stateless, primed)."""
        state = np.zeros(self._hist, np.float32)
        y, _ = self.resample_stream_np(state, np.asarray(x, np.float32))
        return y

    def resample_stream_np(self, state: np.ndarray, x: np.ndarray):
        """Host-side streaming resample of one variable-length block, one
        stream, numpy.  state: [2R] trailing input samples; returns
        (y [n_out], new_state)."""
        x = np.asarray(x, np.float32)
        n_out = self.output_length(x.shape[0])
        ext = np.concatenate([state, x])
        new_state = ext[-self._hist:].copy()
        if n_out == 0:
            return np.zeros(0, np.float32), new_state
        n = np.arange(n_out)
        offs = (n * self.down) // self.up
        phase = (n * self.down) % self.up
        taps = self._taps[phase]  # [n_out, K]
        idx = offs[:, None] + np.arange(self._taps.shape[1])[None, :]
        y = np.einsum("nk,nk->n", ext[idx], taps).astype(np.float32)
        return y, new_state


class StreamingResampler:
    """Push-style single-stream facade over `Resampler` (host-side):
    int16 in and out with clipping, carried FIR state, primed `reset`."""

    def __init__(self, input_rate: int, target_rate: int):
        self._r = Resampler(input_rate, target_rate, device="cpu")  # numpy only
        self._state = np.zeros(self._r._hist, np.float32)

    def reset(self):
        self._state[:] = 0.0

    def samples_until_steady_state(self) -> int:
        return self._r.samples_until_steady_state()

    def resample(self, audio: np.ndarray) -> np.ndarray:
        if self._r.identity:
            return np.asarray(audio, np.int16)
        y, self._state = self._r.resample_stream_np(
            self._state, np.asarray(audio, np.float32))
        return utils.clip_to_int16_np(y)
