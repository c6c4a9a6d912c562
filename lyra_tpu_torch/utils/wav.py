"""16-bit WAV read/write (reference: lyra/wav_utils.{h,cc}) — the port's
copy of lyra_tpu/utils/wav.py.

Stdlib `wave` based; no external audio dependency.  Returns int16 samples
interleaved if multi-channel, matching the reference's ReadWavResult.
"""

from __future__ import annotations

import dataclasses
import wave

import numpy as np


@dataclasses.dataclass
class WavData:
    samples: np.ndarray  # int16, interleaved [num_frames * channels]
    num_channels: int
    sample_rate_hz: int


def read_wav_int16(path: str) -> WavData:
    try:
        with wave.open(path, "rb") as f:
            if f.getsampwidth() != 2:
                raise ValueError(
                    f"{path}: expected 16-bit wav, got {8 * f.getsampwidth()}-bit")
            data = f.readframes(f.getnframes())
            samples = np.frombuffer(data, dtype="<i2")
            return WavData(
                samples=samples,
                num_channels=f.getnchannels(),
                sample_rate_hz=f.getframerate(),
            )
    except wave.Error as e:
        raise ValueError(f"{path}: not a valid wav file ({e})") from e


def write_wav_int16(path: str, samples: np.ndarray, sample_rate_hz: int,
                    num_channels: int = 1) -> None:
    samples = np.asarray(samples, dtype="<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(num_channels)
        f.setsampwidth(2)
        f.setframerate(sample_rate_hz)
        f.writeframes(samples.tobytes())
