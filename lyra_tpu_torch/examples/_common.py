"""What the port's examples share: the model directory flag, the input
signal (a wav, or a seeded stand-in for speech), a free UDP port, and the
rule for running `serve_main` in a thread of the same process."""

from __future__ import annotations

import contextlib
import gc
import socket

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.utils import wav


def add_model_flag(p) -> None:
    p.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH,
                   help="Directory of the model weights (default: "
                        "$LYRA_TPU_MODEL_PATH).")


def check_model_flag(p, args) -> None:
    if not args.model_path:
        p.error("no model directory: pass --model_path or set "
                "LYRA_TPU_MODEL_PATH")


def test_signal(rate: int, seconds: float, seed: int = 0) -> np.ndarray:
    """A seeded stand-in for speech at `rate`: a voiced source (a pitch
    gliding between 100 and 220 Hz with eight harmonics) under a 4 Hz
    syllable envelope, over low noise — int16 at speech level."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f0 = 160 + 60 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voice = sum(np.sin(k * phase) / k for k in range(1, 9))
    syllables = np.clip(np.sin(2 * np.pi * 4 * t + rng.uniform(0, 6)), 0, 1)
    x = 6000 * syllables * voice / 2 + rng.normal(0, 60, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def read_input(path, seconds: float, seed: int = 0) -> wav.WavData:
    """The wav at `path`, or without one `seconds` of `test_signal` at
    16 kHz."""
    if path:
        return wav.read_wav_int16(path)
    rate = config.INTERNAL_SAMPLE_RATE
    return wav.WavData(test_signal(rate, seconds, seed), 1, rate)


def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def card_to_thread():
    """While a `serve_main` thread of this process runs: it captures its
    CUDA graphs in global capture mode, so this thread must leave the
    card alone (sockets and host code only) and no collection may free
    CUDA objects meanwhile."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
