"""Single-stream LyraEncoder facade with the reference API surface — port
of lyra_tpu/codec/encoder.py.

API parity target: `LyraEncoder::Create / Encode / set_bitrate`
(reference: lyra/lyra_encoder.{h,cc}).  Wraps the batched EncoderEngine at
batch size 1: resample → (DTX gate) → SoundStream → RVQ run as one
CUDA-graph replay per 20 ms hop on the card (the engine's step, whose
indices and DTX flag come back to the host in one copy), eagerly on the
CPU; index→byte packing is host-side.  The bitrate is an input of the
replay, not part of its key, so `set_bitrate` never captures anew.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import EncoderEngine


class LyraEncoder:
    def __init__(self, sample_rate_hz: int, num_channels: int = 1,
                 bitrate: int = 3200, enable_dtx: bool = False,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 mode: str = "float", *, device=None):
        if num_channels != config.NUM_CHANNELS:
            raise ValueError(f"unsupported channel count {num_channels}")
        bits = config.bitrate_to_num_quantized_bits(bitrate)
        if bits < 0:
            raise ValueError(f"Bitrate {bitrate} bps is not supported by codec.")
        self._engine = EncoderEngine(
            sample_rate_hz, model_path, enable_dtx=enable_dtx, mode=mode,
            device=device)
        self._state = self._engine.init_state(1)
        self._num_quantized_bits = bits
        self._num_channels = num_channels

    def _encode_hop(self, state, audio, num_quantizers):
        """The engine's step with its outputs in one row: the stage
        indices, then is_noise as 0 / 1."""
        indices, is_noise, state = self._engine._step_impl(
            state, audio, num_quantizers)
        return torch.cat([indices, is_noise.to(torch.int32)[:, None]], 1), state

    def encode(self, audio: np.ndarray) -> Optional[bytes]:
        """One 20 ms hop of int16 samples → wire packet bytes.

        Returns b"" for DTX-suppressed noise hops (the reference's empty
        packet, lyra/lyra_encoder.cc:136-140) and None on invalid input.
        """
        audio = np.asarray(audio)
        if audio.shape != (self._engine.hop_samples,):
            return None
        nq = self._num_quantized_bits // config.BITS_PER_QUANTIZER
        row, self._state = self._engine._run(
            self._encode_hop, "encode", self._state,
            audio.astype(np.float32)[None], np.array([nq], np.int32))
        row = row[0].cpu().numpy()
        if row[-1]:
            return b""
        return packet.pack_indices(row[:-1], self._num_quantized_bits)

    def set_bitrate(self, bitrate: int) -> bool:
        bits = config.bitrate_to_num_quantized_bits(bitrate)
        if bits < 0:
            return False
        self._num_quantized_bits = bits
        return True

    @property
    def sample_rate_hz(self) -> int:
        return self._engine.sample_rate_hz

    @property
    def num_channels(self) -> int:
        return self._num_channels

    @property
    def bitrate(self) -> int:
        return config.bitrate(self._num_quantized_bits)

    @property
    def frame_rate(self) -> int:
        return config.FRAME_RATE
