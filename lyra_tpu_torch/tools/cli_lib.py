"""File-level encode/decode drivers shared by the CLIs and tests — port
of lyra_tpu/tools/cli_lib.py; the codec runs on `device` (the card unless
the caller names another).

Behavior parity with the reference CLI libraries
(reference: lyra/cli_example/encoder_main_lib.cc:43-133,
lyra/cli_example/decoder_main_lib.cc:86-219): wav → frame loop → `.lyra`
concatenated packet stream, and `.lyra` → fixed-size packet slices →
optional loss model → decode loop (optionally with randomized request
sizes) → wav.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.codec.decoder import LyraDecoder
from lyra_tpu_torch.codec.encoder import LyraEncoder
from lyra_tpu_torch.codec.preprocessor import NoOpPreprocessor
from lyra_tpu_torch.tools.packet_loss import (
    FixedPacketLossModel,
    GilbertModel,
    PacketLossPattern,
)
from lyra_tpu_torch.utils import wav

log = logging.getLogger("lyra_tpu")


def encode_wav(samples: np.ndarray, num_channels: int, sample_rate_hz: int,
               bitrate: int, enable_preprocessing: bool, enable_dtx: bool,
               model_path: str, *, device=None) -> Optional[bytes]:
    """Frame loop over int16 samples → concatenated packet bytes."""
    try:
        encoder = LyraEncoder(sample_rate_hz, num_channels, bitrate,
                              enable_dtx=enable_dtx, model_path=model_path,
                              device=device)
    except ValueError as e:
        log.error("Could not create encoder: %s", e)
        return None

    data = np.asarray(samples, np.int16)
    if enable_preprocessing:
        data = NoOpPreprocessor().process(data, sample_rate_hz)

    start = time.monotonic()
    hop = sample_rate_hz // encoder.frame_rate
    out = bytearray()
    for i in range(0, len(data) - hop + 1, hop):
        pkt = encoder.encode(data[i:i + hop])
        if pkt is None:
            log.error("Unable to encode frame at sample %d.", i)
            return None
        out.extend(pkt)
    elapsed = time.monotonic() - start
    if elapsed > 0:
        log.info("Samples per second : %.1f", len(data) / elapsed)
    return bytes(out)


def encode_file(wav_path: str, output_path: str, bitrate: int,
                enable_preprocessing: bool, enable_dtx: bool,
                model_path: str, *, device=None) -> bool:
    try:
        data = wav.read_wav_int16(wav_path)
    except (OSError, ValueError, EOFError) as e:
        log.error("Could not read %s: %s", wav_path, e)
        return False
    encoded = encode_wav(data.samples, data.num_channels, data.sample_rate_hz,
                         bitrate, enable_preprocessing, enable_dtx, model_path,
                         device=device)
    if encoded is None:
        return False
    with open(output_path, "wb") as f:
        f.write(encoded)
    return True


def decode_features(packet_stream: bytes, packet_size: int,
                    randomize_num_samples_requested: bool,
                    decoder: LyraDecoder,
                    packet_loss_model=None,
                    rng: Optional[np.random.RandomState] = None) -> Optional[np.ndarray]:
    """Slice fixed-size packets, drop lost ones, pull decoded samples."""
    hop = config.num_samples_per_hop(decoder.sample_rate_hz)
    rng = rng or np.random.RandomState()
    out: List[np.ndarray] = []
    start = time.monotonic()
    for off in range(0, len(packet_stream), packet_size):
        encoded = packet_stream[off:off + packet_size]
        if packet_loss_model is None or packet_loss_model.is_packet_received():
            if not decoder.set_encoded_packet(encoded):
                log.error("Unable to set encoded packet at byte %d.", off)
                return None
        decoded_so_far = 0
        while decoded_so_far < hop:
            if randomize_num_samples_requested:
                n = min(int(rng.randint(1, hop + 1)), hop - decoded_so_far)
            else:
                n = hop
            decoded = decoder.decode_samples(n)
            if decoded is None:
                log.error("Unable to decode features at byte %d.", off)
                return None
            decoded_so_far += len(decoded)
            out.append(decoded)
    result = np.concatenate(out) if out else np.zeros(0, np.int16)
    elapsed = time.monotonic() - start
    if elapsed > 0:
        log.info("Samples per second : %.1f", len(result) / elapsed)
    return result


def decode_file(encoded_path: str, output_path: str, sample_rate_hz: int,
                bitrate: int, randomize_num_samples_requested: bool,
                packet_loss_rate: float, average_burst_length: float,
                fixed_packet_loss_pattern: PacketLossPattern,
                model_path: str, *, device=None) -> bool:
    try:
        decoder = LyraDecoder(sample_rate_hz, model_path=model_path,
                              device=device)
    except ValueError as e:
        log.error("Could not create decoder: %s", e)
        return False

    if fixed_packet_loss_pattern.starts:
        loss_model = FixedPacketLossModel(
            sample_rate_hz, config.num_samples_per_hop(sample_rate_hz),
            fixed_packet_loss_pattern.starts,
            fixed_packet_loss_pattern.durations)
    else:
        loss_model = GilbertModel.create(packet_loss_rate, average_burst_length)
        if loss_model is None:
            log.error("Could not create packet loss simulator model.")
            return False

    with open(encoded_path, "rb") as f:
        stream = f.read()
    if config.bitrate_to_num_quantized_bits(bitrate) < 0:
        log.error("Bitrate %d is not supported by codec.", bitrate)
        return False
    packet_size = config.bitrate_to_packet_size(bitrate)
    remainder = len(stream) % packet_size
    if remainder:
        log.warning("Trimming %d trailing bytes not forming a whole packet.",
                    remainder)
        stream = stream[:len(stream) - remainder]
    if not stream:
        log.error("File was empty or incomplete and truncated to empty size.")
        return False

    decoded = decode_features(stream, packet_size,
                              randomize_num_samples_requested, decoder,
                              loss_model)
    if decoded is None:
        return False
    wav.write_wav_int16(output_path, decoded, sample_rate_hz,
                        decoder.num_channels)
    return True
