"""Codec constants and bitrate math — the port's copy of lyra_tpu/config.py.

Only the part the port uses, under the same names (the JAX package is the
reference: tests/test_torch_executor.py holds every public constant here
equal to its counterpart there).  Mirrors the non-configurable codec
contract of the reference implementation (reference:
lyra/lyra_config.{h,cc}), so packets are wire-compatible.
"""

from __future__ import annotations

import os

# Version contract (reference: lyra/lyra_config.cc:28-34).  The minor version
# must match the `identifier` varint stored in lyra_config.binarypb next to
# the weights; see `check_params_supported`.  Snapshots carry the whole
# version (utils/checkpoint.py).
VERSION_MAJOR = 1
VERSION_MINOR = 3
VERSION_MICRO = 2

NUM_FEATURES = 64  # learned SoundStream features per 20 ms frame
NUM_MEL_BINS = 160  # log-mel bins used by noise estimator / CNG
NUM_CHANNELS = 1
OVERLAP_FACTOR = 2
NUM_HEADER_BITS = 0
FRAME_RATE = 50  # frames (packets) per second

SUPPORTED_SAMPLE_RATES = (8000, 16000, 32000, 48000)
INTERNAL_SAMPLE_RATE = 16000

# Quantized bits per frame for the 3.2 / 6.0 / 9.2 kbps operating points
# (reference: lyra/lyra_config.cc:44-48).
SUPPORTED_QUANTIZED_BITS = (64, 120, 184)
MAX_NUM_QUANTIZED_BITS = 184

BITS_PER_QUANTIZER = 4  # measured from quantizer weights (encode output_1)
MAX_NUM_QUANTIZERS = MAX_NUM_QUANTIZED_BITS // BITS_PER_QUANTIZER  # 46

# Assets that must be present in a model directory.
ASSETS = ("quantizer.tflite", "lyragan.tflite", "soundstream_encoder.tflite")

# The engines' default model directory.  The JAX package falls back to a
# checkout of the reference next to it; the port takes the variable alone.
DEFAULT_MODEL_PATH = os.environ.get("LYRA_TPU_MODEL_PATH", "")


def num_samples_per_hop(sample_rate_hz: int) -> int:
    """Samples in one 20 ms hop at `sample_rate_hz` (must divide evenly)."""
    if sample_rate_hz % FRAME_RATE != 0:
        raise ValueError(f"sample rate {sample_rate_hz} not divisible by {FRAME_RATE}")
    return sample_rate_hz // FRAME_RATE


def packet_size(num_quantized_bits: int) -> int:
    """Bytes needed for a packet with `num_quantized_bits` payload bits."""
    return -(-(num_quantized_bits + NUM_HEADER_BITS) // 8)


def bitrate_to_packet_size(bitrate: int) -> int:
    return -(-bitrate // (FRAME_RATE * 8))


def bitrate(num_quantized_bits: int) -> int:
    return packet_size(num_quantized_bits) * 8 * FRAME_RATE


SUPPORTED_BITRATES = tuple(bitrate(b) for b in SUPPORTED_QUANTIZED_BITS)


def is_sample_rate_supported(sample_rate_hz: int) -> bool:
    return sample_rate_hz in SUPPORTED_SAMPLE_RATES


def packet_size_to_num_quantized_bits(size: int) -> int:
    """Packet size in bytes → quantized bits, or -1 if unrecognized.

    The packet size *is* the bitrate signal on the wire (reference:
    lyra/lyra_config.h:99-107).
    """
    for bits in SUPPORTED_QUANTIZED_BITS:
        if size == packet_size(bits):
            return bits
    return -1


def bitrate_to_num_quantized_bits(rate: int) -> int:
    for bits in SUPPORTED_QUANTIZED_BITS:
        if rate == bitrate(bits):
            return bits
    return -1


def _parse_identifier_varint(blob: bytes) -> int:
    """Parse field 1 (varint `identifier`) of the LyraConfig proto.

    The proto has a single int32 field (reference: lyra/lyra_config.proto:21-24)
    so a tiny hand-rolled parse avoids a protobuf dependency.
    """
    i = 0
    while i < len(blob):
        tag = blob[i]
        i += 1
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, shift = 0, 0
            while True:
                b = blob[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if field == 1:
                return val
        elif wire == 2:  # length-delimited: skip
            ln, shift = 0, 0
            while True:
                b = blob[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            i += ln
        elif wire == 5:
            i += 4
        elif wire == 1:
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return 0


def check_params_supported(
    sample_rate_hz: int, num_channels: int, model_path: str
) -> None:
    """Validate codec parameters and weight-directory compatibility.

    Raises ValueError on any unsupported parameter, mirroring the reference's
    AreParamsSupported gate (reference: lyra/lyra_config.h:119-168).
    """
    if not is_sample_rate_supported(sample_rate_hz):
        raise ValueError(f"Sample rate {sample_rate_hz} Hz is not supported by codec.")
    if num_channels != NUM_CHANNELS:
        raise ValueError(
            f"Number of channels {num_channels} is not supported by codec. "
            f"It needs to be {NUM_CHANNELS}."
        )
    for asset in ASSETS:
        p = os.path.join(model_path, asset)
        if not os.path.exists(p):
            raise ValueError(f"Asset {asset} does not exist in {model_path}.")
    config_path = os.path.join(model_path, "lyra_config.binarypb")
    identifier = 0
    if os.path.exists(config_path):
        with open(config_path, "rb") as f:
            identifier = _parse_identifier_varint(f.read())
    if identifier != VERSION_MINOR:
        raise ValueError(
            f"Weights identifier ({identifier}) is not compatible with code "
            f"identifier ({VERSION_MINOR})."
        )


def version_string() -> str:
    return f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_MICRO}"
