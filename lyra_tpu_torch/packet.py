"""Device-side wire codec (port of the torch-free half of lyra_tpu/packet.py).

Every supported bitrate's packet is whole 4-bit stages with no header and
no padding, so the wire format is an MSB-first nibble interleave: byte i =
stage[2i] << 4 | stage[2i + 1].  These run on the tensors' device; the host
codecs (`pack_indices_batch` and friends) are not ported yet.

As in the JAX package, out-of-range values in the packed region wrap to
their low nibble (−1 packs as 0xF) instead of raising: a check would need
a device→host sync every tick.
"""

from __future__ import annotations

import torch

from lyra_tpu_torch import config


def _nibble_stages(num_bits: int) -> int:
    if config.BITS_PER_QUANTIZER != 4 or num_bits % 8:
        raise ValueError("device wire codec requires whole-byte 4-bit stages")
    return num_bits // config.BITS_PER_QUANTIZER


def _interleave(idx: torch.Tensor) -> torch.Tensor:
    hi = (idx[:, 0::2] & 0xF) << 4
    return (hi | (idx[:, 1::2] & 0xF)).to(torch.uint8)


def pack_wire_device(indices: torch.Tensor, num_bits: int) -> torch.Tensor:
    """[B, >=n_stages] int stage indices → [B, packet_size] uint8 wire bytes."""
    n_stages = _nibble_stages(num_bits)
    return _interleave(indices[:, :n_stages].to(torch.int32))


def unpack_wire_device(packets: torch.Tensor, num_bits: int) -> torch.Tensor:
    """[B, packet_size] uint8 wire bytes → [B, n_stages] int32 indices."""
    _nibble_stages(num_bits)
    b = packets.to(torch.int32)
    return torch.stack([b >> 4, b & 0xF], dim=-1).reshape(b.shape[0], -1)


def pack_wire_device_mixed(indices: torch.Tensor, nq_row: torch.Tensor,
                           max_num_bits: int) -> torch.Tensor:
    """Per-row stage counts `nq_row` [B] → [B, packet_size(max_num_bits)]
    uint8; row i's first packet_size(nq_row[i]·4) bytes are its own-rate
    packet, the rest zero."""
    n_stages = _nibble_stages(max_num_bits)
    stage = torch.arange(n_stages, device=indices.device)
    idx = indices[:, :n_stages].to(torch.int32)
    idx = torch.where(stage[None, :] < nq_row[:, None], idx,
                      torch.zeros_like(idx))
    return _interleave(idx)


def unpack_wire_device_mixed(packets: torch.Tensor,
                             nq_row: torch.Tensor) -> torch.Tensor:
    """[B, max_size] uint8 + [B] stage counts → [B, 2·max_size] int32
    indices, −1 beyond each row's own stages."""
    idx = unpack_wire_device(packets, packets.shape[1] * 8)
    stage = torch.arange(idx.shape[1], device=idx.device)
    return torch.where(stage[None, :] < nq_row[:, None], idx,
                       torch.full_like(idx, -1))
