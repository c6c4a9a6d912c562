"""Wire-format packets — the port's copy of lyra_tpu/packet.py.

Bit layout parity with the reference (reference: lyra/packet.h:91-146 and
lyra/residual_vector_quantizer.cc:101-157): a frame's RVQ stage indices
are laid out MSB-first — the first quantizer stage in the most
significant bits — and packed into ceil(bits/8) bytes, unused bits low in
the last byte.  No header (NUM_HEADER_BITS == 0): the packet size alone
signals the bitrate.

Three families, under the JAX package's names:
  * host codecs on numpy: the scalar path (`pack_indices`,
    `unpack_indices` and the bit-string helpers) and the batch path
    (`pack_indices_batch{,_np}`, `unpack_indices_batch{,_np}`).  The JAX
    package runs its batch codecs through the native library when it is
    built; in the port both names are the numpy versions until the
    `native/` facade is ported;
  * RED framing for the transport (`build_red`, `parse_red`,
    `build_red_batch`);
  * the device wire codec on torch tensors.  Every supported bitrate's
    packet is whole 4-bit stages with no header and no padding, so the
    wire format is an MSB-first nibble interleave: byte i = stage[2i] << 4
    | stage[2i + 1].  As in the JAX package, out-of-range values in the
    packed region wrap to their low nibble (−1 packs as 0xF) instead of
    raising: a check would need a device→host sync every tick.
"""

from __future__ import annotations

import numpy as np
import torch

from lyra_tpu_torch import config


def indices_to_bitstring(indices, bits_per_stage: int = config.BITS_PER_QUANTIZER) -> str:
    """RVQ stage indices → '0'/'1' string, first stage in the MSBs."""
    out = []
    for idx in indices:
        idx = int(idx)
        if idx < 0 or idx >= (1 << bits_per_stage):
            raise ValueError(f"index {idx} out of range for {bits_per_stage} bits")
        out.append(format(idx, f"0{bits_per_stage}b"))
    return "".join(out)


def bitstring_to_indices(bits: str, bits_per_stage: int = config.BITS_PER_QUANTIZER):
    if len(bits) % bits_per_stage != 0:
        raise ValueError(
            f"bitstring length {len(bits)} not divisible by {bits_per_stage}"
        )
    n = len(bits) // bits_per_stage
    return np.array(
        [int(bits[i * bits_per_stage : (i + 1) * bits_per_stage], 2) for i in range(n)],
        dtype=np.int32,
    )


def pack_bitstring(bits: str) -> bytes:
    """'0'/'1' string → bytes, MSB-first, zero-padded at the tail."""
    n_bytes = -(-len(bits) // 8)
    padded = bits.ljust(n_bytes * 8, "0")
    return int(padded, 2).to_bytes(n_bytes, "big") if bits else b""


def unpack_bitstring(packet: bytes, num_bits: int) -> str:
    if len(packet) != -(-num_bits // 8):
        raise ValueError(f"Packet of unexpected length: {len(packet)}")
    as_int = int.from_bytes(packet, "big")
    total = len(packet) * 8
    return format(as_int, f"0{total}b")[:num_bits]


def pack_indices(indices, num_bits: int) -> bytes:
    """Stage indices for one frame → wire packet bytes."""
    n_stages = num_bits // config.BITS_PER_QUANTIZER
    if len(indices) < n_stages:
        raise ValueError(
            f"{len(indices)} stage indices cannot fill {num_bits} bits "
            f"({n_stages} stages)")
    return pack_bitstring(indices_to_bitstring(indices[:n_stages]))


def unpack_indices(packet: bytes) -> np.ndarray:
    """Wire packet → stage indices; bitrate inferred from packet size."""
    num_bits = config.packet_size_to_num_quantized_bits(len(packet))
    if num_bits < 0:
        raise ValueError(f"unrecognized packet size {len(packet)}")
    return bitstring_to_indices(unpack_bitstring(bytes(packet), num_bits))


def pack_indices_batch(indices: np.ndarray, num_bits: int) -> np.ndarray:
    """[B, n_stages] int32 stage indices → [B, packet_size] uint8 packets
    (the numpy codec; see the module docstring)."""
    return pack_indices_batch_np(indices, num_bits)


def unpack_indices_batch(packets: np.ndarray, num_bits: int) -> np.ndarray:
    """[B, packet_size] uint8 → [B, n_stages] int32 stage indices (the
    numpy codec; see the module docstring)."""
    return unpack_indices_batch_np(packets, num_bits)


def pack_indices_batch_np(indices: np.ndarray, num_bits: int) -> np.ndarray:
    """[B, n_stages] int32 stage indices → [B, packet_size] uint8 packets.

    Vectorized numpy equivalent of per-frame pack_indices.
    """
    bps = config.BITS_PER_QUANTIZER
    n_stages = num_bits // bps
    indices = np.asarray(indices)
    if indices.shape[1] < n_stages:
        # Silently clamping would emit wrong-size packets the decoder
        # counts as drops, with no error at the sender.
        raise ValueError(
            f"indices have {indices.shape[1]} stages, need {n_stages} "
            f"for {num_bits} bits")
    used = indices[:, :n_stages]
    if used.min(initial=0) < 0 or used.max(initial=0) >= (1 << bps):
        raise ValueError(
            f"stage index out of range for {bps} bits in packed batch")
    idx = used.astype(np.uint8)
    # Expand each stage index into its bits, MSB of stage first.
    shifts = np.arange(bps - 1, -1, -1, dtype=np.uint8)
    bits = (idx[:, :, None] >> shifts[None, None, :]) & 1  # [B, n_stages, bps]
    bits = bits.reshape(idx.shape[0], n_stages * bps)
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits, axis=1)


def unpack_indices_batch_np(packets: np.ndarray, num_bits: int) -> np.ndarray:
    """[B, packet_size] uint8 → [B, n_stages] int32 stage indices."""
    bps = config.BITS_PER_QUANTIZER
    n_stages = num_bits // bps
    bits = np.unpackbits(np.asarray(packets, dtype=np.uint8), axis=1)[:, :num_bits]
    bits = bits.reshape(-1, n_stages, bps)
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.int32)
    return (bits.astype(np.int32) * weights[None, None, :]).sum(-1)


def build_red(cur: bytes, prev: bytes = b"") -> bytes:
    """RED wire framing for one datagram: [1B len][cur][1B len][prev].

    A datagram for sequence t carries packet t-D alongside (D = the
    fleet's redundancy distance), so one lost datagram is healed by its
    successor's redundant copy instead of concealed.  `prev` may be empty
    (stream start).  Zero-length blocks are valid: a DTX empty packet is
    "received, no payload" on the wire (reference:
    lyra/lyra_encoder.cc:136-141)."""
    if len(cur) > 255 or len(prev) > 255:
        raise ValueError("RED block exceeds the 1-byte length prefix")
    return bytes([len(cur)]) + cur + bytes([len(prev)]) + prev


def parse_red(payload: bytes) -> tuple[bytes, bytes]:
    """Inverse of build_red; raises ValueError on a ragged payload (a
    short datagram is garbage, not a quieter packet)."""
    if len(payload) < 2:
        raise ValueError("RED payload shorter than its length prefixes")
    l1 = payload[0]
    if 2 + l1 > len(payload):
        raise ValueError("RED primary block overruns the payload")
    l2 = payload[1 + l1]
    if 2 + l1 + l2 != len(payload):
        raise ValueError("RED blocks do not tile the payload")
    return payload[1:1 + l1], payload[2 + l1:2 + l1 + l2]


def build_red_batch(cur: np.ndarray, cur_sizes: np.ndarray,
                    prev: np.ndarray, prev_sizes: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized RED framing for a serving tick's wire matrix.

    cur/prev: [B, max_size] u8 rows (row k's packet in the first
    cur_sizes[k]/prev_sizes[k] bytes); returns (red [B, 2 + 2*max_size]
    u8, red_sizes [B] = 2 + cur + prev).  Rows group by their (cur, prev)
    size pair — at most bitrates² distinct pairs — so the assembly is a
    handful of slice assignments, not a per-row loop."""
    cur = np.ascontiguousarray(cur, np.uint8)
    prev = np.ascontiguousarray(prev, np.uint8)
    cur_sizes = np.asarray(cur_sizes, np.int64)
    prev_sizes = np.asarray(prev_sizes, np.int64)
    b, max_size = cur.shape
    if prev.shape != cur.shape:
        raise ValueError(f"cur {cur.shape} / prev {prev.shape} mismatch")
    if cur_sizes.max(initial=0) > max_size or \
            prev_sizes.max(initial=0) > max_size:
        raise ValueError("a size exceeds the matrix row width")
    out = np.zeros((b, 2 + 2 * max_size), np.uint8)
    out_sizes = (2 + cur_sizes + prev_sizes).astype(np.int32)
    out[:, 0] = cur_sizes
    for s1 in np.unique(cur_sizes):
        rows = cur_sizes == s1
        out[rows, 1:1 + s1] = cur[rows, :s1]
        out[rows, 1 + s1] = prev_sizes[rows]
        for s2 in np.unique(prev_sizes[rows]):
            rr = rows & (prev_sizes == s2)
            out[rr, 2 + s1:2 + s1 + s2] = prev[rr, :s2]
    return out, out_sizes


# ---- device wire codec (torch) -------------------------------------------


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
