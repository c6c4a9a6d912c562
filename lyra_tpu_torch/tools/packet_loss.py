"""Packet-loss simulators for fault-injection in the decode path — the
port's copy of lyra_tpu/tools/packet_loss.py.

Behavioral parity with the reference's two models:

* GilbertModel (reference: lyra/gilbert_model.{h,cc}) — 2-state Markov
  chain parameterized by overall loss rate and mean burst length; the state
  transition probabilities are
      received->lost: rate / (burst * (1 - rate))
      lost->received: 1 / burst
  with a fixed default seed so runs are reproducible.
* FixedPacketLossModel (reference: lyra/fixed_packet_loss_model.{h,cc}) —
  deterministic loss intervals from (start, duration) second pairs, with
  burst edges rounded up to packet boundaries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np


class GilbertModel:
    def __init__(self, received_to_lost: float, lost_to_received: float,
                 seed: int):
        self._p_rl = received_to_lost
        self._p_lr = lost_to_received
        self._received = True
        self._rng = np.random.RandomState(seed)

    @classmethod
    def create(cls, packet_loss_rate: float, average_burst_length: float,
               seed: int = 5489) -> Optional["GilbertModel"]:
        if average_burst_length < 1.0 or packet_loss_rate < 0.0:
            return None
        if packet_loss_rate > average_burst_length / (average_burst_length + 1.0):
            return None
        return cls(
            packet_loss_rate / (average_burst_length * (1.0 - packet_loss_rate)),
            1.0 / average_burst_length,
            seed,
        )

    def is_packet_received(self) -> bool:
        current = self._received
        if self._received:
            if self._rng.uniform() < self._p_rl:
                self._received = False
        elif self._rng.uniform() < self._p_lr:
            self._received = True
        return current


class FixedPacketLossModel:
    def __init__(self, sample_rate_hz: int, num_samples_per_hop: int,
                 burst_starts_seconds: Sequence[float],
                 burst_durations_seconds: Sequence[float]):
        self._intervals = [
            (
                int(math.ceil(sample_rate_hz * start / num_samples_per_hop)),
                int(math.ceil(sample_rate_hz * (start + dur) / num_samples_per_hop)),
            )
            for start, dur in zip(burst_starts_seconds, burst_durations_seconds)
        ]
        self._packet_index = 0

    def is_packet_received(self) -> bool:
        i = self._packet_index
        self._packet_index += 1
        return not any(lo <= i < hi for lo, hi in self._intervals)


@dataclasses.dataclass
class PacketLossPattern:
    """Paired burst start/duration lists, parsed from the CLI flag syntax
    `s1,s2,...:d1,d2,...` (reference: lyra/cli_example/decoder_main_lib.cc:47-84)."""

    starts: List[float]
    durations: List[float]

    @classmethod
    def parse(cls, text: str) -> "PacketLossPattern":
        text = text.strip()
        if not text:
            return cls([], [])
        parts = text.split(":")
        if len(parts) != 2:
            raise ValueError(
                f"expected 'starts:durations' with comma-separated floats, got {text!r}")
        starts = [float(v) for v in parts[0].split(",") if v]
        durations = [float(v) for v in parts[1].split(",") if v]
        if len(starts) != len(durations):
            raise ValueError("starts and durations must have equal length")
        return cls(starts, durations)

    def __str__(self) -> str:
        return (",".join(str(v) for v in self.starts) + ":" +
                ",".join(str(v) for v in self.durations))
