"""The pool path: a mix that gives `rates` (portbench/traffic.py) is served
by a pair of lyra_tpu_torch ServerPools (tools/stream_server.py), as a
host serving a mixed fleet runs them.

One engine pair per rate (the configuration's `engines`), in its mode on
its backend; one EncoderServer and one DecoderServer per wave, each
wave's on its rate's engines; the waves in the mix's layout order, so a
pool row is a slot of one wave.  At set-up every rate's streams are
admitted on both pools at once (balanced over the rate's waves), each at
the bitrate the traffic draws for it.  At a churn event the harness ends
a stream on both pools (`remove_stream`) and admits its replacement at
once (`add_stream`, the admission's `reset_rows` replay on each side),
before the tick's PCM is submitted.

The fleet keeps the harness's own record of who holds each row: `owner`
(the tenure, one per admission, whose id is its stream id; −1 where the
row is empty), `gen` (admissions on the row so far) and `bits` (the
owner's quantized bits).  The comparison (portbench/compare.py) reads
them: a server drains a slot that changed hands between a tick's submit
and its drain as empty (size 0, silence), and the reference follows each
tenure from a fresh state at its admission.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from portbench import spec
from portbench.traffic import Traffic, bitrate_of, bits_of


@dataclasses.dataclass
class Tenure:
    row: int  # the pool's row
    rate: int  # Hz
    bits: int  # quantized bits a packet
    admitted: int  # the tick before whose submit it was admitted


class Fleet:
    def __init__(self, cfg: dict, traffic: Traffic, device, engine_kwargs):
        from lyra_tpu_torch.tools.stream_server import (
            DecoderServer, EncoderServer, ServerPool)

        self.traffic, self.layout = traffic, traffic.layout
        lay = self.layout
        rates = sorted(set(lay.wave_rates))
        encs = {r: spec.engine(cfg, "encoder", r, device, engine_kwargs)
                for r in rates}
        decs = {r: spec.engine(cfg, "decoder", r, device, engine_kwargs)
                for r in rates}
        # A row admitted bare sends the mix's most common bitrate.
        bare = int(traffic.bitrates[np.argmax(traffic.bitrate_shares)])
        self.enc = ServerPool([
            EncoderServer(lay.capacity, engine=encs[r], bitrate=bare)
            for r in lay.wave_rates])
        self.dec = ServerPool([DecoderServer(lay.capacity, engine=decs[r])
                               for r in lay.wave_rates])
        n = lay.slots
        self.owner = np.full(n, -1, np.int64)
        self.gen = np.zeros(n, np.int64)
        self.bits = np.zeros(n, np.int64)
        self.tenures: List[Tenure] = []
        self.events = 0  # churn events so far
        self.ended_bad_packets = 0  # the decoder's count of ended streams
        for rate in rates:
            bitrates = traffic.setup_bitrates(rate)
            ids = range(len(self.tenures), len(self.tenures) + len(bitrates))
            rows = self.enc.add_streams(ids, sample_rate_hz=rate)
            if self.dec.add_streams(ids, sample_rate_hz=rate) != rows:
                raise RuntimeError("the pools placed a stream apart")
            for sid, bitrate in zip(ids, bitrates):
                if bitrate != bare:
                    self.enc.set_bitrate(sid, int(bitrate))
                self._admitted(sid, rows[sid], rate, int(bitrate), 0)

    def _admitted(self, sid, row, rate, bitrate, t) -> None:
        bits = bits_of(bitrate, self.traffic.hop_ms)
        self.tenures.append(Tenure(row, rate, bits, t))
        self.owner[row] = sid
        self.gen[row] += 1
        self.bits[row] = bits

    def churn(self, t: int, setup: bool = False) -> None:
        """Tick t's churn events; with `setup`, two more on every wave (the
        warm-up's: each server's admission program then runs from both of
        its state trees)."""
        events = self.traffic.churn(t)
        if setup:
            waves = [w for w in range(len(self.layout.wave_rates))
                     for _ in range(2)]
            events += self.traffic.churn(t, waves)
        cap = self.layout.capacity
        for w, u, bitrate in events:
            active = np.flatnonzero(self.owner[w * cap:(w + 1) * cap] >= 0)
            row = w * cap + int(active[int(u * active.size)])
            old = int(self.owner[row])
            self.ended_bad_packets += int(
                self.dec.servers[w].bad_packets[row - w * cap])
            self.enc.remove_stream(old)
            self.dec.remove_stream(old)
            self.owner[row] = -1
            self.bits[row] = 0
            sid = len(self.tenures)
            rate = self.layout.wave_rates[w]
            new = self.enc.add_stream(sid, sample_rate_hz=rate,
                                      bitrate=bitrate)
            if self.dec.add_stream(sid, sample_rate_hz=rate) != new:
                raise RuntimeError("the pools placed a stream apart")
            self._admitted(sid, new, rate, bitrate, t)
            self.events += 1

    def admitted_bits(self) -> np.ndarray:
        """The quantized bits of every admitted row."""
        return self.bits[self.owner >= 0]

    def summary(self) -> str:
        """The admitted rows by rate and by bitrate (one line)."""
        on = self.owner >= 0
        rates = self.layout.row_rates()[on]
        by_rate = {int(r): int((rates == r).sum()) for r in np.unique(rates)}
        by_bits = {bitrate_of(b, self.traffic.hop_ms):
                   int((self.bits[on] == b).sum())
                   for b in np.unique(self.bits[on])}
        return (f"admitted rows {int(on.sum())} of {on.size}: by rate (Hz) "
                f"{by_rate}, by bitrate (bit/s) {by_bits}")

    def close(self) -> None:
        """Drop the pools (their device state); the record stays."""
        self.enc = self.dec = None

