"""The one traffic generator: a mix file's parameters → the PCM every
stream sends, the packets the network loses and, for a fleet, who comes
and goes, all from `--seed`.

A tick is one hop of every stream: the configuration's `hop_ms` of
audio, so a row's PCM is rate × hop samples and a packet carries bitrate
× hop bits.

A mix (portbench/traffic/<name>.json) gives (and may say in `source`
where its numbers come from, and which are assumed; it is not read):
  streams            B, the streams admitted at set-up;
  bits_per_packet    the encoder's rate for every stream (120 at a 20 ms
                     hop = 6 kbps);
  pool_ticks         ticks of PCM generated at set-up, cycled in order;
  setup_ticks        (optional, at least SETUP_TICKS, which is the
                     default) ticks of set-up before the window: a codec
                     with a long history fills it here;
  talk_share,        each (tick, stream) hop is Gaussian noise at talk_rms
  talk_rms,          with probability talk_share, else at quiet_rms (int16
  quiet_rms          scale), so the noise estimators see both levels;
  loss.iid           each stream-hop's packet is lost with this
                     probability, independently;
  loss.burst_every,  every burst_stride-th row also loses burst_hops
  loss.burst_hops,   packets in a row once every burst_every ticks, at a
  loss.burst_stride  phase drawn per row (0 turns bursts off).

A mix that gives `rates` is a fleet, served by a ServerPool pair
(portbench/fleet.py), and gives instead of bits_per_packet:
  rates              {Hz: share}: the streams by external sample rate,
                     split by largest remainder;
  wave_capacity      slots of each wave (one server each way); a rate has
                     as many waves as its streams need, filled evenly, and
                     the waves are ordered by rate: the rows of the pool;
  bitrates           {bit/s: share}: each rate's streams at set-up are
                     split so by largest remainder, in an order drawn
                     from the seed; a stream admitted later draws its own;
  churn_per_s        streams ended per admitted stream and second of
                     audio.  Each one is replaced at once by a new stream
                     of its rate (its own bitrate, a fresh state).  The
                     events of CHURN_CYCLE ticks fall on the waves by a
                     fixed schedule, in proportion to their streams, and
                     the stream that ends is drawn from (seed, tick): every
                     seed and every stretch of CHURN_CYCLE ticks admits as
                     many streams on each wave.
A fleet's arrays have a row per slot: PCM rows hold each row's own hop
left-aligned in the widest hop (as ServerPool takes them), and loss is
drawn per slot.

The PCM pool is drawn on the run's device in one call and kept on the
host as int16, as a server receives it.  Loss for tick t is drawn from
(seed, t) alone, so every seed loses the same share in another order and
the reference reads the same pattern back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1
CHURN_CYCLE = 20  # ticks of one churn schedule: a profiled stretch's length
# The fewest set-up ticks: each server program's warm-up and two captures.
SETUP_TICKS = 6


def shares(total: int, weights: Sequence[float]) -> List[int]:
    """`total` split in proportion to `weights` by largest remainder
    (ties to the first)."""
    w = np.asarray(weights, np.float64)
    exact = total * w / w.sum()
    out = np.floor(exact).astype(np.int64)
    for i in sorted(range(len(w)), key=lambda i: -(exact[i] - out[i]))[
            :total - int(out.sum())]:
        out[i] += 1
    return [int(n) for n in out]


def hop_samples(rate: int, hop_ms) -> int:
    """Samples of one hop of `hop_ms` at `rate` Hz (a whole number)."""
    samples = int(rate) * hop_ms / 1000
    if samples != int(samples):
        raise ValueError(f"a hop of {hop_ms} ms at {rate} Hz is "
                         f"{samples} samples: not a whole number")
    return int(samples)


def bits_of(bitrate: int, hop_ms) -> int:
    """Quantized bits a packet of `bitrate` bit/s carries, one a hop."""
    return int(int(bitrate) * hop_ms // 1000)


def bitrate_of(bits: int, hop_ms) -> int:
    """The bitrate (bit/s) of packets of `bits` bits, one a hop."""
    return int(round(int(bits) * 1000 / hop_ms))


@dataclasses.dataclass
class Layout:
    """A fleet's waves: the rate of each, their capacity, and the streams
    each rate admits at set-up."""
    wave_rates: Tuple[int, ...]
    capacity: int
    streams: Dict[int, int]

    @classmethod
    def of(cls, mix: dict) -> "Layout":
        rates = sorted((int(r), float(s)) for r, s in mix["rates"].items())
        counts = shares(int(mix["streams"]), [s for _, s in rates])
        cap = int(mix["wave_capacity"])
        waves = tuple(r for (r, _), n in zip(rates, counts)
                      for _ in range(-(-n // cap)))
        return cls(waves, cap, {r: n for (r, _), n in zip(rates, counts)})

    @property
    def slots(self) -> int:
        return len(self.wave_rates) * self.capacity

    def wave_streams(self) -> List[int]:
        """Streams each wave holds after set-up (a rate's streams spread
        evenly over its waves, the first ones taking the remainder)."""
        out = []
        for rate, n in self.streams.items():
            k = self.wave_rates.count(rate)
            out += shares(n, [1.0] * k)
        return out

    def row_rates(self) -> np.ndarray:
        return np.repeat(np.asarray(self.wave_rates), self.capacity)

    def row_waves(self) -> np.ndarray:
        return np.arange(self.slots) // self.capacity


class Traffic:
    def __init__(self, mix: dict, seed: int, sample_rate_hz: int, hop_ms,
                 device):
        self.streams = int(mix["streams"])
        self.seed = int(seed) & _SEED_MASK
        self.hop_ms = hop_ms
        self.hop_s = hop_ms / 1000
        self.setup_ticks = int(mix.get("setup_ticks", SETUP_TICKS))
        if self.setup_ticks < SETUP_TICKS:
            raise ValueError(f"the mix's setup_ticks {self.setup_ticks} is "
                             f"under {SETUP_TICKS}")
        self.layout: Optional[Layout] = None
        if "rates" in mix:
            self.layout = lay = Layout.of(mix)
            self.rows = lay.slots
            row_hop = np.array([hop_samples(r, hop_ms)
                                for r in lay.row_rates()])
            self.hop = hop = int(row_hop.max())
            self.bits = None
            rates = sorted(mix["bitrates"].items(), key=lambda x: int(x[0]))
            self.bitrates = np.array([int(b) for b, _ in rates])
            self.bitrate_shares = np.array([float(s) for _, s in rates])
            self.churn_per_s = float(mix["churn_per_s"])
            self._cycle = self._churn_cycle()
        else:
            self.rows = self.streams
            self.hop = hop = hop_samples(sample_rate_hz, hop_ms)
            self.bits = int(mix["bits_per_packet"])
        b = self.rows
        loss = mix["loss"]
        self.iid = float(loss["iid"])
        self.burst_every = int(loss["burst_every"])
        self.burst_hops = int(loss["burst_hops"])
        stride = int(loss["burst_stride"])
        pool = int(mix["pool_ticks"])
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        x = torch.randn((pool, b, hop), generator=gen, device=device)
        talk = torch.rand((pool, b, 1), generator=gen, device=device)
        x *= torch.where(talk < float(mix["talk_share"]),
                         float(mix["talk_rms"]), float(mix["quiet_rms"]))
        if self.layout is not None:  # each row's own hop, left-aligned
            x *= (torch.arange(hop, device=device)[None, :] < torch.as_tensor(
                row_hop, device=device)[:, None])
        self.pool = x.clamp_(-32768, 32767).to(torch.int16).cpu().numpy()
        del x, talk
        rng = np.random.default_rng([self.seed, 1])
        self.burst_rows = (np.arange(b) % stride == 0) if self.burst_every \
            else np.zeros(b, bool)
        self.burst_phase = rng.integers(0, max(self.burst_every, 1), b)

    def pcm(self, t: int) -> np.ndarray:
        """[rows, hop] int16: what every row sends at tick t."""
        return self.pool[t % self.pool.shape[0]]

    def pcm_at(self, ticks: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """[K, hop] int16: row rows[k]'s PCM at tick ticks[k]."""
        return self.pool[np.asarray(ticks) % self.pool.shape[0],
                         np.asarray(rows)]

    def received(self, t: int) -> np.ndarray:
        """[rows] bool: which of tick t's packets the network delivers."""
        lost = np.random.default_rng([self.seed, 2, t]).random(
            self.rows) < self.iid
        if self.burst_every:
            lost |= self.burst_rows & ((t - self.burst_phase)
                                       % self.burst_every < self.burst_hops)
        return ~lost

    # -- a fleet's admissions ------------------------------------------------
    def setup_bitrates(self, rate: int) -> np.ndarray:
        """The bitrates (bit/s) of `rate`'s streams admitted at set-up, in
        admission order."""
        n = self.layout.streams[rate]
        out = np.repeat(self.bitrates, shares(n, self.bitrate_shares))
        return np.random.default_rng([self.seed, 5, rate]).permutation(out)

    def _churn_cycle(self) -> List[List[int]]:
        """The waves of each tick's churn events over one cycle."""
        events = int(round(self.streams * self.churn_per_s * self.hop_s
                           * CHURN_CYCLE))
        per_wave = shares(events, self.layout.wave_streams())
        # Each wave's events spread evenly over the cycle.
        waves = [w for _, w in sorted((((k + 0.5) / n, w) for w, n in
                                       enumerate(per_wave) for k in range(n)))]
        cycle: List[List[int]] = [[] for _ in range(CHURN_CYCLE)]
        for e, w in enumerate(waves):
            cycle[e * CHURN_CYCLE // max(events, 1)].append(w)
        return cycle

    def churn(self, t: int, waves: Optional[List[int]] = None
              ) -> List[Tuple[int, float, int]]:
        """Tick t's churn events, before its PCM is submitted: (wave, u,
        bitrate), where the stream that ends is the wave's active stream at
        position ⌊u × active⌋ and its replacement sends `bitrate`.  `waves`
        (set-up's) replace the schedule's."""
        if waves is None:
            waves = self._cycle[t % CHURN_CYCLE]
        rng = np.random.default_rng([self.seed, 4, t])
        return [(w, float(rng.random()),
                 int(rng.choice(self.bitrates, p=self.bitrate_shares
                                / self.bitrate_shares.sum())))
                for w in waves]
