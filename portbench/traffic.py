"""The one traffic generator: a mix file's parameters → the PCM every
stream sends and the packets the network loses, all from `--seed`.

A mix (portbench/traffic/<name>.json) gives:
  streams            B, every slot of the server pair admitted at set-up;
  bits_per_packet    the encoder's rate for every stream (120 = 6 kbps);
  pool_ticks         ticks of PCM generated at set-up, cycled in order;
  talk_share,        each (tick, stream) hop is Gaussian noise at talk_rms
  talk_rms,          with probability talk_share, else at quiet_rms (int16
  quiet_rms          scale), so the noise estimators see both levels;
  loss.iid           each stream-hop's packet is lost with this
                     probability, independently;
  loss.burst_every,  every burst_stride-th stream also loses burst_hops
  loss.burst_hops,   packets in a row once every burst_every ticks, at a
  loss.burst_stride  phase drawn per stream (0 turns bursts off).

The PCM pool is drawn on the run's device in one call and kept on the
host as int16, as a server receives it.  Loss for tick t is drawn from
(seed, t) alone, so every seed loses the same share in another order and
the reference reads the same pattern back.
"""

from __future__ import annotations

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1


class Traffic:
    def __init__(self, mix: dict, seed: int, sample_rate_hz: int, device):
        self.streams = b = int(mix["streams"])
        self.hop = hop = sample_rate_hz // 50
        self.bits = int(mix["bits_per_packet"])
        self.seed = int(seed) & _SEED_MASK
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
        self.pool = x.clamp_(-32768, 32767).to(torch.int16).cpu().numpy()
        del x, talk
        rng = np.random.default_rng([self.seed, 1])
        self.burst_rows = (np.arange(b) % stride == 0) if self.burst_every \
            else np.zeros(b, bool)
        self.burst_phase = rng.integers(0, max(self.burst_every, 1), b)

    def pcm(self, t: int) -> np.ndarray:
        """[B, hop] int16: what every stream sends at tick t."""
        return self.pool[t % self.pool.shape[0]]

    def received(self, t: int) -> np.ndarray:
        """[B] bool: which of tick t's packets the network delivers."""
        lost = np.random.default_rng([self.seed, 2, t]).random(
            self.streams) < self.iid
        if self.burst_every:
            lost |= self.burst_rows & ((t - self.burst_phase)
                                       % self.burst_every < self.burst_hops)
        return ~lost
