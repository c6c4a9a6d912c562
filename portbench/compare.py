"""The comparison that decides `correct`.

What the timed path produced for a sample of streams, every tick of the
run, is judged by the plain float32 reference (portbench/reference), with
TF32 off, after the program's state is freed:

  code_gap   encoder side.  The reference runs SoundStream over each
             sampled stream's PCM (resampled to 16 kHz where the stream's
             rate differs); every RVQ code the program put on the wire is
             scored against the reference's best codeword, following the
             program's codes (reference.codec.code_gaps): the largest share
             of the features' norm by which a code lies off the best.  A
             code that differs at a near-tie reads a share at rounding
             level; a wrong code reads far more.
  pcm_err    decoder side.  The reference decodes the codes the program's
             decoder received (the wire after the loss channel), with the
             same losses, through LyraGAN, PLC, comfort noise, the
             crossfade and the resampler; the largest |program − reference|
             of a stream's PCM, as a share of that stream's peak |reference|.
             No configuration limits it (it has no upper reading: see
             pcm_rms_err); the run's notes show where it lay.
  pcm_rms_err  decoder side, the same PCM: per sampled stream the root
             of Σ (program − reference)² over Σ reference², over all its
             hops, at the upper quartile of the streams (the ⌈n/4⌉-th
             largest).  A float32 rounding difference can tip the decoder's
             noise estimator on a stream now and then and move that
             stream's comfort noise by hundreds of LSB; a quartile reads
             through a few such streams, and still reads every stream that
             a fault or a lower precision moves.
  bad_sizes  stream-hops of all streams whose wire size is not the mix's
             packet size (every stream sends every hop: no DTX).  Exact.
  lost_ticks ticks of the run that returned no PCM.  Exact.

A number is compared where the configuration's file gives it a limit
(`limits`); the readings each limit was set from are in PERF.md.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import codec

NUMBERS = ("code_gap", "pcm_err", "pcm_rms_err", "bad_sizes", "lost_ticks")
CHECK_ROWS = 32  # sampled streams, half of them on the bursty rows


def sample_rows(seed: int, streams: int, burst_rows: np.ndarray) -> np.ndarray:
    """CHECK_ROWS slots drawn from the seed: half from the streams with
    bursts (comfort noise and crossfades), half from the rest."""
    rng = np.random.default_rng([seed, 3])
    bursty, plain = np.flatnonzero(burst_rows), np.flatnonzero(~burst_rows)
    n = min(CHECK_ROWS // 2, bursty.size)
    picks = [rng.choice(bursty, n, replace=False)] if n else []
    picks.append(rng.choice(plain, min(CHECK_ROWS - n, plain.size),
                            replace=False))
    return np.sort(np.concatenate(picks))


class Record:
    """What the program produced for the sampled rows, tick by tick, and
    the exact counts over all streams."""

    def __init__(self, rows: np.ndarray, packet_bytes: int):
        self.rows = rows
        self.packet_bytes = packet_bytes
        self.wire: Dict[int, np.ndarray] = {}
        self.received: Dict[int, np.ndarray] = {}
        self.pcm: Dict[int, np.ndarray] = {}
        self.bad_sizes = 0
        self.lost_ticks = 0

    def encoded(self, t: int, wire: np.ndarray, sizes: np.ndarray) -> None:
        self.bad_sizes += int(np.count_nonzero(sizes != self.packet_bytes))
        self.wire[t] = wire[self.rows].copy()

    def sent(self, t: int, received: np.ndarray) -> None:
        self.received[t] = received[self.rows].copy()

    def decoded(self, t: int, pcm) -> None:
        if pcm is None:
            self.lost_ticks += 1
            return
        self.pcm[t] = pcm[self.rows].copy()

    def ticks(self) -> List[int]:
        return sorted(self.wire)


def judge(rec: Record, traffic, model_dir: str, sample_rate_hz: int,
          device, seed: int = 0) -> Dict[str, float]:
    """The reference over every recorded tick of the sampled rows; →
    {number: reading}, and under "_worst" where the largest PCM gap lay.
    `seed` is the decoder server's (its comfort-noise RNG lineage)."""
    t0 = time.perf_counter()
    ticks = rec.ticks()
    if ticks != list(range(len(ticks))):
        raise ValueError("the record does not start at tick 0 or has gaps")
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=False), _no_tf32_matmul(), \
            torch.inference_mode():
        enc = codec.Encoder(model_dir, sample_rate_hz, device)
        dec = codec.Decoder(model_dir, sample_rate_hz, device)
        rows = rec.rows
        stages = rec.packet_bytes * 8 // 4
        feats = enc.features(
            lambda t: torch.as_tensor(traffic.pcm(t)[rows], device=device),
            len(ticks), rows.size)
        codes = torch.as_tensor(np.stack(
            [codec.unpack_wire(rec.wire[t], stages) for t in ticks]),
            device=device)
        gap = max(float(codec.code_gaps(
            feats[i:i + 64].reshape(-1, feats.shape[-1]),
            codes[i:i + 64].reshape(-1, stages), dec.codebooks).max())
            for i in range(0, len(ticks), 64))
        ds = dec.init_state(rows, seed)
        peak = torch.zeros(rows.size, dtype=torch.float64, device=device)
        diff, at = torch.zeros_like(peak), torch.zeros_like(peak)
        sq_err, sq_ref = torch.zeros_like(peak), torch.zeros_like(peak)
        fade = []
        for t in ticks:
            if t not in rec.pcm:
                continue
            recv = torch.as_tensor(rec.received[t], device=device)
            ref, ds = dec.step(ds, codes[t], recv)
            ref = ref.double()
            err = torch.as_tensor(rec.pcm[t], device=device).double() - ref
            peak = torch.maximum(peak, ref.abs().amax(dim=1))
            e = err.abs().amax(dim=1)
            at = torch.where(e > diff, float(t), at)
            diff = torch.maximum(diff, e)
            sq_err += (err * err).sum(dim=1)
            sq_ref += (ref * ref).sum(dim=1)
            fade.append(ds["fade"])
        rel = diff / peak.clamp_min(1.0)
        rms = (sq_err / sq_ref.clamp_min(1.0)).sqrt()
        w = int(rel.argmax())
        worst_t = int(at[w])
        fades = torch.stack(fade)[:, w].tolist()
    return {"code_gap": gap, "pcm_err": float(rel[w]),
            "pcm_rms_err": float(rms.sort(descending=True).values[
                -(-rows.size // 4) - 1]),
            "bad_sizes": float(rec.bad_sizes),
            "lost_ticks": float(rec.lost_ticks),
            "_seconds": time.perf_counter() - t0,
            "_ticks": float(len(ticks)),
            "_worst": {"slot": int(rows[w]), "tick": worst_t,
                       "lsb": float(diff[w]), "peak": float(peak[w]),
                       "rms_err": float(rms[w]),
                       "fade_before": fades[worst_t - 1] if worst_t else 0,
                       "fade_after": fades[worst_t],
                       "received": bool(rec.received[worst_t][w]),
                       "rows_over_10x_median_rms": int(
                           (rms > 10 * rms.median()).sum())}}


class _no_tf32_matmul:
    def __enter__(self):
        self._was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._was


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """→ (correct, {number: {"value", "limit"}}): every number that
    `limits` names at or under its limit; a limit of None (not set yet)
    fails."""
    checks, ok = {}, True
    for name in NUMBERS:
        if name not in limits:
            continue
        lim = limits[name]
        value = readings[name]
        checks[name] = {"value": value, "limit": lim}
        ok = ok and lim is not None and value <= lim
    return ok, checks
