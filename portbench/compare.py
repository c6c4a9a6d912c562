"""The comparison that decides `correct`.

What the timed path produced for a sample of streams, every tick of the
run, is judged by the configuration's plain float32 reference (the module
its `reference` names; Lyra v2's is portbench/reference/codec.py), with
TF32 off, after the program's state is freed:

  code_gap   encoder side.  The reference's encoder runs over each
             sampled stream's PCM (Lyra's: SoundStream, on the PCM
             resampled to 16 kHz where the stream's rate differs); every
             code the program put on the wire is scored against the
             reference's best codeword, following the program's codes
             (`code_gaps`): the largest share of the features' norm by
             which a code lies off the best.  A code that differs at a
             near-tie reads a share at rounding level; a wrong code reads
             far more.
  pcm_err    decoder side.  The reference decodes the codes the program's
             decoder received (the wire after the loss channel), with the
             same losses (Lyra's: through LyraGAN, PLC, comfort noise, the
             crossfade and the resampler); the largest |program − reference|
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

In a fleet (portbench/fleet.py) a row changes hands, and a stream is a
tenure: one admission of one row, at its row's rate and its own bitrate.
The reference follows every tenure of each sampled row from a fresh state
at its admission: the encoder from the tick before whose submit it was
admitted, scored on the ticks whose packet the wire holds; the decoder
from the first wire tick it stepped (the one in flight at the admission,
whose packet the server drops as the slot's old owner's), fed the codes
at the tenure's own stages, compared where the PCM drained is still its
own (a slot that changed hands between submit and drain drains silence).
`bad_sizes` then holds each row to its owner's packet size at the submit,
and to 0 where no packet is due: an empty row, or one that changed hands
before the drain.  The quartile of pcm_rms_err is over tenures.

A number is compared where the configuration's file gives it a limit
(`limits`); the readings each limit was set from are in PERF.md.

The reference module gives, for one codec (all tensors on `device`):
  Encoder(model_dir, rate, device)
      .features(pcm, spans) → [[stop − start, F] per lane]: the features
      of lane l's ticks start_l ≤ t < stop_l (spans [(start_l, stop_l)])
      from a fresh state at start_l, where pcm(ticks, lanes) is the [K,
      hop] int16 numpy PCM of lane lanes[k] at tick ticks[k];
  Decoder(model_dir, rate, device)
      .codebooks: what `code_gaps` takes as its third argument;
      .init_state(slots, seed) → the state of streams in those server
      slots (a dict of tensors, nested dicts allowed, a row a stream; a
      `fade` entry, where there is one, is shown in the notes);
      .step(state, codes [R, S] int32 (−1 past a stream's stages),
      received [R] bool) → (pcm [R, hop] float, state);
  unpack_wire(wire [R, bytes] uint8, stages) → [R, stages] int32 codes;
  code_gaps(features [N, F], codes [N, S], codebooks) → [N, S]: how far
      each code lies from the best, as a share of the features' norm;
  stages_of(bits) → the stages a packet of `bits` quantized bits
      carries (an int, or an integer array elementwise).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.traffic import hop_samples

NUMBERS = ("code_gap", "pcm_err", "pcm_rms_err", "bad_sizes", "lost_ticks")
CHECK_ROWS = 32  # sampled streams, half of them on the bursty rows
GAP_ROWS = 2048  # codes scored at once


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


def sample_fleet_rows(seed: int, admitted: np.ndarray, rates: np.ndarray,
                      bits: np.ndarray, waves: np.ndarray,
                      burst_rows: np.ndarray, n: int, each: int = 4,
                      per_wave: int = 2) -> np.ndarray:
    """`n` of a fleet's `admitted` rows, drawn from the seed: half with
    bursts, at least `per_wave` of every wave (one server each way) and at
    least `each` of every rate and every bitrate (`rates`, `bits`, `waves`:
    each row's).  A pick first fills a wave short of its rows, then a rate
    or a bitrate short of its."""
    on = np.flatnonzero(admitted)
    rng = np.random.default_rng([seed, 3])
    pools = [list(rng.permutation(on[burst_rows[on]])),
             list(rng.permutation(on[~burst_rows[on]]))]
    # Each kind of group: its values by row, its least, its rows so far.
    kinds = [(g, least, {int(v): 0 for v in np.unique(g[on])})
             for g, least in ((waves, per_wave), (rates, each), (bits, each))]

    def short(row, of) -> int:
        return sum(c[int(g[row])] < least for g, least, c in of)

    def helps(row) -> tuple:
        return short(row, kinds[:1]), short(row, kinds[1:])

    picks: List[int] = []
    for k in range(min(n, on.size)):
        pool = pools[k % 2] if pools[k % 2] else pools[1 - k % 2]
        row = max(pool, key=helps)  # the first of the most helpful
        pool.remove(row)
        picks.append(row)
        for g, _, c in kinds:
            c[int(g[row])] += 1
    return np.sort(np.asarray(picks, np.int64))


class Record:
    """What the program produced for the sampled rows, tick by tick, and
    the exact counts over all rows.  With a `fleet` (portbench/fleet.py)
    the rows change hands: each tick's owners are kept as the encoder and
    the decoder took it, so the reference follows every tenure."""

    def __init__(self, rows: np.ndarray, packet_bytes: Optional[int],
                 fleet=None):
        self.rows = rows
        self.packet_bytes = packet_bytes
        self.fleet = fleet
        self.wire: Dict[int, np.ndarray] = {}
        self.received: Dict[int, np.ndarray] = {}
        self.pcm: Dict[int, np.ndarray] = {}
        self.bad_sizes = 0
        self.lost_ticks = 0
        # A fleet's: the tenure whose packet the wire's row holds (−1: none
        # due), the tenure the decoder stepped, and whether the PCM drained
        # is still that tenure's, by tick, at the sampled rows.
        self._submits: Dict[int, tuple] = {}
        self._sends: Dict[int, tuple] = {}
        self.enc_owner: Dict[int, np.ndarray] = {}
        self.dec_owner: Dict[int, np.ndarray] = {}
        self.dec_ok: Dict[int, np.ndarray] = {}

    def submitted(self, t: int) -> None:
        """Tick t's PCM goes to the encoder now."""
        f = self.fleet
        if f is not None:
            self._submits[t] = (f.owner.copy(), f.gen.copy(), f.bits.copy())

    def encoded(self, t: int, wire: np.ndarray, sizes: np.ndarray) -> None:
        expected = self.packet_bytes
        if self.fleet is not None:
            # A server emits each row admitted at the submit that has not
            # changed hands since, at its owner's size; no other.
            owner, gen, bits = self._submits.pop(t)
            due = (owner >= 0) & (gen == self.fleet.gen)
            expected = np.where(due, -(-bits // 8), 0)
            self.enc_owner[t] = np.where(due, owner, -1)[self.rows]
        self.bad_sizes += int(np.count_nonzero(sizes != expected))
        self.wire[t] = wire[self.rows].copy()

    def sent(self, t: int, received: np.ndarray) -> None:
        self.received[t] = received[self.rows].copy()
        f = self.fleet
        if f is not None:
            self._sends[t] = (f.owner[self.rows].copy(),
                              f.gen[self.rows].copy())

    def decoded(self, t: int, pcm) -> None:
        if self.fleet is not None:
            owner, gen = self._sends.pop(t)
            self.dec_owner[t] = owner
            self.dec_ok[t] = (owner >= 0) & (gen == self.fleet.gen[self.rows])
        if pcm is None:
            self.lost_ticks += 1
            return
        self.pcm[t] = pcm[self.rows].copy()

    def ticks(self) -> List[int]:
        return sorted(self.wire)

    def wire_of(self, at: int, ticks) -> np.ndarray:
        """[len(ticks), bytes] the wire of the sampled row `at` (a fleet's
        width follows its widest packet: narrower ticks padded with 0)."""
        rows = [self.wire[t][at] for t in ticks]
        out = np.zeros((len(rows), max(r.size for r in rows)), np.uint8)
        for i, r in enumerate(rows):
            out[i, :r.size] = r
        return out

    def lanes(self, rate: int, stages_of) -> List["Lane"]:
        """The streams the reference follows: each sampled row over the
        whole run at `rate` and the mix's packet size, or in a fleet each
        tenure that a sampled row held; `stages_of` (the reference's) gives
        the stages of a packet's bits."""
        ticks = self.ticks()
        if self.fleet is None:
            stages = stages_of(self.packet_bytes * 8)
            return [Lane(i, int(r), int(r), rate, stages, 0, ticks, ticks,
                         ticks) for i, r in enumerate(self.rows)]
        enc = np.stack([self.enc_owner[t] for t in ticks])
        dec_ticks = sorted(self.dec_owner)
        dec = np.stack([self.dec_owner[t] for t in dec_ticks])
        ok = np.stack([self.dec_ok[t] for t in dec_ticks])
        cap = self.fleet.layout.capacity
        out = []
        for i, row in enumerate(self.rows):
            for tid in np.unique(dec[:, i][dec[:, i] >= 0]):
                ten = self.fleet.tenures[tid]
                stepped = [dec_ticks[j] for j in np.flatnonzero(
                    dec[:, i] == tid)]
                compared = [dec_ticks[j] for j in np.flatnonzero(
                    (dec[:, i] == tid) & ok[:, i])]
                coded = [ticks[j] for j in np.flatnonzero(enc[:, i] == tid)]
                out.append(Lane(i, int(row), int(row) % cap, ten.rate,
                                stages_of(ten.bits), ten.admitted, coded,
                                stepped, compared))
        return out


@dataclasses.dataclass
class Lane:
    """One stream the reference follows: the sampled row's index in the
    record (`at`), its pool row and its slot in its server (the comfort
    noise's lineage), its rate and RVQ stages; the encoder from a fresh
    state at `admitted`, scored at the ticks whose codes the wire holds
    (`coded`); the decoder from a fresh state at the first tick of
    `stepped`, through each, compared where the PCM is still its own
    (`compared`)."""
    at: int
    row: int
    slot: int
    rate: int
    stages: int
    admitted: int
    coded: List[int]
    stepped: List[int]
    compared: List[int]


def judge(rec: Record, traffic, cfg: dict, device,
          seed: int = 0) -> Dict[str, float]:
    """The configuration's reference (`cfg["reference"]`, its model
    files in `cfg["model_dir"]`) over every recorded tick of the sampled
    rows' streams (`Record.lanes`), one rate at a time; → {number:
    reading}, and under "_worst" where the largest PCM gap lay.  `seed`
    is the decoder servers' (its comfort-noise RNG lineage)."""
    t0 = time.perf_counter()
    ticks = rec.ticks()
    if ticks != list(range(len(ticks))):
        raise ValueError("the record does not start at tick 0 or has gaps")
    ref = importlib.import_module(cfg["reference"])
    model_dir = cfg["model_dir"]
    lanes = rec.lanes(int(cfg["sample_rate_hz"]), ref.stages_of)
    gaps: Dict[int, List[tuple]] = {}
    acc = []
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=False), _no_tf32_matmul(), \
            torch.inference_mode():
        for rate in sorted({ln.rate for ln in lanes}):
            group = [ln for ln in lanes if ln.rate == rate]
            enc = ref.Encoder(model_dir, rate, device)
            dec = ref.Decoder(model_dir, rate, device)
            coded = [ln for ln in group if ln.coded]
            hop = hop_samples(rate, traffic.hop_ms)
            rows = np.array([rec.rows[ln.at] for ln in coded])
            feats = enc.features(
                lambda t, k: traffic.pcm_at(t, rows[k])[:, :hop],
                [(ln.admitted, ln.coded[-1] + 1) for ln in coded])
            for ln, f in zip(coded, feats):
                codes = ref.unpack_wire(rec.wire_of(ln.at, ln.coded),
                                        ln.stages)
                gaps.setdefault(ln.stages, []).append(
                    (f[np.asarray(ln.coded) - ln.admitted],
                     torch.as_tensor(codes, device=device)))
            acc += _decode(rec, ref, dec,
                           [ln for ln in group if ln.stepped], hop, seed,
                           device)
        gap = 0.0
        for stages, parts in gaps.items():
            f = torch.cat([p[0] for p in parts])
            c = torch.cat([p[1] for p in parts])
            for i in range(0, f.shape[0], GAP_ROWS):
                gap = max(gap, float(ref.code_gaps(
                    f[i:i + GAP_ROWS], c[i:i + GAP_ROWS],
                    dec.codebooks).max()))
    lanes = [a for a in acc if a["compared"]]
    rel = torch.tensor([a["diff"] / max(a["peak"], 1.0) for a in lanes],
                       dtype=torch.float64)
    rms = torch.tensor([math.sqrt(a["sq_err"] / max(a["sq_ref"], 1.0))
                        for a in lanes], dtype=torch.float64)
    w = int(rel.argmax())
    worst = lanes[w]
    return {"code_gap": gap, "pcm_err": float(rel[w]),
            "pcm_rms_err": float(rms.sort(descending=True).values[
                -(-len(lanes) // 4) - 1]),
            "bad_sizes": float(rec.bad_sizes),
            "lost_ticks": float(rec.lost_ticks),
            "_seconds": time.perf_counter() - t0,
            "_ticks": float(len(ticks)),
            "_streams": float(len(lanes)),
            "_worst": {"slot": worst["lane"].row, "tick": worst["at"],
                       **({"rate": worst["lane"].rate,
                           "stages": worst["lane"].stages,
                           "admitted": worst["lane"].admitted}
                          if rec.fleet is not None else {}),
                       "lsb": worst["diff"], "peak": worst["peak"],
                       "rms_err": float(rms[w]),
                       "fade_before": worst["fade_before"],
                       "fade_after": worst["fade_after"],
                       "received": worst["received"],
                       "rows_over_10x_median_rms": int(
                           (rms > 10 * rms.median()).sum())}}


def _where_tree(mask, new, old):
    """`new` where `mask` (a row a stream), else `old`, leaf by leaf."""
    if isinstance(new, dict):
        return {k: _where_tree(mask, v, old[k]) for k, v in new.items()}
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _decode(rec: Record, ref, dec, lanes: List[Lane], hop: int, seed: int,
            device) -> List[dict]:
    """The reference decoder over `lanes` side by side, each from a fresh
    state at its first stepped tick, fed the codes and losses the
    program's decoder was; → each lane's PCM error sums."""
    if not lanes:
        return []
    at = [ln.at for ln in lanes]
    first = torch.tensor([ln.stepped[0] for ln in lanes], device=device)
    last = torch.tensor([ln.stepped[-1] for ln in lanes], device=device)
    lo, hi = int(first.min()), int(last.max())
    stages = max(ln.stages for ln in lanes)
    # Each lane's codes at each tick, −1 past its own stages.
    codes = np.full((hi + 1 - lo, len(lanes), stages), -1, np.int32)
    for k, ln in enumerate(lanes):
        codes[:, k, :ln.stages] = ref.unpack_wire(
            rec.wire_of(ln.at, range(lo, hi + 1)), ln.stages)
    codes = torch.as_tensor(codes, device=device)
    compared = torch.zeros((hi + 1 - lo, len(lanes)), dtype=torch.bool)
    for k, ln in enumerate(lanes):
        compared[np.asarray(ln.compared, np.int64) - lo, k] = True
    compared = compared.to(device)
    ds = dec.init_state([ln.slot for ln in lanes], seed)
    peak = torch.zeros(len(lanes), dtype=torch.float64, device=device)
    diff, where = torch.zeros_like(peak), torch.zeros_like(peak)
    sq_err, sq_ref = torch.zeros_like(peak), torch.zeros_like(peak)
    fade = {}
    for t in range(lo, hi + 1):
        if t not in rec.pcm:
            continue
        live = (first <= t) & (t <= last)
        recv = torch.as_tensor(rec.received[t][at], device=device)
        ref, new = dec.step(ds, codes[t - lo], recv)
        ds = new if bool(live.all()) else _where_tree(live, new, ds)
        ref = ref.double()
        cmp = compared[t - lo]
        got = torch.as_tensor(rec.pcm[t][at][:, :hop], device=device)
        err = torch.where(cmp[:, None], got.double() - ref, 0.0)
        ref = torch.where(cmp[:, None], ref, 0.0)
        peak = torch.maximum(peak, ref.abs().amax(dim=1))
        e = err.abs().amax(dim=1)
        where = torch.where(e > diff, float(t), where)
        diff = torch.maximum(diff, e)
        sq_err += (err * err).sum(dim=1)
        sq_ref += (ref * ref).sum(dim=1)
        if "fade" in ds:
            fade[t] = ds["fade"]
    out = []
    for k, ln in enumerate(lanes):
        t = int(where[k])
        out.append({"lane": ln, "compared": len(ln.compared), "at": t,
                    "diff": float(diff[k]), "peak": float(peak[k]),
                    "sq_err": float(sq_err[k]), "sq_ref": float(sq_ref[k]),
                    "fade_before": int(fade[t - 1][k]) if t - 1 in fade
                    else 0,
                    "fade_after": int(fade[t][k]) if t in fade else 0,
                    "received": bool(rec.received[t][ln.at])})
    return out


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
