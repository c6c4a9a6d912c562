#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (lyra_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-out DIR]

Drives the port's main path — the lockstep codec tick: EncoderEngine.step
→ device wire pack → unpack → DecoderEngine.step — at the full width of the
Lyra v2 models: the real weights when LYRA_TPU_MODEL_PATH names a directory
that holds them, otherwise the synthetic full-width fixture
(tests/golden/synthetic_lyra/full, random weights from a seed).

Phases, one line each; any failed check raises and exits nonzero:
  1. build    the CUDA kernels from lyra_tpu_torch/ops/csrc with nvcc, one
              process per source, started together;
  2. K1       the fused conv stack vs the plain executor (SoundStream and
              LyraGAN, B=64, 20 frames, state carried, TF32 off; bar
              1e-5 × max|plain|), then every conv-stack kernel call of one
              hop vs its plain version at B=1024, timed;
  3. K1-bf16  the same in bf16 mode: the fused stack vs the plain bf16
              executor and vs the plain f32 one (bar 3e-2 × max|plain|),
              then every bf16 kernel call of one hop at B=1024 vs its
              plain bf16 version (bar 2^-7 × max|ref|, two bf16
              roundings), timed per hop in 7 alternating rounds (kernel
              and plain, eager launches and CUDA-graph replays), with
              each kernel's FLOP, activation bytes and roofline shares;
  4. K2       the RVQ kernel vs its plain version at B=4096: rows may
              differ only at near-ties, at most 0.1% of rows;
  5. rates    the resampler on the card vs tests/golden/resampler_goldens
              .npz at all six rate pairs (bar 0.05 at int16 scale), then a
              B=1024, 50-hop streaming run at 16↔48 kHz vs the
              single-stream numpy path;
  6. main     the float engines at 16 kHz, 50 ticks at B=1024 with ~10%
              of hops lost, launch counts reset before and read after,
              kernel names checked in a torch.profiler window, output
              finite at speech level, and the kernel path's decoder vs the
              plain path's on the same indices (within 2 int16 LSB);
  7. main-bf16  the same slice in bf16 mode at 48 kHz (the JAX package's
              serving mode, a 48 kHz fleet), then vs the plain bf16 path
              at B=64 from identical inputs: features and decoder audio
              within 3e-2 × max|plain|, indices identical;
  8. timing   p50/p99 ms per tick, kernel path vs plain path, float at
              16 kHz and bf16 at 48 kHz.
The 3e-2 bars were measured on the small fixture; where the full fixture
needs more room, the bar becomes 1.5 × the deviation of the plain bf16
path from the plain f32 path on the same inputs, measured in the same
phase (both numbers are printed).
Then one JSON line with every kernel, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.

Exits nonzero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import os

# lyra_tpu's package __init__ imports jax when LYRA_TPU_PLATFORM is set, and
# the port imports lyra_tpu's framework-free modules (config, the TFLite
# parser, the host packet codecs).  The GPU machine has no jax.
os.environ.pop("LYRA_TPU_PLATFORM", None)

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from functools import partial  # noqa: E402

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
FULL_FIXTURE = os.path.join(REPO, "tests", "golden", "synthetic_lyra", "full")
REL_TOL = 1e-5
BF16_REL_TOL = 3e-2  # whole models and engines in bf16 vs plain
BF16_CALL_TOL = 2.0 ** -7  # one kernel call: two bf16 roundings
ROUNDS, ROUND_REPS = 7, 10  # K1-bf16 timing: alternating rounds, calls each
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12  # H100 SXM data sheet
GOLDEN_TOL = 0.05  # resampler vs goldens, int16 scale (the JAX test's bar)
BATCH, TICKS = 1024, 50  # the main path's streams and ticks
RATE_BF16 = 48000  # the bf16 main path's fleet rate
# The two graphs of the fused stack: input shape per stream, input scale.
MODELS = (("soundstream_encoder", (320,), 0.1), ("lyragan", (1, 64), 1.0))


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def model_dir():
    from lyra_tpu_torch.codec.engine import has_model_assets

    path = os.environ.get("LYRA_TPU_MODEL_PATH")
    if path and has_model_assets(path):
        return path, f"real weights from {path}"
    return FULL_FIXTURE, ("synthetic full-width fixture, random weights "
                          "(tests/golden/synthetic_lyra/full)")


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from lyra_tpu_torch.ops import cuda_build

    t0 = time.time()
    sources = ("conv_stack.cu", "rvq_encode.cu")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        libs = list(pool.map(cuda_build.build, sources))
    ptxas = []
    for src in ("conv_stack", "rvq_encode"):
        with open(os.path.join(cuda_build.BUILD_DIR, f"{src}.ptxas.txt")) as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"build: ok, {len(libs)} libraries from lyra_tpu_torch/ops/csrc in "
          f"{time.time() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")


def phase_k1(path, batch, dev, stats):
    import torch

    from lyra_tpu_torch.ops import conv_stack
    from lyra_tpu_torch.ops.fused_stack import FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(1)
    worst = {}
    for name, shape, scale in MODELS:
        p = os.path.join(path, f"{name}.tflite")
        fused, plain = FusedStack(p, device=dev), load_graph(p, device=dev)
        fs, ps = fused.init_state(64), plain.init_state(64)
        err = 0.0
        for _ in range(20):
            x = torch.tensor(rng.normal(0.0, scale, (64,) + shape),
                             dtype=torch.float32, device=dev)
            y, fs = fused(fs, x)
            o, ps = plain(ps, input_audio=x)
            r = o["output_0"]
            rel = ((y - r).abs().max() / r.abs().max()).item()
            check(bool(torch.isfinite(y).all()), f"K1 {name}: non-finite")
            check(rel <= REL_TOL, f"K1 {name}: rel err {rel} > {REL_TOL}")
            err = max(err, rel)
        worst[name] = err
        # Every kernel call of one hop at the main path's batch, vs plain.
        for kernel, fn, plain_fn, (t_in, c_in), w, bias, extra in \
                fused.conv_launches():
            x = torch.randn((batch, t_in, c_in), device=dev)
            got, ref = fn(x, w, bias, *extra), plain_fn(x, w, bias, *extra)
            tol = REL_TOL * ref.abs().max().item()
            abs_err = (got - ref).abs().max().item()
            check(abs_err <= tol, f"K1 {kernel.name} {tuple(x.shape)}: "
                  f"abs err {abs_err} > {tol}")
            s = stats[kernel.name]
            s["max_abs_err"] = max(s["max_abs_err"], abs_err)
            s["ms"] += cuda_ms(lambda: fn(x, w, bias, *extra))
            s["plain_ms"] += cuda_ms(lambda: plain_fn(x, w, bias, *extra))
            s["calls"] += 1
    print(f"K1 vs plain: ok, max rel err soundstream "
          f"{worst['soundstream_encoder']:.3e}, lyragan {worst['lyragan']:.3e} "
          f"(B=64, 20 frames, bar {REL_TOL}); per-hop kernel calls at "
          f"B={batch}: {_calls(stats, conv_stack.KERNELS_F32)}")


def _calls(stats, kernels) -> str:
    return ", ".join(
        f"{k.name} {stats[k.name]['calls']} calls {stats[k.name]['ms']:.4f} "
        f"ms vs plain {stats[k.name]['plain_ms']:.4f} ms, max abs err "
        f"{stats[k.name]['max_abs_err']:.3e}" for k in kernels)


def phase_k1_bf16(path, batch, dev, stats, gpu):
    import torch

    from lyra_tpu_torch.ops import conv_stack
    from lyra_tpu_torch.ops.fused_stack import FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(4)
    lines, calls = [], []
    for name, shape, scale in MODELS:
        p = os.path.join(path, f"{name}.tflite")
        fused = FusedStack(p, mode="bf16", device=dev)
        plain16 = load_graph(p, mode="bf16", device=dev)
        plain32 = load_graph(p, device=dev)
        fs, s16, s32 = (fused.init_state(64), plain16.init_state(64),
                        plain32.init_state(64))
        err16 = err32 = plain_dev = 0.0
        for _ in range(20):
            x = torch.tensor(rng.normal(0.0, scale, (64,) + shape),
                             dtype=torch.float32, device=dev)
            y, fs = fused(fs, x)
            o16, s16 = plain16(s16, input_audio=x)
            o32, s32 = plain32(s32, input_audio=x)
            r16, r32 = o16["output_0"], o32["output_0"]
            check(bool(torch.isfinite(y).all()), f"K1-bf16 {name}: non-finite")
            err16 = max(err16, rel_err(y, r16))
            err32 = max(err32, rel_err(y, r32))
            plain_dev = max(plain_dev, rel_err(r16, r32))
        bar = bf16_bar(plain_dev)
        check(err16 <= bar, f"K1-bf16 {name}: vs plain bf16 {err16} > {bar}")
        check(err32 <= bar, f"K1-bf16 {name}: vs plain f32 {err32} > {bar}")
        lines.append(f"{name} vs plain bf16 {err16:.3e}, vs plain f32 "
                     f"{err32:.3e}, plain bf16 vs plain f32 {plain_dev:.3e}, "
                     f"bar {bar:.3e}")
        # Every bf16 kernel call of one hop at the main path's batch.
        for kernel, fn, plain_fn, (t_in, c_in), w, bias, extra in \
                fused.conv_launches():
            x = torch.randn((batch, t_in, c_in), device=dev,
                            dtype=torch.bfloat16)
            got, ref = fn(x, w, bias, *extra), plain_fn(x, w, bias, *extra)
            check(got.dtype == ref.dtype == torch.bfloat16,
                  f"K1-bf16 {kernel.name}: dtype {got.dtype}")
            tol = BF16_CALL_TOL * ref.float().abs().max().item()
            abs_err = (got.float() - ref.float()).abs().max().item()
            check(abs_err <= tol, f"K1-bf16 {kernel.name} {tuple(x.shape)}: "
                  f"abs err {abs_err} > {tol}")
            s = stats[kernel.name]
            s["max_abs_err"] = max(s["max_abs_err"], abs_err)
            s["calls"] += 1
            calls.append((kernel.name, partial(fn, x, w, bias, *extra),
                          partial(plain_fn, x, w, bias, *extra),
                          _work(kernel.name, x.shape, w, extra, ref.shape)))
    print(f"K1-bf16 vs plain: ok, max rel err {'; '.join(lines)} (B=64, 20 "
          f"frames); per-hop bf16 kernel calls at B={batch} within "
          f"{BF16_CALL_TOL} x max|ref|: "
          + ", ".join(f"{k.name} {stats[k.name]['calls']} calls max abs err "
                      f"{stats[k.name]['max_abs_err']:.3e}"
                      for k in conv_stack.KERNELS_BF16))
    _time_rounds(calls, conv_stack.KERNELS_BF16, batch, stats, gpu)


def _work(name, x_shape, w, extra, out_shape):
    """(FLOP, activation bytes in + out) of one bf16 conv call."""
    b, t_in, _ = x_shape
    nbytes = 2 * (int(np.prod(x_shape)) + int(np.prod(out_shape)))
    t_out = out_shape[1]
    if name.startswith("depthwise"):
        k, c = w.shape
        return 2 * b * t_out * c * k, nbytes
    k, i, o = w.shape
    if name.startswith("transpose"):  # only the taps that land
        s = extra[0]
        taps = sum(1 for t in range(t_out)
                   for kk in range(t % s, min(k, t + 1), s)
                   if (t - kk) // s < t_in)
        return 2 * b * taps * i * o, nbytes
    return 2 * b * t_out * k * i * o, nbytes


def _graph(fn, reps):
    """A CUDA graph of `reps` calls of fn: its replay times the device work
    without the host's launch gaps."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g


def _time_rounds(calls, kernels, batch, stats, gpu):
    """Per-hop ms of each kernel and of its plain version, summed over the
    hop's `calls` (name, kernel fn, plain fn, work), in ROUNDS rounds that
    alternate which goes first; each as eager launches (as the tick makes
    them) and as CUDA-graph replays (device time, no launch gaps).  Sets
    stats[name]["ms"/"plain_ms"] to the eager medians."""
    timers = []  # per call: path → how → () → ms of one call
    for _, fn, plain_fn, _ in calls:
        timers.append({})
        for path, f in (("kernel", fn), ("plain", plain_fn)):
            g = _graph(f, ROUND_REPS)
            timers[-1][path] = {
                "eager": partial(cuda_ms, f, ROUND_REPS, 1),
                "graph": lambda g=g: cuda_ms(g.replay, 1, 0) / ROUND_REPS}
    names = [k.name for k in kernels]
    ms = {(n, path, how): [] for n in names for path in ("kernel", "plain")
          for how in ("eager", "graph")}
    for r in range(ROUNDS):
        for path in ("kernel", "plain")[::1 if r % 2 == 0 else -1]:
            for how in ("eager", "graph"):
                tot = dict.fromkeys(names, 0.0)
                for (name, *_), timer in zip(calls, timers):
                    tot[name] += timer[path][how]()
                for n in names:
                    ms[(n, path, how)].append(tot[n])
    del timers
    out = []
    for n in names:
        flop = sum(c[3][0] for c in calls if c[0] == n)
        nbytes = sum(c[3][1] for c in calls if c[0] == n)
        parts = []
        for how in ("eager", "graph"):
            k, p = ms[(n, "kernel", how)], ms[(n, "plain", how)]
            won = sum(a < b for a, b in zip(k, p))
            km = float(np.median(k))
            parts.append(
                f"{how} kernel {km:.4f} ms ({min(k):.4f}-{max(k):.4f}) vs "
                f"plain {np.median(p):.4f} ms ({min(p):.4f}-{max(p):.4f}), "
                f"kernel faster in {won} of {ROUNDS}, "
                f"{flop / (km * 1e-3) / PEAK_BF16_FLOPS:.2%} of bf16 peak, "
                f"{nbytes / (km * 1e-3) / PEAK_HBM_BYTES:.2%} of HBM rate")
        stats[n]["ms"] = float(np.median(ms[(n, "kernel", "eager")]))
        stats[n]["plain_ms"] = float(np.median(ms[(n, "plain", "eager")]))
        out.append(f"{n} ({stats[n]['calls']} calls, {flop / 1e9:.3f} GFLOP, "
                   f"{nbytes / 1e6:.1f} MB activations in+out): "
                   + "; ".join(parts))
    print(f"K1-bf16 timing: per hop at B={batch}, medians (min-max) of "
          f"{ROUNDS} alternating rounds of {ROUND_REPS} calls each, shares "
          f"of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s and "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s [{gpu}]: " + " | ".join(out))


def rel_err(got, ref) -> float:
    """max|got − ref| / max|ref|, in float32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def bf16_bar(plain_dev: float) -> float:
    """3e-2, or 1.5 × the plain bf16 path's measured deviation from the
    plain f32 path where that is larger (random full-width weights)."""
    return max(BF16_REL_TOL, 1.5 * plain_dev)


def phase_k2(rvq, batch, dev, stats):
    import torch

    from lyra_tpu_torch.ops import rvq_kernel

    b = 4096
    feats = torch.tensor(np.random.default_rng(2).normal(0.0, 1.0, (b, 64)),
                         dtype=torch.float32, device=dev)
    cb, c2 = rvq.codebooks, rvq.c2
    got = rvq_kernel.rvq_encode(feats, cb, c2, 46)
    ref = rvq_kernel.rvq_encode_plain(feats, cb, c2, 46)
    rows = (got != ref).any(dim=1)
    n_diff = int(rows.sum().item())
    check(n_diff <= b // 1000, f"K2: {n_diff} of {b} rows differ")
    # A differing row must start at a near-tie of the plain scores.
    for r in torch.nonzero(rows).flatten().tolist():
        s = int(torch.nonzero(got[r] != ref[r])[0].item())
        resid = feats[r].double() - sum(
            (cb[j, ref[r, j]].double() for j in range(s)),
            torch.zeros(64, dtype=torch.float64, device=dev))
        scores = c2[s].double() - 2.0 * cb[s].double() @ resid
        top = torch.sort(scores).values[:2]
        check(abs((top[1] - top[0]).item()) < 1e-5 * max(abs(top[0].item()), 1.0),
              f"K2: row {r} differs at stage {s} without a near-tie")
    recon = (rvq.decode(got) - rvq.decode(ref)).abs().max().item()
    s = stats["rvq_encode"]
    s["max_abs_err"] = recon
    x = feats[:batch].contiguous()  # timed at the main path's batch
    s["ms"] = cuda_ms(lambda: rvq_kernel.rvq_encode(x, cb, c2, 46))
    s["plain_ms"] = cuda_ms(lambda: rvq_kernel.rvq_encode_plain(x, cb, c2, 46))
    s["calls"] = 1
    print(f"K2 vs plain: ok, {n_diff} of {b} rows differ (near-ties), "
          f"reconstruction max abs diff {recon:.3e}; B={x.shape[0]}: kernel "
          f"{s['ms']:.4f} ms vs plain {s['plain_ms']:.4f} ms")


def phase_rates(batch, dev):
    import torch

    from lyra_tpu_torch.dsp.resampler import Resampler

    data = np.load(os.path.join(REPO, "tests", "golden",
                                "resampler_goldens.npz"))
    worst = {}
    for key in sorted({k[3:] for k in data.files if k.startswith("in_")}):
        rates = tuple(int(v) for v in key.split("_"))
        r = Resampler(*rates, device=dev)
        x, want = data[f"in_{key}"], data[f"out_{key}"]
        block = rates[0] // 50
        state, got = r.init_state(x.shape[0]), []
        for i in range(x.shape[1] // block):
            y, state = r.resample(state, torch.tensor(
                x[:, i * block:(i + 1) * block], device=dev))
            got.append(y.cpu().numpy())
        got = np.concatenate(got, axis=1)
        check(got.shape == want.shape, f"rates {key}: shape {got.shape}")
        worst[key] = float(np.abs(got - want).max())
        check(worst[key] <= GOLDEN_TOL,
              f"rates {key}: {worst[key]} > {GOLDEN_TOL} vs goldens")
    # A fleet's streaming run vs the single-stream numpy path.
    hops, rows = 50, list(range(0, batch, 64))
    stream = {}
    for rates in ((RATE_BF16, 16000), (16000, RATE_BF16)):
        r = Resampler(*rates, device=dev)
        block = rates[0] // 50
        rng = np.random.default_rng(rates[0])
        x = np.clip(rng.normal(0.0, 3000.0, (batch, hops * block)),
                    -32768, 32767).astype(np.float32)
        xd = torch.tensor(x, device=dev)
        state, got = r.init_state(batch), []
        for i in range(hops):
            y, state = r.resample(state, xd[:, i * block:(i + 1) * block])
            got.append(y)
        got = torch.cat(got, dim=1)[rows].cpu().numpy()
        ref = np.stack([r.resample_np(x[row]) for row in rows])
        key = f"{rates[0]}_{rates[1]}"
        stream[key] = float(np.abs(got - ref).max())
        check(stream[key] <= GOLDEN_TOL,
              f"rates {key} streaming: {stream[key]} > {GOLDEN_TOL}")
    print(f"rates: ok, max abs dev vs goldens (int16 scale, bar {GOLDEN_TOL}) "
          f"{worst}; B={batch} x {hops} hops streaming vs numpy on "
          f"{len(rows)} rows {stream}")


def _inputs(batch, ticks, dev, hop=320):
    import torch

    rng = np.random.default_rng(3)
    gain = np.where(rng.random((ticks, batch, 1)) < 0.8, 3000.0, 300.0)
    audio = torch.tensor(rng.normal(0.0, 1.0, (ticks, batch, hop)) * gain,
                         dtype=torch.float32, device=dev)
    lost = rng.random((ticks, batch)) < 0.09
    lost[ticks // 2:ticks // 2 + 8, ::16] = True  # bursts reach comfort noise
    return audio, torch.tensor(~lost, device=dev)


def _tick(enc, dec, es, ds, audio, received, num_bits):
    import torch

    from lyra_tpu_torch import packet

    nq = num_bits // 4
    idx, _, es = enc.step(es, audio, nq)
    wire = packet.pack_wire_device(idx, num_bits)
    dec_idx = torch.full_like(idx, -1)
    dec_idx[:, :nq] = packet.unpack_wire_device(wire, num_bits)
    out, cn, ds = dec.step(ds, dec_idx, received)
    return out, cn, es, ds, dec_idx


def _drive(enc, dec, kernels, batch, ticks, dev, profile_file):
    """Run `ticks` ticks of the slice at `batch` with every launch count set
    to 0 just before and read just after; the last 3 ticks under
    torch.profiler.  Checks launches, kernel names, shape, finiteness and
    speech level; returns (launches, summary)."""
    import torch

    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    audio, received = _inputs(batch, ticks, dev, enc.hop_samples)
    lost = 1.0 - received.float().mean().item()
    es, ds = enc.init_state(batch), dec.init_state(batch)
    num_bits = 120
    outs, cn_count = [], 0
    prof_window = range(ticks - 3, ticks)
    every = conv_stack.KERNELS + rvq_kernel.KERNELS
    for k in every:
        k.launches = 0
    for t in range(ticks):
        if t == prof_window.start:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        out, cn, es, ds, _ = _tick(enc, dec, es, ds, audio[t], received[t],
                                   num_bits)
        outs.append(out)
        cn_count += int(cn.sum().item())
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    launches = {k.name: k.launches for k in every}
    for k in kernels:
        check(launches[k.name] > 0, f"main path never launched {k.name}")
    others = {n: c for n, c in launches.items()
              if c and n not in {k.name for k in kernels}}
    check(not others, f"main path launched kernels of another mode {others}")

    out = torch.stack(outs)
    check(out.shape == (ticks, batch, enc.hop_samples),
          f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "main path: non-finite audio")
    rms = out[10:].float().pow(2).mean().sqrt().item()
    check(300.0 <= rms <= 15000.0, f"main path: RMS {rms} not speech-level")

    events = prof.key_averages()
    cuda_names = [e.key for e in events
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    check(bool(cuda_names), "profiler recorded no CUDA events")
    # A kernel's own name, not a longer one that contains it (demangled
    # "ns::conv1d_fwd(" or mangled "10conv1d_fwdE").
    seen = {k.name: any(re.search(rf"(?<![A-Za-z_]){k.name}(?![a-z0-9_])", n)
                        for n in cuda_names)
            for k in kernels}
    check(all(seen.values()), f"profiler: kernels missing {seen}")
    if profile_file:
        os.makedirs(os.path.dirname(profile_file), exist_ok=True)
        with open(profile_file, "w") as f:
            f.write(events.table(sort_by="cuda_time_total", row_limit=60))
    return {k.name: launches[k.name] for k in kernels}, (
        f"B={batch} x {ticks} ticks at {enc.sample_rate_hz} Hz, {lost:.1%} "
        f"of hops lost, audio RMS {rms:.1f} (int16), {cn_count} "
        f"comfort-noise stream-hops; launches "
        f"{ {k.name: launches[k.name] for k in kernels} }; kernel names in "
        f"profiler: {', '.join(seen)}")


def phase_main(path, batch, ticks, dev, profile_out):
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    enc = EncoderEngine(16000, path, device=dev)
    dec = DecoderEngine(16000, path, device=dev)
    launches, summary = _drive(
        enc, dec, conv_stack.KERNELS_F32 + rvq_kernel.KERNELS, batch, ticks,
        dev, profile_out and os.path.join(profile_out,
                                          "chip_smoke_profile.txt"))
    audio, received = _inputs(batch, ticks, dev)
    num_bits = 120

    # Correctness against the plain path: the same indices through the
    # plain decoder agree with the kernel decoder within 2 int16 LSB.
    b_ref = min(batch, 64)
    enc_p = EncoderEngine(16000, path, backend="plain", device=dev)
    dec_p = DecoderEngine(16000, path, backend="plain", device=dev)
    es, ds = enc.init_state(b_ref), dec.init_state(b_ref)
    esp, dsp = enc_p.init_state(b_ref), dec_p.init_state(b_ref)
    worst_lsb, same_idx = 0.0, 0.0
    for t in range(10):
        a, r = audio[t, :b_ref], received[t, :b_ref]
        out_k, _, es, ds, idx_k = _tick(enc, dec, es, ds, a, r, num_bits)
        idx_p, _, esp = enc_p.step(esp, a, num_bits // 4)
        same_idx += (idx_p == idx_k).all(dim=1).float().mean().item() / 10
        out_p, _, dsp = dec_p.step(dsp, idx_k, r)
        worst_lsb = max(worst_lsb, (out_k - out_p).abs().max().item())
    check(worst_lsb <= 2.0, f"kernel vs plain decoder: {worst_lsb} LSB")
    check(same_idx >= 0.99, f"kernel vs plain encoder: {same_idx:.4f} rows "
          f"with identical indices")
    print(f"main path: ok, {summary}; vs plain path (B={b_ref}, 10 "
          f"ticks): rows with identical indices {same_idx:.4f}, decoder max "
          f"diff {worst_lsb} LSB")
    return launches


def _features(enc, state, audio):
    """The encoder's resample → clip → SoundStream features from `state`,
    without advancing it."""
    from lyra_tpu_torch.dsp import utils as dsp_utils

    x, _ = enc.resampler.resample(state["resampler"], audio)
    x = dsp_utils.int16_to_unit(dsp_utils.clip_to_int16(x))
    return enc.soundstream.extract(state["soundstream"], x)[0]


def _as_float(tree):
    """A bf16 engine's state tree with its bf16 leaves widened to float32,
    for the float engines."""
    import torch

    if isinstance(tree, dict):
        return {k: _as_float(v) for k, v in tree.items()}
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def phase_main_bf16(path, batch, ticks, dev, profile_out):
    """The bf16 slice at 48 kHz, then the kernel path vs the plain bf16 path
    from identical inputs: each tick the plain engines start from the
    kernel engines' pre-tick state (and the plain f32 engines from the same
    state widened), so a discrete decision cannot carry a difference."""
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    rate, num_bits = RATE_BF16, 120
    nq = num_bits // 4
    enc = EncoderEngine(rate, path, mode="bf16", device=dev)
    dec = DecoderEngine(rate, path, mode="bf16", device=dev)
    launches, summary = _drive(
        enc, dec, conv_stack.KERNELS_BF16 + rvq_kernel.KERNELS, batch, ticks,
        dev, profile_out and os.path.join(profile_out,
                                          "chip_smoke_profile_bf16.txt"))

    b_ref = min(batch, 64)
    audio, received = _inputs(b_ref, 10, dev, enc.hop_samples)
    plain = {mode: (EncoderEngine(rate, path, backend="plain", mode=mode,
                                  device=dev),
                    DecoderEngine(rate, path, backend="plain", mode=mode,
                                  device=dev))
             for mode in ("bf16", "float")}
    (enc_p, dec_p), (enc_f, dec_f) = plain["bf16"], plain["float"]
    es, ds = enc.init_state(b_ref), dec.init_state(b_ref)
    err = {"features": 0.0, "audio": 0.0}
    plain_dev = {"features": 0.0, "audio": 0.0}
    for t in range(10):
        a, r = audio[t], received[t]
        f_k, f_p = _features(enc, es, a), _features(enc_p, es, a)
        f_f = _features(enc_f, _as_float(es), a)
        err["features"] = max(err["features"], rel_err(f_k, f_p))
        plain_dev["features"] = max(plain_dev["features"], rel_err(f_p, f_f))
        # Indices from identical features: K2 vs the plain search.
        idx_k = enc.rvq.quantize(f_p, nq, method="kernel")
        idx_p = enc_p.rvq.quantize(f_p, nq, method="fast")
        check(torch.equal(idx_k, idx_p),
              f"main-bf16: indices differ from identical features, tick {t}")
        # Decoder audio from identical indices and pre-tick state.
        out_k, _, ds_next = dec.step(ds, idx_k, r)
        out_p, _, _ = dec_p.step(ds, idx_k, r)
        out_f, _, _ = dec_f.step(_as_float(ds), idx_k, r)
        err["audio"] = max(err["audio"], rel_err(out_k, out_p))
        plain_dev["audio"] = max(plain_dev["audio"], rel_err(out_p, out_f))
        _, _, es = enc.step(es, a, nq)
        ds = ds_next
    bars = {k: bf16_bar(v) for k, v in plain_dev.items()}
    for k in err:
        check(err[k] <= bars[k], f"main-bf16: kernel vs plain bf16 {k} "
              f"rel err {err[k]} > {bars[k]}")
    print(f"main-bf16 path: ok, {summary}; vs plain bf16 path (B={b_ref}, 10 "
          f"ticks, identical inputs): indices identical, max rel err "
          f"features {err['features']:.3e}, audio {err['audio']:.3e}; plain "
          f"bf16 vs plain f32: features {plain_dev['features']:.3e}, audio "
          f"{plain_dev['audio']:.3e}; bars {bars}")
    return launches


def phase_timing(path, batch, dev, gpu):
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine

    res = {}
    for rate, mode in ((16000, "float"), (RATE_BF16, "bf16")):
        paths = {}
        for backend in ("kernel", "plain"):
            enc = EncoderEngine(rate, path, backend=backend, mode=mode,
                                device=dev)
            dec = DecoderEngine(rate, path, backend=backend, mode=mode,
                                device=dev)
            paths[backend] = [enc, dec, enc.init_state(batch),
                              dec.init_state(batch), []]
        audio, received = _inputs(batch, 20, dev, paths["kernel"][0].hop_samples)
        # Turns: plain, kernel, kernel, plain — 20 ticks each after warm-up.
        for backend in ("plain", "kernel", "kernel", "plain"):
            enc, dec, es, ds, times = paths[backend]
            for t in range(23):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, es, ds, _ = _tick(enc, dec, es, ds, audio[t % 20],
                                        received[t % 20], 120)
                torch.cuda.synchronize()
                if t >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            paths[backend][2:4] = [es, ds]
        for backend, (_, _, _, _, times) in paths.items():
            res[(mode, rate, backend)] = (float(np.percentile(times, 50)),
                                          float(np.percentile(times, 99)))
        del paths
    print(f"timing: B={batch} encode+wire+decode per tick, 40 ticks each: " +
          "; ".join(f"{mode} {rate // 1000} kHz {backend} p50 {p50:.3f} ms "
                    f"p99 {p99:.3f} ms"
                    for (mode, rate, backend), (p50, p99) in res.items()) +
          f" [{gpu}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-out", default=None,
                    help="directory for the profiler's kernel tables")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    path, weights = model_dir()
    print(f"weights: {weights}")
    gpu = gpu_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} [{gpu}]")

    phase_build()
    kernels = conv_stack.KERNELS + rvq_kernel.KERNELS
    stats = {k.name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "calls": 0} for k in kernels}
    phase_k1(path, BATCH, dev, stats)
    phase_k1_bf16(path, BATCH, dev, stats, gpu)
    phase_k2(ResidualVectorQuantizer.from_model_path(path, dev), BATCH, dev,
             stats)
    phase_rates(BATCH, dev)
    launches = phase_main(path, BATCH, TICKS, dev, args.profile_out)
    launches_bf16 = phase_main_bf16(path, BATCH, TICKS, dev, args.profile_out)
    for name, n in launches_bf16.items():
        launches[name] = launches.get(name, 0) + n
    phase_timing(path, BATCH, dev, gpu)

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": stats[k.name]["max_abs_err"],
         "ms": stats[k.name]["ms"], "plain_ms": stats[k.name]["plain_ms"]}
        for k in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
