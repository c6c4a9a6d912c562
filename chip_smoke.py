#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (lyra_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-out DIR]

Drives the port's main path — the lockstep codec tick: EncoderEngine.step
→ device wire pack → unpack → DecoderEngine.step, each step one CUDA-graph
replay (utils/capture.py) — and the serving path over it (EncoderServer.
tick_wire → DecoderServer.tick_wire) at the full width of the Lyra v2
models: the real weights when LYRA_TPU_MODEL_PATH names a directory that
holds them, otherwise the synthetic full-width fixture
(tests/golden/synthetic_lyra/full, random weights from a seed).

Phases, one line each; any failed check raises and exits nonzero:
  1. build    the CUDA kernels from lyra_tpu_torch/ops/csrc with nvcc, one
              process per source, started together;
  2. K1       the fused conv stack vs the plain executor (SoundStream and
              LyraGAN, B=64, 20 frames, state carried, TF32 off; bar
              1e-5 × max|plain|); bitwise equal to the unfused kernel path
              (the same kernels without fused operands, every other op a
              torch op), output and state, over 20 frames at B=64 and
              B=1024; one eager hop at B=1024 under torch.profiler, whose
              span around the core ("fused_stack.core") must hold only
              conv-stack kernels, one per launch of the plan; then every
              fused launch of one hop at B=1024 on random operands of its
              shapes vs its plain version (the graph's torch ops around
              the plain conv, TF32 off; bar 1e-5 × max|plain|, new state
              rows bitwise), timed per hop in 7 alternating rounds
              (kernel, plain and the same torch ops around one cuDNN call
              with the weights laid out beforehand; eager launches and
              CUDA-graph replays), with each kernel's FLOP, bytes (the
              fused operands: state and x rows read, residual, output and
              new state rows), bound and shares of 67 TFLOP/s FP32 and
              3.35 TB/s; each depthwise launch's plan is printed, checked
              against conv_stack.depthwise_plan, and its two launches must
              give the same bits;
  3. K1-bf16  the same in bf16 mode: the fused stack vs the plain bf16
              executor and vs the plain f32 one (bar 3e-2 × max|plain|),
              the profiled hop's core span, then every bf16 fused launch
              of one hop at B=1024 vs its plain bf16 version (bar 2^-7 ×
              max|ref|: the plain version rounds after every op, the
              kernel once), timed and checked the same way, with shares of
              989 TFLOP/s bf16 and 3.35 TB/s;
  4. K2       the RVQ kernel vs its plain version at B=4096: rows may
              differ only at near-ties, at most 0.1% of rows; then timed
              at B=1024 the same way (no single PyTorch call computes the
              search, so it has no library time), and as single launches
              after an L2 flush (cold) and after a spin (warm), with the
              SM clock sampled by nvidia-smi while it is timed;
  5. rates    the resampler on the card vs tests/golden/resampler_goldens
              .npz at all six rate pairs (bar 0.05 at int16 scale), then a
              B=1024, 50-hop streaming run at 16↔48 kHz vs the
              single-stream numpy path;
  6. main     the float engines at 16 kHz: 50 ticks of the fresh
              engines' captured `step` at B=1024 with ~10% of hops lost,
              launch counts reset just before and read just after (a
              replay runs no wrapper, so they count the run's warm-up and
              two captures of each step: 3 × the launches per tick), the
              last 3 ticks in a torch.profiler window that must name each
              kernel and count 1/3 of its launches in the replays (it also
              gives device µs per tick, all kernels and each of the
              path's, and the count of all CUDA kernels per replayed tick,
              beside that of fresh engines whose cores run unfused;
              the SM clock is sampled over the 50 ticks), then 3 eager
              ticks under the profiler, whose kernels' device time is
              split into the conv stacks' core spans and the rest, output
              finite at speech level,
              and the kernel path's decoder vs the plain path's on the
              same indices (within 2 int16 LSB);
  7. main-bf16  the same slice in bf16 mode at 48 kHz (the JAX package's
              serving mode, a 48 kHz fleet), then vs the plain bf16 path
              at B=64 from identical inputs: features and decoder audio
              within 3e-2 × max|plain|, indices identical;
  8. timing   p50/p99 ms per tick, kernel path vs plain path, float at
              16 kHz and bf16 at 48 kHz, both eager (engines without
              graphs, as before the capture);
  9. serve    EncoderServer.tick_wire → DecoderServer.tick_wire at B=1024,
              float at 16 kHz and bf16 at 48 kHz, 50 ticks with phase 6's
              loss pattern at 120 bits, 64 streams evicted at tick 10, 64
              admitted into their slots and 64 others evicted at tick 20,
              a save and a restore into a fresh server pair at tick 30:
              wire bytes, sizes, audio and comfort-noise flags bitwise
              equal to the same run on eager engines, launch counts reset
              before the captured run and read after it (the captures'
              launches), the async pipelines equal to it one tick later
              (a re-admitted slot drains silence), the four kernel
              families named in a profiler window over replayed ticks;
              then eager vs captured tick wall time p50/p99 in turns
              eager, captured, async, async, captured, eager of
              SERVE_TIMED ticks each (async: the captured pair's
              tick_wire_async pipelines), with device time per tick from
              the profiler, the idle share (1 − device / p50), the memory
              each server pair holds and peaks at, and the captured engine
              steps' device span per tick run back to back.
The 3e-2 bars were measured on the small fixture; where the full fixture
needs more room, the bar becomes 1.5 × the deviation of the plain bf16
path from the plain f32 path on the same inputs, measured in the same
phase (both numbers are printed).
Then one JSON line with every kernel (per hop at B=1024: kernel, plain
and library time as eager medians in ms/plain_ms/library_ms and as
graph-replay medians in graph_ms/plain_graph_ms/library_graph_ms, the
cold-L2 single launch in cold_ms where measured, bound and what sets it,
`launches`: the launches over the main paths' runs of phases 6 and 7,
and `launches_per_tick`: the launches per replayed tick in those runs'
profiler windows, both summed over the two phases), the card's name and
power limit, and as the last line
{"ok": true, "device": {...}}.

Exits nonzero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FULL_FIXTURE = os.path.join(REPO, "tests", "golden", "synthetic_lyra", "full")
REL_TOL = 1e-5
BF16_REL_TOL = 3e-2  # whole models and engines in bf16 vs plain
BF16_CALL_TOL = 2.0 ** -7  # one kernel call: two bf16 roundings
ROUNDS, ROUND_REPS = 7, 10  # kernel timing: alternating rounds, calls each
# H100 SXM data sheet: FP32 outside the tensor cores, bf16 tensor cores, HBM.
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 67e12, 989e12, 3.35e12
GOLDEN_TOL = 0.05  # resampler vs goldens, int16 scale (the JAX test's bar)
FLUSH_BYTES = 256 << 20  # written between cold launches: > 50 MB of L2
SPIN_CYCLES = 200_000  # the warm launches' wait, about as long as a flush
BATCH, TICKS = 1024, 50  # the main path's streams and ticks
SERVE_TIMED = 200  # timed server ticks per turn, phase 9
SERVE_CHURN = 64  # streams evicted and admitted, phase 9
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


class ClockSampler:
    """nvidia-smi's SM clock (MHz) every 20 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.mhz = [int(v) for v in out.split() if v.isdigit()]

    def summary(self) -> str:
        if not self.mhz:
            return "SM clock: no sample"
        return (f"SM clock {min(self.mhz)}-{max(self.mhz)} MHz, median "
                f"{np.median(self.mhz):.0f}, {len(self.mhz)} samples")


def single_launch_ms(fn, before, reps: int = 20) -> float:
    """Median ms of `reps` single calls of fn, each between its own CUDA
    events, each right after `before()` on the same stream."""
    import torch

    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


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


def phase_k1(path, batch, dev, stats, gpu):
    import torch

    from lyra_tpu_torch.ops import conv_stack
    from lyra_tpu_torch.ops.fused_stack import FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(1)
    worst, calls, plans, lines = {}, [], [], []
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
        lines.append(f"{name}: {_bitwise_unfused(fused, shape, scale, dev)}; "
                     f"{_core_kernels(fused, shape, scale, batch, dev)}")
        # Every fused launch of one hop at the main path's batch, vs plain.
        calls += _fused_calls("K1", fused, batch, dev, torch.float32, REL_TOL,
                              stats, plans)
    print(f"K1 vs plain: ok, max rel err soundstream "
          f"{worst['soundstream_encoder']:.3e}, lyragan {worst['lyragan']:.3e} "
          f"(B=64, 20 frames, bar {REL_TOL}); {'; '.join(lines)}; per-hop "
          f"fused launches at B={batch} within {REL_TOL} x max|plain|, new "
          f"state rows bitwise: "
          + ", ".join(f"{k.name} {stats[k.name]['calls']} calls max abs err "
                      f"{stats[k.name]['max_abs_err']:.3e}"
                      for k in conv_stack.KERNELS_F32))
    _print_depthwise_plans("K1", batch, plans)
    _time_rounds("K1", calls, conv_stack.KERNELS_F32, batch, stats, gpu,
                 PEAK_FP32_FLOPS, "FP32")


def phase_k1_bf16(path, batch, dev, stats, gpu):
    import torch

    from lyra_tpu_torch.ops import conv_stack
    from lyra_tpu_torch.ops.fused_stack import FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(4)
    lines, calls, plans = [], [], []
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
                     f"bar {bar:.3e}; "
                     f"{_core_kernels(fused, shape, scale, batch, dev)}")
        # Every bf16 fused launch of one hop at the main path's batch.
        calls += _fused_calls("K1-bf16", fused, batch, dev, torch.bfloat16,
                              BF16_CALL_TOL, stats, plans)
    print(f"K1-bf16 vs plain: ok, max rel err {'; '.join(lines)} (B=64, 20 "
          f"frames); per-hop bf16 fused launches at B={batch} within "
          f"{BF16_CALL_TOL} x max|ref|, new state rows bitwise: "
          + ", ".join(f"{k.name} {stats[k.name]['calls']} calls max abs err "
                      f"{stats[k.name]['max_abs_err']:.3e}"
                      for k in conv_stack.KERNELS_BF16))
    _print_depthwise_plans("K1-bf16", batch, plans)
    _time_rounds("K1-bf16", calls, conv_stack.KERNELS_BF16, batch, stats, gpu,
                 PEAK_BF16_FLOPS, "bf16")


def _bitwise_unfused(fused, shape, scale, dev):
    """In f32 the fused stack gives the bits of the unfused kernel path
    (the same kernels without fused operands, every other op a torch op):
    output and every state leaf, 20 frames with state carried, at B=64 and
    at the main path's batch."""
    import torch

    rng = np.random.default_rng(6)
    for b in (64, BATCH):
        fs = us = fused.init_state(b)
        for t in range(20):
            x = torch.tensor(rng.normal(0.0, scale, (b,) + shape),
                             dtype=torch.float32, device=dev)
            y, fs = fused(fs, x)
            u, us = fused.unfused(us, x)
            check(torch.equal(y, u), f"K1 fused vs unfused: output differs "
                  f"at B={b}, frame {t}")
            for k in us:
                check(torch.equal(fs[k], us[k]), f"K1 fused vs unfused: "
                      f"state {k} differs at B={b}, frame {t}")
    return "f32 fused stack bitwise equal to the unfused kernel path (B=64 " \
           f"and B={BATCH}, 20 frames, output and state)"


def _core_kernels(fused, shape, scale, batch, dev):
    """One eager hop under torch.profiler: every CUDA kernel inside the
    core's span (CORE_SPAN, the record_function around the plan's
    launches, as the profiler places it on the device's timeline) must be
    a conv-stack kernel, one per launch of the plan."""
    import torch

    from lyra_tpu_torch.ops import conv_stack

    x = torch.tensor(np.random.default_rng(8).normal(0.0, scale,
                                                     (batch,) + shape),
                     dtype=torch.float32, device=dev)
    state = fused.init_state(batch)
    fused(state, x)  # warm-up: cuDNN's first calls
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused(state, x)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == cuda]
    spans = [e for e in dev_events if e.name == CORE_SPAN]
    check(len(spans) == 1, f"profiler: {len(spans)} device spans of the core")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    inside = [e.name for e in dev_events if e is not spans[0]
              and lo <= e.time_range.start and e.time_range.end <= hi]
    foreign = [n for n in inside
               if not any(_own(k, n) for k in conv_stack.KERNELS)]
    check(not foreign, f"profiler: kernels other than the conv-stack "
          f"kernels inside the core's span: {sorted(set(foreign))}")
    check(len(inside) == len(fused.plan),
          f"profiler: {len(inside)} kernels in the core's span for "
          f"{len(fused.plan)} launches")
    return (f"profiled eager hop at B={batch}: the core's span holds "
            f"{len(inside)} CUDA kernels, all conv-stack kernels, one per "
            f"launch")


def _fused_calls(phase, fused, batch, dev, dtype, bar, stats, plans):
    """Each fused launch of one hop at `batch` on random operands of its
    shapes vs its plain version (|err| ≤ bar × max|plain|; the new state
    rows bit for bit) and vs the library yardstick; → the timing calls."""
    import torch

    from lyra_tpu_torch.ops import conv_stack

    gen = torch.Generator(device=dev).manual_seed(9)
    calls = []
    for launch in fused.plan:
        t_x, c_x = launch.x_shape

        def rand(*shape):
            return torch.randn(shape, device=dev, generator=gen).to(dtype)

        x = rand(batch, t_x, c_x)
        state = res = None
        if launch.state is not None:
            state = rand(batch, launch.in_shape[0] - t_x, c_x)
        if launch.res is not None:
            res = rand(batch, *launch.out_shape)
        got, ref = launch(x, state, res), launch.plain(x, state, res)
        out, side = got if launch.side else (got, None)
        ref_out, ref_side = ref if launch.side else (ref, None)
        name = f"{phase} {launch.kernel.name} (op {launch.op})"
        check(out.dtype == ref_out.dtype == dtype, f"{name}: dtype {out.dtype}")
        check(side is None or torch.equal(side, ref_side),
              f"{name}: new state rows differ")
        tol = bar * ref_out.float().abs().max().item()
        abs_err = (out.float() - ref_out.float()).abs().max().item()
        check(abs_err <= tol, f"{name}: abs err {abs_err} > {tol}")
        s = stats[launch.kernel.name]
        s["max_abs_err"] = max(s["max_abs_err"], abs_err)
        s["calls"] += 1
        if launch.kind == "depthwise":
            plans.append(_depthwise_call(launch, (x, state, res), got))
        lib = partial(_library(launch), x, state, res)
        lib_out = lib()
        lib_out = lib_out[0] if launch.side else lib_out
        lib_err = (lib_out.float() - ref_out.float()).abs().max().item()
        check(lib_err <= tol, f"library {name}: abs err {lib_err}")
        calls.append((launch.kernel.name, partial(launch, x, state, res),
                      partial(launch.plain, x, state, res), lib,
                      _work(launch, x, state, res, out, side)))
    return calls


def _depthwise_call(launch, operands, got):
    """One fused depthwise launch: a second launch on the same operands
    must give the same bits, and the plan the launcher took for them
    (lyra_depthwise_plan, given the pointers, all 16-byte aligned or not)
    must be conv_stack.depthwise_plan's.  Returns the plan, described."""
    import ctypes

    import torch

    from lyra_tpu_torch.ops import conv_stack

    x, state, res = operands
    out = got[0] if launch.side else got
    again = launch(*operands)
    again = again[0] if launch.side else again
    name = f"depthwise {launch.in_shape} d={launch.extra[0]}"
    check(torch.equal(again, out), f"{name}: two launches differ")
    b, (t_in, c) = x.shape[0], launch.in_shape
    k, d = launch.w.shape[0], launch.extra[0]
    ops = [x, launch.w, launch.bias, out, state, res]
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in ops)
    plan = conv_stack.depthwise_plan((b, t_in, c), k, d, dtype=x.dtype,
                                     aligned=aligned)
    got_plan = (ctypes.c_int * 7)()
    conv_stack._lib().lyra_depthwise_plan(
        x.element_size(), b, t_in - (k - 1) * d, c, k, d,
        *[None if t is None else t.data_ptr() for t in ops[:4]], got_plan)
    check(not aligned or tuple(got_plan) == (
        plan.elems, plan.runs, *plan.block, *plan.grid),
          f"{name}: launcher plan {tuple(got_plan)} vs {plan}")
    return (f"({t_in}, {c}, {d}) {'vector' if plan.vec else 'scalar'} "
            f"{plan.elems}/thread J={plan.runs} block {plan.block} grid "
            f"{plan.grid}")


def _print_depthwise_plans(phase, batch, plans):
    print(f"{phase} depthwise plans at B={batch}, (T_in, C, dilation), each "
          f"call's two launches bitwise equal: " + "; ".join(plans))


def _library(launch):
    """The library yardstick of one fused launch: the same torch ops as
    its plain version around one cuDNN call (F.conv2d or
    F.conv_transpose2d, TF32 off) on x [B, T, C] seen as [B, C, T, 1] in
    channels-last memory, as the plain version sees it, but with the
    weights laid out for torch once, here (channels-last too), and not in
    every call as the plain version does."""
    import torch
    import torch.nn.functional as F

    from lyra_tpu_torch.ops import conv_stack

    w, bias, extra, c_in = launch.w, launch.bias, launch.extra, \
        launch.in_shape[1]

    def once(w_t):
        return w_t.unsqueeze(-1).contiguous(memory_format=torch.channels_last)

    def nchw(x):
        return x.unsqueeze(2).permute(0, 3, 1, 2)  # [B, C, T, 1], no copy

    if launch.kind == "depthwise":
        w_t = once(w.t().unsqueeze(1))  # [C, 1, K, 1]

        def conv(x, *_):
            return F.conv2d(nchw(x), w_t, bias, dilation=(extra[0], 1),
                            groups=c_in).squeeze(3).transpose(1, 2)
    elif launch.kind == "tconv":
        stride, t_out = extra
        w_t = once(w.permute(1, 2, 0))  # [I, O, K, 1]

        def conv(x, *_):
            return F.conv_transpose2d(
                nchw(x), w_t, bias, stride=(stride, 1))[:, :, :t_out] \
                .squeeze(3).transpose(1, 2)
    else:
        w_t = once(w.permute(2, 1, 0))  # [O, I_f, K, 1]

        def conv(x, *_):
            return F.conv2d(nchw(x), w_t, bias, stride=(extra[0], 1),
                            groups=c_in // w.shape[1]).squeeze(3) \
                .transpose(1, 2)
    return lambda x, state, res: conv_stack.fused_plain(
        conv, x, w, bias, extra, launch.fusion(state, res))


def _work(launch, x, state, res, out, side):
    """(FLOP, bytes) of one fused launch: every input element it needs
    read once (of state and x the rows and channels some tap or the side
    store reads: where a depthwise conv's T_out < dilation, 3·T_out of its
    rows), the weights, bias and residual once, and the output and new
    state rows written once, in their element type."""
    b, e = x.shape[0], x.element_size()
    (t_in, c_in), c_x = launch.in_shape, launch.x_shape[1]
    c0 = launch.split[0] if launch.split else 0
    need = np.zeros((t_in, c_x), bool)
    k = launch.w.shape[0]
    if launch.kind == "depthwise":
        d = launch.extra[0]
        t_out = t_in - (k - 1) * d
        need[sorted({t + kk * d for t in range(t_out) for kk in range(k)})] = True
        flop = 2 * b * t_out * c_in * k
    elif launch.kind == "conv1d":
        s = launch.extra[0]
        t_out = (t_in - k) // s + 1
        need[:(t_out - 1) * s + k, c0:c0 + c_in] = True
        flop = 2 * b * t_out * k * launch.w.shape[1] * launch.w.shape[2]
    else:  # only the taps that land on the kept rows
        s, t_full = launch.extra
        lo, hi = launch.crop or (0, t_full)
        taps = [(t - kk) // s for t in range(lo, hi)
                for kk in range(t % s, min(k, t + 1), s)
                if (t - kk) // s < t_in]
        need[sorted(set(taps)), c0:c0 + c_in] = True
        flop = 2 * b * len(taps) * launch.w.shape[1] * launch.w.shape[2]
    if launch.side is not None:
        _, begin, rows = launch.side
        need[begin:begin + rows] = True
    nbytes = int(need.sum()) * b * e + sum(
        t.numel() * t.element_size()
        for t in (launch.w, launch.bias, res, out, side) if t is not None)
    return flop, nbytes


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


def _time_rounds(phase, calls, kernels, batch, stats, gpu, peak_flops,
                 peak_name):
    """Per-hop ms of each kernel, of its plain version and of its library
    call, summed over the hop's `calls` (name, kernel fn, plain fn,
    library fn or None, (FLOP, bytes)), in ROUNDS rounds that alternate
    which goes first; each as eager launches (as the tick makes them) and
    as CUDA-graph replays (device time without the host's launch gaps; a
    call still costs one graph node), and the graph median of each call.
    Sets stats[name]:
    "ms"/"plain_ms"/"library_ms" the eager medians (library None where
    there is no library call), "graph_ms"/"plain_graph_ms"/
    "library_graph_ms" the graph ones, and "bound_ms"/"bound_by" the least
    time for the hop's FLOP at `peak_flops` or its bytes at the HBM rate,
    whichever is larger."""
    paths = ("kernel", "plain") + (("library",) if calls[0][3] else ())
    timers = []  # per call: path → how → () → ms of one call
    for _, *fns, _ in calls:
        timers.append({})
        for path, f in zip(paths, fns):
            g = _graph(f, ROUND_REPS)
            timers[-1][path] = {
                "eager": partial(cuda_ms, f, ROUND_REPS, 1),
                "graph": lambda g=g: cuda_ms(g.replay, 1, 0) / ROUND_REPS}
    names = [k.name for k in kernels]
    ms = {(n, path, how): [] for n in names for path in paths
          for how in ("eager", "graph")}
    per_call = [[] for _ in calls]  # the kernel's graph ms, each round
    for r in range(ROUNDS):
        for path in paths[::1 if r % 2 == 0 else -1]:
            for how in ("eager", "graph"):
                tot = dict.fromkeys(names, 0.0)
                for i, ((name, *_), timer) in enumerate(zip(calls, timers)):
                    t = timer[path][how]()
                    tot[name] += t
                    if (path, how) == ("kernel", "graph"):
                        per_call[i].append(t)
                for n in names:
                    ms[(n, path, how)].append(tot[n])
    del timers
    out = []
    for n in names:
        flop = sum(c[4][0] for c in calls if c[0] == n)
        nbytes = sum(c[4][1] for c in calls if c[0] == n)
        t_flop, t_bytes = flop / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        st = stats[n]
        st["bound_ms"] = max(t_flop, t_bytes)
        st["bound_by"] = "operations" if t_flop >= t_bytes else "bytes"
        parts = []
        for how in ("eager", "graph"):
            k = ms[(n, "kernel", how)]
            km = float(np.median(k))
            line = f"{how} kernel {km:.4f} ms ({min(k):.4f}-{max(k):.4f})"
            for path in paths[1:]:
                p = ms[(n, path, how)]
                won = sum(a < b for a, b in zip(k, p))
                line += (f" vs {path} {np.median(p):.4f} ms ({min(p):.4f}-"
                         f"{max(p):.4f}), kernel faster in {won} of {ROUNDS}")
            parts.append(
                f"{line}, {flop / (km * 1e-3) / peak_flops:.2%} of "
                f"{peak_name} peak, {nbytes / (km * 1e-3) / PEAK_HBM_BYTES:.2%}"
                f" of HBM rate")
        for path, key in (("kernel", ""), ("plain", "plain_"),
                          ("library", "library_")):
            for how, suffix in (("eager", "ms"), ("graph", "graph_ms")):
                st[key + suffix] = (float(np.median(ms[(n, path, how)]))
                                    if path in paths else None)
        each = " ".join(f"{np.median(t) * 1e3:.1f}"
                        for c, t in zip(calls, per_call) if c[0] == n)
        out.append(f"{n} ({st['calls']} calls, {flop / 1e9:.3f} GFLOP, "
                   f"{nbytes / 1e6:.1f} MB in+out, bound {st['bound_ms']:.4f} "
                   f"ms by {st['bound_by']}): " + "; ".join(parts)
                   + f"; graph µs per call, in hop order: {each}")
    print(f"{phase} timing: per hop at B={batch}, medians (min-max) of "
          f"{ROUNDS} alternating rounds of {ROUND_REPS} calls each, shares "
          f"of {peak_flops / 1e12:.0f} TFLOP/s {peak_name} and "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s [{gpu}]: " + " | ".join(out))


def rel_err(got, ref) -> float:
    """max|got − ref| / max|ref|, in float32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def bf16_bar(plain_dev: float) -> float:
    """3e-2, or 1.5 × the plain bf16 path's measured deviation from the
    plain f32 path where that is larger (random full-width weights)."""
    return max(BF16_REL_TOL, 1.5 * plain_dev)


def phase_k2(rvq, batch, dev, stats, gpu):
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
    s["calls"] = 1
    print(f"K2 vs plain: ok, {n_diff} of {b} rows differ (near-ties), "
          f"reconstruction max abs diff {recon:.3e}")
    # Timed at the main path's batch: per stage 16 dots of 64 and the
    # residual update; features, codebooks and ||c||^2 in, indices out.
    x = feats[:batch].contiguous()
    stages = cb.shape[0]
    flop = batch * stages * (cb.shape[1] * 2 * 64 + 64)
    nbytes = 4 * (x.numel() + cb.numel() + c2.numel() + batch * stages)
    kernel = partial(rvq_kernel.rvq_encode, x, cb, c2, stages)
    with ClockSampler() as clocks:
        _time_rounds("K2", [("rvq_encode", kernel,
                             partial(rvq_kernel.rvq_encode_plain, x, cb, c2,
                                     stages), None, (flop, nbytes))],
                     rvq_kernel.KERNELS, batch, stats, gpu, PEAK_FP32_FLOPS,
                     "FP32")
        # As the tick finds it: after other work has evicted the codebooks
        # from L2 (the flush), against the same single launch warm.
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        cold = single_launch_ms(kernel, partial(flush.fill_, 1))
        warm = single_launch_ms(kernel, partial(torch.cuda._sleep,
                                                SPIN_CYCLES))
        del flush
    s["cold_ms"] = cold
    print(f"K2 single launches at B={batch}, medians of 20: cold (after "
          f"writing {FLUSH_BYTES >> 20} MB) {cold:.4f} ms, warm (after a "
          f"spin) {warm:.4f} ms; eager {s['ms']:.4f} ms, graph "
          f"{s['graph_ms']:.4f} ms; {clocks.summary()} [{gpu}]")


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


def _tick(enc, dec, es, ds, audio, received, num_bits, eager=False):
    """One tick of the slice: the engines' `step` (a replay each where they
    have graphs), or with eager=True their `_step_impl`."""
    import torch

    from lyra_tpu_torch import packet

    nq = num_bits // 4
    if eager:
        idx, _, es = enc._step_impl(es, audio, torch.full(
            (audio.shape[0],), nq, dtype=torch.int32, device=audio.device))
    else:
        idx, _, es = enc.step(es, audio, nq)
    wire = packet.pack_wire_device(idx, num_bits)
    dec_idx = torch.full_like(idx, -1)
    dec_idx[:, :nq] = packet.unpack_wire_device(wire, num_bits)
    out, cn, ds = (dec._step_impl if eager else dec.step)(ds, dec_idx,
                                                          received)
    return out, cn, es, ds, dec_idx


def _eager(engine):
    """`engine` with its step bound to `_step_impl`: no CUDA graphs."""
    engine.graphs = None
    return engine


def _own(k, n):
    """A kernel's own name in a profiler event name, not a longer one that
    contains it (demangled "ns::conv1d_fwd(" or mangled "10conv1d_fwdE")."""
    return re.search(rf"(?<![A-Za-z_]){k.name}(?![a-z0-9_])", n)


def _device_us(prof):
    """Device µs of each CUDA event name in a profiler window."""
    return {n: us for n, (us, _) in _device_events(prof).items()}


CORE_SPAN = "fused_stack.core"  # FusedStack's record_function


def _device_events(prof):
    """(device µs, count) of each CUDA event name in a profiler window,
    without the ranges that span other events on the device's timeline:
    the profiler's own steps ("ProfilerStep*") and the conv stacks' core
    spans."""
    import torch

    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep") and e.key != CORE_SPAN}


def _core_split(prof):
    """(device µs inside the conv stacks' core spans, device µs of all
    kernels) of an eager profiler window: the kernels' own intervals,
    without the range events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == cuda]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == CORE_SPAN]
    inside = total = 0.0
    for e in events:
        if e.name == CORE_SPAN or e.name.startswith("ProfilerStep"):
            continue
        lo, hi = e.time_range.start, e.time_range.end
        total += hi - lo
        if any(a <= lo and hi <= b for a, b in spans):
            inside += hi - lo
    return inside, total


def _profile_ticks(tick, n=3):
    """`tick(i)` for i = 0..n under torch.profiler: tick 0 as its warm-up
    step (a profiler's first step can lose device records), ticks 1..n
    profiled, each step ended by a synchronize.  → the profile of the n."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=n,
                                         repeat=1))
    with prof:
        for i in range(n + 1):
            tick(i)
            torch.cuda.synchronize()
            prof.step()
    return prof


def _kernels_per_replayed_tick(enc, dec, batch, dev):
    """All CUDA kernels (device copies and fills not counted) per replayed
    tick of `enc`/`dec`'s captured steps, from 3 profiled ticks."""
    audio, received = _inputs(batch, 8, dev, enc.hop_samples)
    state = [enc.init_state(batch), dec.init_state(batch)]

    def tick(i):
        _, _, state[0], state[1], _ = _tick(enc, dec, *state, audio[i],
                                            received[i], 120)

    for i in range(4):  # warm-up and both captures of each step
        tick(i)
    events = _device_events(_profile_ticks(lambda i: tick(4 + i)))
    return sum(c for n, (_, c) in events.items()
               if not n.startswith(("Memcpy", "Memset"))) / 3


class _UnfusedStack:
    """A FusedStack whose hop runs op by op (`FusedStack.unfused`: the
    kernels without fused operands, every other op a torch op)."""

    def __init__(self, fused):
        self.fused = fused

    def init_state(self, batch_size):
        return self.fused.init_state(batch_size)

    def __call__(self, state, x):
        return self.fused.unfused(state, x)


def _unfused(engines):
    """The engines with their conv stacks' cores unfused, for a count
    against the fused core."""
    enc, dec = engines
    for model in (enc.soundstream, dec.gan):
        model._run = _UnfusedStack(model._run)
    return enc, dec


def _drive(enc, dec, kernels, batch, ticks, dev, profile_file):
    """`ticks` ticks of the slice at `batch` through the fresh engines'
    captured `step`, every launch count set to 0 just before and read just
    after, the last 3 ticks under torch.profiler.  A replay runs no
    wrapper, so the counts are those of the captures: one warm-up and two
    captures (ping-pong trees) of each step, 3 × the launches per tick,
    which the profiler counts in the replays.  Checks launches, kernel
    names and counts in the replays, shape, finiteness and speech level;
    returns (launches, launches per tick, summary)."""
    import torch

    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    audio, received = _inputs(batch, ticks, dev, enc.hop_samples)
    lost = 1.0 - received.float().mean().item()
    es, ds = enc.init_state(batch), dec.init_state(batch)
    num_bits = 120
    outs, cn_count = [], 0
    every = conv_stack.KERNELS + rvq_kernel.KERNELS
    check(enc.graphs is not None and dec.graphs is not None,
          "main path: the engines have no CUDA graphs")

    def tick(_=None):
        nonlocal es, ds, cn_count
        t = len(outs)
        out, cn, es, ds, _ = _tick(enc, dec, es, ds, audio[t], received[t],
                                   num_bits)
        outs.append(out.clone())  # the graph's buffer: the next replay
        cn_count += int(cn.sum().item())  # overwrites it

    with ClockSampler() as clocks:
        for k in every:
            k.launches = 0
        for _ in range(ticks - 4):
            tick()
        prof = _profile_ticks(tick)
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

    events = _device_events(prof)
    check(bool(events), "profiler recorded no CUDA events")
    # Per tick, each of the path's kernels summed over its instances.
    per_tick = {k.name: sum(us for n, (us, _) in events.items() if _own(k, n))
                / 3 for k in kernels}
    counted = {k.name: sum(c for n, (_, c) in events.items() if _own(k, n))
               for k in kernels}
    check(all(counted.values()), f"profiler: kernels missing {counted}")
    check(all(c % 3 == 0 and launches[n] == c for n, c in counted.items()),
          f"main path: launches {launches} are not 3 x the launches per "
          f"replayed tick (profiler, 3 ticks: {counted})")
    per_tick_launches = {n: c // 3 for n, c in counted.items()}
    # Where an eager tick's device time goes: inside the two conv stacks'
    # cores, or elsewhere (DSP, PLC, comfort noise, masks, edges, copies).
    ees, eds = enc.init_state(batch), dec.init_state(batch)
    _tick(enc, dec, ees, eds, audio[0], received[0], num_bits, eager=True)
    eager = _profile_ticks(lambda i: _tick(enc, dec, ees, eds, audio[i],
                                           received[i], num_bits, eager=True))
    core_us, all_us = (v / 3 for v in _core_split(eager))
    # Every CUDA kernel of a replayed tick, the path's and torch's (device
    # copies and fills not counted).
    all_kernels = sum(c for n, (_, c) in events.items()
                      if not n.startswith(("Memcpy", "Memset"))) / 3
    if profile_file:
        os.makedirs(os.path.dirname(profile_file), exist_ok=True)
        with open(profile_file, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=60))
    return {k.name: launches[k.name] for k in kernels}, per_tick_launches, (
        f"B={batch} x {ticks} ticks at {enc.sample_rate_hz} Hz, {lost:.1%} "
        f"of hops lost, audio RMS {rms:.1f} (int16), {cn_count} "
        f"comfort-noise stream-hops; launches over the run (warm-up and two "
        f"captures of each step) { {k.name: launches[k.name] for k in kernels} }"
        f", per replayed tick (profiler) {per_tick_launches}, all CUDA "
        f"kernels per replayed tick {all_kernels:g}; device µs per "
        f"captured tick (last 3 ticks): "
        f"all {sum(us for us, _ in events.values()) / 3:.1f}, "
        + ", ".join(f"{n} {t:.1f}" for n, t in per_tick.items())
        + f"; over the {ticks} ticks {clocks.summary()}; an eager tick's "
        f"kernels (profiler, 3 ticks): {all_us:.1f} device µs per tick, "
        f"{core_us:.1f} inside the conv stacks' core spans, "
        f"{all_us - core_us:.1f} outside them")


def phase_main(path, batch, ticks, dev, profile_out):
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    enc = EncoderEngine(16000, path, device=dev)
    dec = DecoderEngine(16000, path, device=dev)
    launches, per_tick, summary = _drive(
        enc, dec, conv_stack.KERNELS_F32 + rvq_kernel.KERNELS, batch, ticks,
        dev, profile_out and os.path.join(profile_out,
                                          "chip_smoke_profile.txt"))
    unfused = _kernels_per_replayed_tick(*_unfused(
        (EncoderEngine(16000, path, device=dev),
         DecoderEngine(16000, path, device=dev))), batch, dev)
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
    print(f"main path: ok, {summary}; with the cores unfused {unfused:g} "
          f"CUDA kernels per replayed tick; vs plain path (B={b_ref}, 10 "
          f"ticks): rows with identical indices {same_idx:.4f}, decoder max "
          f"diff {worst_lsb} LSB")
    return launches, per_tick


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
    launches, per_tick, summary = _drive(
        enc, dec, conv_stack.KERNELS_BF16 + rvq_kernel.KERNELS, batch, ticks,
        dev, profile_out and os.path.join(profile_out,
                                          "chip_smoke_profile_bf16.txt"))
    unfused = _kernels_per_replayed_tick(*_unfused(
        (EncoderEngine(rate, path, mode="bf16", device=dev),
         DecoderEngine(rate, path, mode="bf16", device=dev))), batch, dev)

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
    print(f"main-bf16 path: ok, {summary}; with the cores unfused "
          f"{unfused:g} CUDA kernels per replayed tick; vs plain bf16 path "
          f"(B={b_ref}, 10 "
          f"ticks, identical inputs): indices identical, max rel err "
          f"features {err['features']:.3e}, audio {err['audio']:.3e}; plain "
          f"bf16 vs plain f32: features {plain_dev['features']:.3e}, audio "
          f"{plain_dev['audio']:.3e}; bars {bars}")
    return launches, per_tick


def phase_timing(path, batch, dev, gpu):
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine

    res = {}
    for rate, mode in ((16000, "float"), (RATE_BF16, "bf16")):
        paths = {}
        for backend in ("kernel", "plain"):
            enc = _eager(EncoderEngine(rate, path, backend=backend, mode=mode,
                                       device=dev))
            dec = _eager(DecoderEngine(rate, path, backend=backend, mode=mode,
                                       device=dev))
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
    print(f"timing: B={batch} encode+wire+decode per eager tick, 40 ticks "
          f"each: " +
          "; ".join(f"{mode} {rate // 1000} kHz {backend} p50 {p50:.3f} ms "
                    f"p99 {p99:.3f} ms"
                    for (mode, rate, backend), (p50, p99) in res.items()) +
          f" [{gpu}]")


def _serve_run(enc_eng, dec_eng, pcm, received, asynchronous=False,
               wires=None):
    """Phase 9's schedule on a server pair over the engines: all streams
    admitted; SERVE_CHURN evicted at tick 10; SERVE_CHURN new ones admitted
    into their slots and SERVE_CHURN others evicted at tick 20; both
    servers saved and restored into a fresh pair at tick 30.  Synchronous:
    EncoderServer.tick_wire → DecoderServer.tick_wire.  Asynchronous: the
    tick_wire_async pipelines, the decoder fed the synchronous run's
    `wires`, outputs placed at the tick they belong to.  → per tick
    (wire, sizes, audio, comfort-noise flags) as numpy, and the slots
    re-admitted at tick 20."""
    import tempfile

    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    ticks, batch = pcm.shape[:2]

    def fresh():
        return (EncoderServer(batch, engine=enc_eng, bitrate=6000),
                DecoderServer(batch, engine=dec_eng))

    enc, dec = fresh()
    for srv in (enc, dec):
        srv.add_streams(range(batch))
    outs, readmitted = [None] * ticks, []
    with tempfile.TemporaryDirectory() as tmp:
        for t in range(ticks):
            if t == 10:
                for srv in (enc, dec):
                    for sid in range(SERVE_CHURN):
                        srv.remove_stream(sid)
            if t == 20:
                new = range(batch, batch + SERVE_CHURN)
                readmitted = sorted(enc.add_streams(new).values())
                check(sorted(dec.add_streams(new).values()) == readmitted,
                      "serve: encoder and decoder slots differ")
                for srv in (enc, dec):
                    for sid in range(SERVE_CHURN, 2 * SERVE_CHURN):
                        srv.remove_stream(sid)
            if t == 30:
                if asynchronous:
                    outs[t - 1] = (*enc.flush_async(), dec.flush_async(),
                                   dec._last_comfort.copy())
                enc.save(os.path.join(tmp, "enc"))
                dec.save(os.path.join(tmp, "dec"))
                enc, dec = fresh()
                enc.restore(os.path.join(tmp, "enc"))
                dec.restore(os.path.join(tmp, "dec"))
            if asynchronous:
                w_in, s_in = wires[t]
                w = enc.tick_wire_async(pcm[t])
                a = dec.tick_wire_async(w_in, received[t] & (s_in > 0), s_in)
                if t not in (0, 30):
                    outs[t - 1] = (*w, a, dec._last_comfort.copy())
            else:
                wire, sizes = enc.tick_wire(pcm[t])
                a = dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
                outs[t] = (wire, sizes, a, dec._last_comfort.copy())
        if asynchronous:
            outs[-1] = (*enc.flush_async(), dec.flush_async(),
                        dec._last_comfort.copy())
    return outs, readmitted


def _serve_ticks(servers, pcm, received, n, times=None, asynchronous=False,
                 start=0):
    """n ticks of a server pair over the inputs, cycling; wall ms of each
    appended to `times` (host clock from a synchronized start to the
    decoder's audio on the host).  Asynchronous: the tick_wire_async
    pipelines, the decoder fed the encoder's previous tick, and no
    synchronization between ticks."""
    import torch

    enc, dec = servers
    for i in range(start, start + n):
        t = i % pcm.shape[0]
        if not asynchronous:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if asynchronous:
            out = enc.tick_wire_async(pcm[t])
            if out is not None:
                dec.tick_wire_async(out[0], received[t] & (out[1] > 0),
                                    out[1])
        else:
            wire, sizes = enc.tick_wire(pcm[t])
            dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    if asynchronous:
        enc.flush_async()
        dec.flush_async()


def _replay_span_ms(enc, dec, batch, dev, n=50):
    """Device ms per tick of the captured engine steps (encode, device wire
    pack/unpack, decode) run back to back with no host wait between them:
    CUDA events around n ticks."""
    import torch

    audio, received = _inputs(batch, 10, dev, enc.hop_samples)
    es, ds = enc.init_state(batch), dec.init_state(batch)
    for t in range(3):
        _, _, es, ds, _ = _tick(enc, dec, es, ds, audio[t], received[t], 120)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for t in range(n):
        _, _, es, ds, _ = _tick(enc, dec, es, ds, audio[t % 10],
                                received[t % 10], 120)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _serve_config(path, batch, dev, gpu, rate, mode):
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel
    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    kernels = (conv_stack.KERNELS_F32 if mode == "float"
               else conv_stack.KERNELS_BF16) + rvq_kernel.KERNELS
    audio, received = _inputs(batch, TICKS, dev, rate // 50)
    pcm = audio.clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    received = received.cpu().numpy()

    def engines():
        return (EncoderEngine(rate, path, mode=mode, device=dev),
                DecoderEngine(rate, path, mode=mode, emit_dtype="int16",
                              device=dev))

    # The captured pairs: launch counts over their run are their captures'.
    cap_engines = engines()
    every = conv_stack.KERNELS + rvq_kernel.KERNELS
    for k in every:
        k.launches = 0
    captured, readmitted = _serve_run(*cap_engines, pcm, received)
    launches = {k.name: k.launches for k in every}
    for k in kernels:
        check(launches[k.name] > 0, f"serve: captures never launched {k.name}")
    eager_engines = [_eager(e) for e in engines()]
    eager, readmitted_e = _serve_run(*eager_engines, pcm, received)
    check(readmitted == readmitted_e, "serve: slot tables differ")
    names = ("wire", "sizes", "audio", "comfort noise")
    for t, (got, want) in enumerate(zip(captured, eager)):
        for name, g, w in zip(names, got, want):
            check(g.shape == w.shape and np.array_equal(g, w),
                  f"serve {mode}: captured {name} differs from eager at tick "
                  f"{t} in {int((g != w).sum()) if g.shape == w.shape else 'shape'}"
                  f" places")
    audio_out = np.stack([o[2] for o in captured])
    check(audio_out.shape == (TICKS, batch, rate // 50)
          and audio_out.dtype == np.int16, f"serve: audio {audio_out.shape}")
    rms = float(np.sqrt(np.mean(audio_out[10:].astype(np.float64) ** 2)))
    check(300.0 <= rms <= 15000.0, f"serve: RMS {rms} not speech-level")
    cn_hops = int(sum(o[3].sum() for o in captured))

    # The async pipelines: the same outputs, one tick later; the slots
    # re-admitted at tick 20 drain silence for tick 19.
    wires = [(o[0], o[1]) for o in captured]
    asyn, _ = _serve_run(*cap_engines, pcm, received, asynchronous=True,
                         wires=wires)
    for t, (got, want) in enumerate(zip(asyn, captured)):
        want = [np.array(w) for w in want]
        if t == 19:
            for w in want:
                w[readmitted] = 0
        for name, g, w in zip(names, got, want):
            check(np.array_equal(g, w),
                  f"serve {mode}: async {name} differs at tick {t}")

    # Eager vs captured tick wall time in turns, then each under the
    # profiler for 3 ticks: device time and the replayed kernels' names.
    # The memory a pair holds: its state trees, static and pinned buffers
    # and graphs, after its first 3 ticks.
    pairs, held = {}, {}
    for kind, (e, d) in (("captured", cap_engines), ("eager", eager_engines)):
        gc.collect()  # a dead server is a reference cycle (its programs)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        pairs[kind] = (EncoderServer(batch, engine=e, bitrate=6000),
                       DecoderServer(batch, engine=d))
        for srv in pairs[kind]:
            srv.add_streams(range(batch))
        _serve_ticks(pairs[kind], pcm, received, 3)
        gc.collect()
        torch.cuda.synchronize()
        held[kind] = torch.cuda.memory_allocated() - base
    times = {kind: [] for kind in ("eager", "captured", "async")}
    peak = dict.fromkeys(pairs, 0)
    for kind in ("eager", "captured", "async", "async", "captured", "eager"):
        servers = pairs["captured" if kind == "async" else kind]
        _serve_ticks(servers, pcm, received, 3)
        torch.cuda.reset_peak_memory_stats()
        _serve_ticks(servers, pcm, received, SERVE_TIMED, times[kind],
                     asynchronous=kind == "async")
        if kind != "async":
            peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
    span = _replay_span_ms(*cap_engines, batch, dev)
    device = {}
    for kind, servers in pairs.items():
        prof = _profile_ticks(lambda i, servers=servers: _serve_ticks(
            servers, pcm, received, 1, start=i))
        dev_us = _device_us(prof)
        device[kind] = sum(dev_us.values()) / 3 / 1e3
        if kind == "captured":
            seen = {k.name: any(_own(k, n) for n in dev_us) for k in kernels}
            check(all(seen.values()),
                  f"serve {mode}: replayed kernels missing in the profiler "
                  f"{seen}")
    stats = {}
    for kind, ts in times.items():
        p50, p99 = float(np.percentile(ts, 50)), float(np.percentile(ts, 99))
        stats[kind] = (p50, p99)
    print(f"serve {mode} {rate // 1000} kHz: ok, B={batch} x {TICKS} ticks, "
          f"EncoderServer.tick_wire → DecoderServer.tick_wire at 120 bits, "
          f"{SERVE_CHURN} streams evicted at tick 10, admitted into slots "
          f"{readmitted[0]}-{readmitted[-1]} and {SERVE_CHURN} others "
          f"evicted at tick 20, save + restore into a fresh pair at tick 30: "
          f"wire, sizes, audio and comfort-noise flags bitwise equal to eager "
          f"engines; audio RMS {rms:.1f}, {cn_hops} comfort-noise "
          f"stream-hops; async pipelines equal one tick later (re-admitted "
          f"slots silent); launches over the captured run (the warm-ups and "
          f"captures of its two server pairs) "
          f"{ {k.name: launches[k.name] for k in kernels} }; kernel "
          f"names in the replays' profiler window: "
          f"{', '.join(k.name for k in kernels)}")
    print(f"serve timing {mode} {rate // 1000} kHz [{gpu}]: B={batch}, "
          f"{SERVE_TIMED} ticks per turn, turns eager, captured, async, "
          f"async, captured, eager; " + "; ".join(
              f"{kind} p50 {stats[kind][0]:.3f} ms p99 {stats[kind][1]:.3f} "
              f"ms ({len(times[kind])} ticks), device {device[kind]:.3f} ms "
              f"per tick, idle share {1 - device[kind] / stats[kind][0]:.1%}, "
              f"memory held by a pair after 3 ticks "
              f"{held[kind] / 2**20:.1f} MiB, peak "
              f"allocated over its turns {peak[kind] / 2**20:.1f} MiB"
              for kind in ("eager", "captured"))
          + f"; captured async pipelines (tick_wire_async, no sync between "
          f"ticks) p50 {stats['async'][0]:.3f} ms p99 {stats['async'][1]:.3f}"
          f" ms; captured engine steps back to back (CUDA events, no host "
          f"wait) {span:.3f} ms per tick")


def phase_serve(path, batch, dev, gpu):
    for rate, mode in ((16000, "float"), (RATE_BF16, "bf16")):
        _serve_config(path, batch, dev, gpu, rate, mode)


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
    stats = {k.name: {"max_abs_err": 0.0, "calls": 0, "cold_ms": None}
             for k in kernels}
    phase_k1(path, BATCH, dev, stats, gpu)
    phase_k1_bf16(path, BATCH, dev, stats, gpu)
    phase_k2(ResidualVectorQuantizer.from_model_path(path, dev), BATCH, dev,
             stats, gpu)
    phase_rates(BATCH, dev)
    launches, per_tick = {}, {}
    for phase in (phase_main, phase_main_bf16):
        counts, ticks = phase(path, BATCH, TICKS, dev, args.profile_out)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
            per_tick[name] = per_tick.get(name, 0) + ticks[name]
    phase_timing(path, BATCH, dev, gpu)
    phase_serve(path, BATCH, dev, gpu)

    # Per hop at B=1024: eager medians, then graph-replay medians, and the
    # RVQ kernel's cold-L2 single launch; the launches of phases 6-7's runs
    # and per replayed tick.  The conv kernels' library call is one cuDNN
    # call (TF32 off) with the weights laid out beforehand; no single
    # PyTorch call computes the RVQ search.
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "launches_per_tick": per_tick[k.name],
         **{key: stats[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "graph_ms", "plain_graph_ms", "library_graph_ms",
             "cold_ms")}}
        for k in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
