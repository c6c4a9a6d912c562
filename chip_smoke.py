#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (lyra_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-out DIR]

Drives the port's main path — the lockstep codec tick: EncoderEngine.step
→ device wire pack → unpack → DecoderEngine.step, each step one CUDA-graph
replay (utils/capture.py) — the serving path over it (EncoderServer.
tick_wire → DecoderServer.tick_wire) and the serving process over that
(tools/serve_main.py: UDP in, UDP out) at the full width of the Lyra v2
models: the real weights when LYRA_TPU_MODEL_PATH names a directory that
holds them, otherwise the synthetic full-width fixture
(tests/golden/synthetic_lyra/full, random weights from a seed).

Phases, one line each; any failed check raises and exits nonzero:
  1. build    the CUDA kernels from lyra_tpu_torch/ops/csrc (conv_stack.cu,
              rvq_encode.cu, core_ops.cu, out_edge.cu) with nvcc, one
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
              give the same bits; LyraGAN's output edge (ops/out_edge.py,
              one launch a hop) vs its plain version (the executor's ops
              on cuDNN) and cuDNN's deterministic edge at B=4096 and
              1024, timed the same way, and one launch cold;
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
              steps' device span per tick run back to back;
 10. serve-process  `python -m lyra_tpu_torch.tools.serve_main`'s three
              modes, each as serve_main.main in a thread (its default
              device, the card) at capacity 1024 with native ingest and
              egress: decode at 16 kHz and bridge (rooms of 4) each read a
              preloaded uplink timeline (every datagram sent before the
              first tick: 8/15/23-byte packets, 5% of an unknown size, 15%
              lost, sequences out of order; no late or overflow drop
              allowed), the encode relay at 48 kHz gets one constant hop
              per slot every 8 ms from 4 processes of their own, in
              bursts of 16 (0 PCM gaps allowed); each run's
              downlink (echoed PCM, or packets) must equal bit for bit an
              offline replay of the same input through a JitterBuffer and
              servers or a ConferenceBridge on eager engines, with the
              launch counts reset before each serve process and read after
              it (every kernel of the mode's engines launched inside the
              process); then each mode again with uplink every 20 ms until
              500 ticks of downlink, printing its final stats record (tick
              p50/p95, ingest datagrams, drops by cause, egress sent) and
              the loop's own ticks per second beside the card's name and
              power limit; last, one tick's downlink send (1024
              datagrams, native egress) timed alone on the host;
 11. offline  the single-stream codec and the offline tools, each entry
              point at its default device (the card): SoundStream and
              LyraGAN on the kernel path vs the plain executor at B=1 and
              B=3, float and bf16, 20 frames with state carried (phases
              2-3's bars), rvq_encode in 1000 launches at B=1 vs its plain
              version (near-ties only); LyraEncoder (6 kbps, DTX off and
              on) and LyraDecoder (Gilbert loss 0.1 / burst 2, random
              request sizes) at 16 and 48 kHz over 150 hops vs the same
              facades on the CPU (packets identical but at RVQ
              near-ties and DTX decisions at the noise bound, ≤ 0.1 % of
              hops, with DTX on from the card's pre-hop state; audio
              within 2 int16 LSB;
              is_comfort_noise equal after every request); the facade
              pair's per-hop wall time at 16 kHz (p50/p99 over 150 hops,
              device µs and kernels per hop from the profiler);
              encoder_main and decoder_main in process on a 10 s wav per
              rate (a fixed loss pattern, then Gilbert loss with random
              requests): `.lyra` size, its packets equal the facade's,
              wav lengths, real-time factors; batch_transcode over 16
              wavs (B=7 at 16 kHz, B=9 at 48 kHz, each with a partial
              hop): every `.lyra` byte for byte the single-stream
              encoder's, audio within 1 LSB of the single-stream
              decoder's; launch counts reset before and read after the
              facades, the CLIs and batch_transcode (every kernel of the
              float path launched in each; printed as one JSON line of
              its own); tools/benchmark.run_benchmark in float and bf16
              at batch 1 and 1024 (200 conditioning vectors),
              melspec_benchmark, and one captured hop of each model at
              B=1 in each mode under the profiler (device µs, kernels,
              the three costliest).
 12. islands   the islands fixture (tests/golden/synthetic_lyra_islands/
              full: int8 islands, QUANTIZE/DEQUANTIZE views, and the rest
              of K1's op set: a MUL by a per-channel constant fused into a
              conv launch, stride-2 time slices and a channel
              concatenation on core_gather, MUL/ADD/DIV on core_eltwise, a
              channel slice as a channel offset), both models in float
              and bf16: vs the plain executor (B=64, 20 frames, phases
              2-3's bars), f32 bitwise equal to the unfused path at B=64
              and B=1024, one profiled eager hop per mode at B=1024 whose
              core span holds only conv-stack kernels, one per launch
              (launches per core printed: the core's convs plus its
              core-kernel calls); each core-kernel call of one hop at
              B=1024 on random operands bitwise equal to its plain version
              and to one PyTorch call (torch.add / sub / mul / div,
              torch.cat, a slice's .contiguous(): the library time), timed
              as in phases 2-3; then phases 6-7's 50 captured engine ticks
              on the fixture, float at 16 kHz (decoder within 2 int16 LSB
              of the plain path's) and bf16 at 48 kHz (phase 7's bars),
              device µs and CUDA kernels per replayed tick printed beside
              phases 6-7's on the plain fixture.
 13. fleet    the fleet tier (tools/fleet.py, fleet_main.py, client.py)
              and the examples (lyra_tpu_torch/examples), float at 16 kHz:
              (a) examples.drain_migrate at 3 and 64 callers in this process
              (its exit code: post-migration audio bitwise the never-drained
              run's); (b) two serve_main decode host processes at capacity
              1024 (A active with periodic snapshots, B a warm standby;
              keyed control, --echo reply) under `python -m
              lyra_tpu_torch.tools.fleet_main --key`, 16 FleetCallers
              admitted and streaming to A, the controller's migrate A → B,
              every caller relocates and sends the cutover's datagrams as
              one burst that fits B's jitter buffer (no late or overflow
              drop allowed): B's PCM to each caller from B's first tick
              after the restore must equal bit for bit an offline replay —
              one DecoderServer on eager engines on the card restoring A's
              drain snapshot and taking the same collects (phase 10's
              method) — then the callers stream on and B plays them; each
              host prints the launch counts of its own process at exit
              (every f32 conv-stack kernel launched), the card's memory in
              use per host and at the peak, the migrate's and the
              restore's wall time; (c) examples.multihost_migrate
              --controller, then --controller --failover (SIGKILL of A,
              fleet_main's watchdog): each caller's longest audio gap
              within the example's --max_gap_ms 1000, the cutover's wall
              time and the hosts after it printed; (d) the other examples
              in this process, each gated by its own exit code:
              loopback_call, udp_call plain and --mixed, conference_call
              (rooms of 2), rate_adapt_call (ADAPT OK, every stream walked
              from 9200 to 3200).  Launch counts are reset before each
              in-process example and read after it (every kernel of its
              models launched).
 14. sharding multi-device serving (parallel/sharding.py) on a mesh of
              two shards of cuda:0 (two shards on one card: the sharded
              path's overhead, not multi-card scaling), and again over
              cuda:0 and cuda:1 where two cards are attached: (a)
              parallel/dryrun.py's dryrun_multichip(2); (b) encoder and
              decoder ShardedEngines at 2 x 512 vs one engine at B=1024,
              captured, 50 ticks of phase 6's loss pattern, float 16 kHz
              and bf16 48 kHz, the decoders fed identical indices:
              indices and comfort-noise flags bitwise, audio bitwise in
              every hop without comfort noise in it and within 1 int16 LSB
              in those with it (the noise estimator's and the comfort-noise
              generator's cuBLAS matmuls pick their kernel by the row
              count), launch counts reset before each run and read after
              it (each shard launches every kernel of the path as often as
              the one engine); (c) phase 9's server schedule over the
              sharded float engines (wire bitwise, audio by (b)'s bar) and
              a capacity-1024 bridge with rooms of 4 placed by
              shard_affine_slots, 100 tick_wire ticks: the downlink bitwise
              the unsharded bridge's in every room none of whose uplinks
              has had comfort noise yet; (d) printed, not gated: the
              captured server tick over one engine vs the sharded engines
              in turns (wall p50/p99), device time and CUDA kernels per
              replayed tick from the profiler, memory per card.
 15. quant    the quantized modes on the islands fixture at full width,
              on the plain backend, which alone runs them (their graphs
              have no kernel; their RVQ search runs on rvq_encode): (a)
              every int8 op of both graphs (int8 convs, LEAKY_RELU, ADD,
              QUANTIZE, DEQUANTIZE) fed the tensors of one hop of a CPU
              run of the port at B=64: bitwise the CPU's output on the
              card; (b) the int8 and fakequant engines, encoder → wire →
              decoder, 20 hops at B=64, the card's captured steps from the
              CPU engines' pre-hop state each hop: rvq_encode on the CPU's
              features equal to the CPU's search but at near-ties (≤ 0.1
              %), comfort-noise flags equal, at most 1e-3 of the int8
              elements of both graphs differing (every 4th hop), the
              audio's per-hop log-spectral distance within 0.004 dB mean
              and 0.2 dB max (bars set from the card's readings: rare f32
              rounding flips at an island's QUANTIZE), and a control that
              must fail those bars: the CPU's fakequant audio against its
              int8 audio; features, the card's own indices and audio in
              LSB printed; (c) state_compression="int8"
              in float and bf16: 20 captured ticks at B=64 bitwise an
              eager run's, a snapshot round trip (save_state /
              load_state) bitwise, the compressed decoder snapshot under
              0.55 × the float32 state's bytes (the JAX package's bar), and
              the int8 and f8 graphs' bits the same with cuDNN's TF32
              allowed and not; (d) the fp8 cast on the card gives the JAX
              package's bits (±448, the ties at 464, NaN past it, ±inf,
              NaN, subnormals; float32 and bfloat16), and boundary_store=
              "f8" in float and bf16 card vs CPU as in (b), printed; (e)
              at B=1024, int8, fakequant, float with int8 state, float and
              bf16 with f8 boundaries (the phase's main path), and float
              on the plain and on the kernel backend beside them: each
              through `_drive` (20 captured ticks of fresh engines, launch
              counts zeroed before and read after: rvq_encode launched,
              no conv-stack kernel on the plain backend; device µs and
              CUDA kernels per replayed tick from the profiler), the
              memory its engines hold and its run's peak, then the wall
              time per captured tick, p50/p99, in alternating turns;
              nothing in (e) is gated but the main path's checks.
The 3e-2 bars were measured on the small fixture; where the full fixture
needs more room, the bar becomes 1.5 × the deviation of the plain bf16
path from the plain f32 path on the same inputs, measured in the same
phase (both numbers are printed).
Then one JSON line with every kernel (per hop at B=1024: kernel, plain
and library time as eager medians in ms/plain_ms/library_ms and as
graph-replay medians in graph_ms/plain_graph_ms/library_graph_ms, the
cold-L2 single launch in cold_ms where measured, bound and what sets it,
`launches`: the launches over the main paths' runs of phases 6, 7, 12
and 15, and `launches_per_tick`: the launches per replayed tick in those
runs' profiler windows, both summed over them; the core kernels run only
on the islands fixture, in phase 12; phase 15's path launches only
rvq_encode), the card's name and
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
# int8 islands and the rest of K1's op set, at the same widths (phase 12)
ISLANDS_FIXTURE = os.path.join(REPO, "tests", "golden",
                               "synthetic_lyra_islands", "full")
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
SERVE_CAP = 1024  # phase 10: serve_main's capacity
SERVE_DELAY = 4  # phase 10: playout delay of the checked decode/bridge runs
SERVE_CHECK_ENCODE = 8  # phase 10: ticks of the checked encode run
SERVE_SENDERS = 4  # phase 10: traffic processes
SERVE_PACED = 500  # phase 10: downlink ticks of each paced run (10 s)
OFFLINE_HOPS = 150  # phase 11: hops of each facade run
OFFLINE_CLI_SECONDS = 10  # phase 11: length of each CLI wav
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
    sources = ("conv_stack.cu", "rvq_encode.cu", "core_ops.cu", "out_edge.cu")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        libs = list(pool.map(cuda_build.build, sources))
    ptxas = []
    for src in sources:
        stem = os.path.splitext(src)[0]
        with open(os.path.join(cuda_build.BUILD_DIR, f"{stem}.ptxas.txt")) as f:
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
        if name == "lyragan":
            _edge_timing("K1", fused, batch, dev, torch.float32, 1e-6, stats,
                         gpu, PEAK_FP32_FLOPS, "FP32")
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
        if name == "lyragan":
            _edge_timing("K1-bf16", fused, batch, dev, torch.bfloat16,
                         BF16_CALL_TOL, stats, gpu, PEAK_BF16_FLOPS, "bf16")
    print(f"K1-bf16 vs plain: ok, max rel err {'; '.join(lines)} (B=64, 20 "
          f"frames); per-hop bf16 fused launches at B={batch} within "
          f"{BF16_CALL_TOL} x max|ref|, new state rows bitwise: "
          + ", ".join(f"{k.name} {stats[k.name]['calls']} calls max abs err "
                      f"{stats[k.name]['max_abs_err']:.3e}"
                      for k in conv_stack.KERNELS_BF16))
    _print_depthwise_plans("K1-bf16", batch, plans)
    _time_rounds("K1-bf16", calls, conv_stack.KERNELS_BF16, batch, stats, gpu,
                 PEAK_BF16_FLOPS, "bf16")


def _edge_timing(phase, fused, batch, dev, dtype, bar, stats, gpu, peak_flops,
                 peak_name):
    """LyraGAN's output edge (ops/out_edge.py, one launch a hop) on random
    operands at B=4096 and at the main path's batch: the kernel vs its
    plain version (the executor's ops, cuDNN's choice of algorithm; PCM
    within bar × max|plain|, the new state within bar × max|state|) and vs
    the library yardstick, the same ops on cuDNN's deterministic algorithms
    as FusedStack ran them before the kernel (FusedStack._edges), timed
    as _time_rounds does, then one launch after an L2 flush (cold).  The
    main path's batch comes last, so its numbers stay in `stats`."""
    import torch

    edge = fused.edge
    check(edge is not None, f"{phase}: LyraGAN's epilogue is not one launch")
    kernel = edge.kernel
    gen = torch.Generator(device=dev).manual_seed(11)
    t_in, c = fused.sg.tensors[edge.x].shape[1], edge.w.shape[1]
    rows = fused._state_shapes[edge.state][1]
    st = stats[kernel.name]
    for b in (4096, batch):
        x = torch.randn(b, t_in, c, device=dev, generator=gen).to(dtype)
        state = torch.randn(b, rows, device=dev, generator=gen).to(dtype)
        got, ref = edge(x, state), edge.plain(x, state)

        def library(x=x, state=state):
            with fused._edges():
                return edge.plain(x, state)

        lib = library()
        for name, want in (("plain", ref), ("library", lib)):
            for i in (0, 1):
                tol = bar * want[i].float().abs().max().item()
                err = (got[i].float() - want[i].float()).abs().max().item()
                check(err <= tol, f"{phase} {kernel.name} B={b} vs {name}: "
                      f"abs err {err} > {tol}")
                if name == "plain":
                    st["max_abs_err"] = max(st["max_abs_err"], err)
        st["calls"] = 1
        check(torch.equal(edge(x, state)[0], got[0]),
              f"{phase} {kernel.name}: two launches differ")
        e = x.element_size()
        flop = 2 * b * t_in * edge.w.shape[0] * c
        nbytes = ((x.numel() + edge.w.numel() + 2 * state.numel()) * e
                  + got[0].numel() * 4)
        call = partial(edge, x, state)
        _time_rounds(f"{phase} edge", [(kernel.name, call,
                                        partial(edge.plain, x, state),
                                        library, (flop, nbytes))],
                     (kernel,), b, stats, gpu, peak_flops, peak_name)
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        cold = single_launch_ms(call, partial(flush.fill_, 1))
        del flush
        st["cold_ms"] = cold
        print(f"{phase} edge single launch at B={b} after writing "
              f"{FLUSH_BYTES >> 20} MB (cold), median of 20: {cold:.4f} ms; "
              f"graph {st['graph_ms']:.4f}, eager {st['ms']:.4f}, plain "
              f"graph/eager {st['plain_graph_ms']:.4f}/{st['plain_ms']:.4f}, "
              f"cuDNN edge graph/eager {st['library_graph_ms']:.4f}/"
              f"{st['library_ms']:.4f} ms [{gpu}]")


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
    """One eager hop under torch.profiler (after one profiler warm-up
    step, which can lose device records): every CUDA kernel inside the
    core's span (CORE_SPAN, the record_function around the plan's
    launches, as the profiler places it on the device's timeline) must be
    a conv-stack kernel, one per launch of the plan.  A window is read
    only once it holds the span and a record of every conv-stack launch
    the wrappers counted in its hop (`_recorded`)."""
    import torch

    from lyra_tpu_torch.ops import conv_stack

    x = torch.tensor(np.random.default_rng(8).normal(0.0, scale,
                                                     (batch,) + shape),
                     dtype=torch.float32, device=dev)
    state = fused.init_state(batch)
    fused(state, x)  # warm-up: cuDNN's first calls
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    per_hop = []  # each window's conv-stack launches per hop

    def profile(_):
        before = sum(k.launches for k in conv_stack.KERNELS)
        prof = _profile_ticks(lambda _: fused(state, x), n=1)
        # two hops: the profiler's warm-up step and the profiled one
        per_hop.append((sum(k.launches for k in conv_stack.KERNELS)
                        - before) / 2)
        return prof

    def records(prof):
        dev_events = [e for e in prof.events()
                      if getattr(e, "device_type", None) == cuda]
        return dev_events, [e for e in dev_events if e.name == CORE_SPAN], [
            e for e in dev_events
            if any(_own(k, e.name) for k in conv_stack.KERNELS)]

    def complete(prof):
        _, spans, own = records(prof)
        return len(spans) == 1 and len(own) == per_hop[-1]

    prof, window = _recorded(profile, complete)
    dev_events, spans, own = records(prof)
    check(all(n == len(fused.plan) for n in per_hop),
          f"K1 wrappers: {per_hop} launches per hop for {len(fused.plan)} "
          f"launches in the plan")
    check(len(spans) == 1, f"profiler: {len(spans)} device spans of the core"
          f" in {window} profiler windows")
    check(len(own) == per_hop[-1], f"profiler: {len(own)} conv-stack kernel "
          f"records for {per_hop[-1]:g} launches in {window} windows")
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
            f"launch" + (f" (profiler window {window}: the earlier ones "
                         f"lost device records)" if window > 1 else ""))


def _fused_calls(phase, fused, batch, dev, dtype, bar, stats, plans):
    """Each fused launch of one hop at `batch` on random operands of its
    shapes vs its plain version (|err| ≤ bar × max|plain|; the new state
    rows bit for bit) and vs the library yardstick; → the timing calls."""
    import torch

    from lyra_tpu_torch.ops import conv_stack
    from lyra_tpu_torch.ops.fused_stack import FusedLaunch

    gen = torch.Generator(device=dev).manual_seed(9)
    calls = []
    for launch in fused.plan:
        if not isinstance(launch, FusedLaunch):  # core kernels: phase 12
            continue
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


def _rvq_near_ties(phase, got, ref, feats, rvq) -> int:
    """Rows of RVQ indices `got` that differ from the plain search's `ref`
    on the same features: each must first differ at a near-tie of the
    plain scores.  → their count."""
    import torch

    cb, c2 = rvq.codebooks, rvq.c2
    rows = (got != ref).any(dim=1)
    n_diff = int(rows.sum().item())
    for r in torch.nonzero(rows).flatten().tolist():
        s = int(torch.nonzero(got[r] != ref[r])[0].item())
        resid = feats[r].double() - sum(
            (cb[j, ref[r, j]].double() for j in range(s)),
            torch.zeros(64, dtype=torch.float64, device=feats.device))
        scores = c2[s].double() - 2.0 * cb[s].double() @ resid
        top = torch.sort(scores).values[:2]
        check(abs((top[1] - top[0]).item()) < 1e-5 * max(abs(top[0].item()), 1.0),
              f"{phase}: row {r} differs at stage {s} without a near-tie")
    return n_diff


def phase_k2(rvq, batch, dev, stats, gpu):
    import torch

    from lyra_tpu_torch.ops import rvq_kernel

    b = 4096
    feats = torch.tensor(np.random.default_rng(2).normal(0.0, 1.0, (b, 64)),
                         dtype=torch.float32, device=dev)
    cb, c2 = rvq.codebooks, rvq.c2
    got = rvq_kernel.rvq_encode(feats, cb, c2, 46)
    ref = rvq_kernel.rvq_encode_plain(feats, cb, c2, 46)
    n_diff = _rvq_near_ties("K2", got, ref, feats, rvq)
    check(n_diff <= b // 1000, f"K2: {n_diff} of {b} rows differ")
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
PROFILE_WINDOWS = 5  # windows `_recorded` takes until one lost no record


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


def _recorded(profile, complete):
    """`profile(w)` for profiler windows w = 0, 1, ... until
    `complete(prof)`, at most PROFILE_WINDOWS.  A window now and then
    loses device records (seen on the card: all of them, or the kernels
    of its first few hundred µs), and such a window checks nothing; a
    fault of the path shows in every window, and the checks after this
    one read the last.  → (its profile, its number from 1)."""
    for window in range(1, PROFILE_WINDOWS + 1):
        prof = profile(window - 1)
        if complete(prof):
            break
    return prof, window


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
    after, the last 3 ticks under torch.profiler (or, should that window
    lose device records, 3 spare ticks after them).  A replay runs no
    wrapper, so the counts are those of the captures: one warm-up and two
    captures (ping-pong trees) of each step, 3 × the launches per tick,
    which the profiler counts in the replays.  Checks launches, kernel
    names and counts in the replays, shape, finiteness and speech level;
    returns (launches, launches per tick, summary)."""
    import torch

    from lyra_tpu_torch.ops import conv_stack, out_edge, rvq_kernel

    audio, received = _inputs(batch, ticks, dev, enc.hop_samples)
    lost = 1.0 - received.float().mean().item()
    es, ds = enc.init_state(batch), dec.init_state(batch)
    num_bits = 120
    outs, cn_count = [], 0
    every = conv_stack.KERNELS + rvq_kernel.KERNELS + out_edge.KERNELS
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

    def spare(i):  # a tick after the run's, on its first inputs again
        nonlocal es, ds
        _, _, es, ds, _ = _tick(enc, dec, es, ds, audio[i], received[i],
                                num_bits)

    def counts(prof):
        events = _device_events(prof)
        return {k.name: sum(c for n, (_, c) in events.items() if _own(k, n))
                for k in kernels}

    # The run's last 3 ticks; should that window lose device records, 3
    # spare ticks after the run under the profiler again.
    run_window = prof
    prof, window = _recorded(
        lambda w: run_window if w == 0 else _profile_ticks(spare),
        lambda p: counts(p) == {k.name: launches[k.name] for k in kernels})
    events = _device_events(prof)
    check(bool(events), "profiler recorded no CUDA events")
    # Per tick, each of the path's kernels summed over its instances.
    per_tick = {k.name: sum(us for n, (us, _) in events.items() if _own(k, n))
                / 3 for k in kernels}
    counted = counts(prof)
    check(all(counted.values()), f"profiler: kernels missing {counted}")
    check(all(c % 3 == 0 and launches[n] == c for n, c in counted.items()),
          f"main path: launches {launches} are not 3 x the launches per "
          f"replayed tick (profiler, 3 ticks: {counted}; {window} windows)")
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
    tick_numbers = {"device_us": sum(us for us, _ in events.values()) / 3,
                    "kernels": all_kernels}
    return {k.name: launches[k.name] for k in kernels}, per_tick_launches, (
        f"B={batch} x {ticks} ticks at {enc.sample_rate_hz} Hz, {lost:.1%} "
        f"of hops lost, audio RMS {rms:.1f} (int16), {cn_count} "
        f"comfort-noise stream-hops; launches over the run (warm-up and two "
        f"captures of each step) { {k.name: launches[k.name] for k in kernels} }"
        f", per replayed tick (profiler) {per_tick_launches}, all CUDA "
        f"kernels per replayed tick {all_kernels:g}; device µs per "
        f"captured tick ("
        + ("last 3 ticks" if window == 1 else f"profiler window {window}, 3 "
           f"spare ticks: the earlier ones lost device records")
        + "): "
        f"all {sum(us for us, _ in events.values()) / 3:.1f}, "
        + ", ".join(f"{n} {t:.1f}" for n, t in per_tick.items())
        + f"; over the {ticks} ticks {clocks.summary()}; an eager tick's "
        f"kernels (profiler, 3 ticks): {all_us:.1f} device µs per tick, "
        f"{core_us:.1f} inside the conv stacks' core spans, "
        f"{all_us - core_us:.1f} outside them"), tick_numbers


def phase_main(path, batch, ticks, dev, profile_out):
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, out_edge, rvq_kernel

    enc = EncoderEngine(16000, path, device=dev)
    dec = DecoderEngine(16000, path, device=dev)
    launches, per_tick, summary, tick = _drive(
        enc, dec, conv_stack.KERNELS_F32 + rvq_kernel.KERNELS
        + (out_edge.OUT_EDGE,), batch, ticks,
        dev, profile_out and os.path.join(profile_out,
                                          "chip_smoke_profile.txt"))
    unfused = _kernels_per_replayed_tick(*_unfused(
        (EncoderEngine(16000, path, device=dev),
         DecoderEngine(16000, path, device=dev))), batch, dev)
    b_ref, same_idx, worst_lsb = _vs_plain_f32(enc, dec, path, batch, dev)
    print(f"main path: ok, {summary}; with the cores unfused {unfused:g} "
          f"CUDA kernels per replayed tick; vs plain path (B={b_ref}, 10 "
          f"ticks): rows with identical indices {same_idx:.4f}, decoder max "
          f"diff {worst_lsb} LSB")
    return launches, per_tick, tick


def _vs_plain_f32(enc, dec, path, batch, dev, phase="main"):
    """Correctness of the float slice at 16 kHz against the plain path: the
    same indices through the plain decoder agree with the kernel decoder
    within 2 int16 LSB, and 99 % of rows get identical indices.  →
    (streams, share of identical rows, worst LSB)."""
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine

    audio, received = _inputs(batch, TICKS, dev)
    num_bits = 120
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
    check(worst_lsb <= 2.0,
          f"{phase}: kernel vs plain decoder: {worst_lsb} LSB")
    check(same_idx >= 0.99, f"{phase}: kernel vs plain encoder: "
          f"{same_idx:.4f} rows with identical indices")
    return b_ref, same_idx, worst_lsb


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
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, out_edge, rvq_kernel

    rate = RATE_BF16
    enc = EncoderEngine(rate, path, mode="bf16", device=dev)
    dec = DecoderEngine(rate, path, mode="bf16", device=dev)
    launches, per_tick, summary, tick = _drive(
        enc, dec, conv_stack.KERNELS_BF16 + rvq_kernel.KERNELS
        + (out_edge.OUT_EDGE_BF16,), batch, ticks,
        dev, profile_out and os.path.join(profile_out,
                                          "chip_smoke_profile_bf16.txt"))
    unfused = _kernels_per_replayed_tick(*_unfused(
        (EncoderEngine(rate, path, mode="bf16", device=dev),
         DecoderEngine(rate, path, mode="bf16", device=dev))), batch, dev)
    print(f"main-bf16 path: ok, {summary}; with the cores unfused "
          f"{unfused:g} CUDA kernels per replayed tick; "
          f"{_vs_plain_bf16(enc, dec, path, batch, dev)}")
    return launches, per_tick, tick


def _vs_plain_bf16(enc, dec, path, batch, dev, phase="main-bf16"):
    """The bf16 slice at 48 kHz vs the plain bf16 path from identical
    inputs: each tick the plain engines start from the kernel engines'
    pre-tick state (and the plain f32 engines from the same state
    widened), so a discrete decision cannot carry a difference; features
    and decoder audio within bf16_bar, indices identical.  → summary."""
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine

    rate, num_bits = RATE_BF16, 120
    nq = num_bits // 4
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
              f"{phase}: indices differ from identical features, tick {t}")
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
        check(err[k] <= bars[k], f"{phase}: kernel vs plain bf16 {k} "
              f"rel err {err[k]} > {bars[k]}")
    return (f"vs plain bf16 path (B={b_ref}, 10 ticks, identical inputs): "
            f"indices identical, max rel err features "
            f"{err['features']:.3e}, audio {err['audio']:.3e}; plain bf16 vs "
            f"plain f32: features {plain_dev['features']:.3e}, audio "
            f"{plain_dev['audio']:.3e}; bars {bars}")


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
               wires=None, cn_in=None):
    """Phase 9's schedule on a server pair over the engines: all streams
    admitted; SERVE_CHURN evicted at tick 10; SERVE_CHURN new ones admitted
    into their slots and SERVE_CHURN others evicted at tick 20; both
    servers saved and restored into a fresh pair at tick 30.  Synchronous:
    EncoderServer.tick_wire → DecoderServer.tick_wire.  Asynchronous: the
    tick_wire_async pipelines, the decoder fed the synchronous run's
    `wires`, outputs placed at the tick they belong to.  → per tick
    (wire, sizes, audio, comfort-noise flags) as numpy, and the slots
    re-admitted at tick 20; a synchronous run appends to a list `cn_in`
    each tick's rows with comfort noise in the hop (phase 14)."""
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
                pre = dec._state
                wire, sizes = enc.tick_wire(pcm[t])
                a = dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
                outs[t] = (wire, sizes, a, dec._last_comfort.copy())
                if cn_in is not None:
                    cn_in.append(_cn_enters(pre, dec._state))
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
        prof, _ = _recorded(
            lambda w, servers=servers: _profile_ticks(
                lambda i: _serve_ticks(servers, pcm, received, 1,
                                       start=4 * w + i)),
            lambda p: all(any(_own(k, n) for n in _device_us(p))
                          for k in kernels))
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


# ---- phase 10: the serving process (tools/serve_main.py) -------------------


def _echo_socket():
    """A loopback receiver for a serve run's downlink, with a receive
    buffer that holds the whole checked run (SO_RCVBUFFORCE where the
    process may, else as much as SO_RCVBUF gives)."""
    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, 33, 256 << 20)  # SO_RCVBUFFORCE
    except OSError:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 256 << 20)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.01)
    return sock


class _ServeRun:
    """serve_main.main in a thread, on the card (its default device).  Its
    first ticks capture CUDA graphs in that thread, so while it runs this
    thread does host work only: sockets and the native egress."""

    def __init__(self, argv, on_ready=None):
        import threading

        from lyra_tpu_torch.tools import serve_main

        self.port = None
        self.error = None
        self.rc = None
        self.ready = threading.Event()
        self.stop = threading.Event()

        def ready(port):
            self.port = port
            if on_ready is not None:
                on_ready(port)
            self.ready.set()

        def target():
            try:
                self.rc = serve_main.main(argv, _on_ready=ready,
                                          _stop=self.stop)
            except BaseException as e:  # re-raised by join()
                self.error = e
                self.ready.set()

        import torch

        gc.collect()
        torch.cuda.synchronize()
        gc.disable()  # no collection of CUDA objects in this thread meanwhile
        self.thread = threading.Thread(target=target, name="serve_main")
        self.thread.start()
        check(self.ready.wait(300), "serve: the server never bound its port")
        if self.error is not None:
            self.join()

    def join(self, timeout=300):
        self.stop.set()
        self.thread.join(timeout)
        check(not self.thread.is_alive(), "serve: the serve loop did not stop")
        gc.enable()
        if self.error is not None:
            raise SmokeFailure(f"serve: serve_main raised {self.error!r}") \
                from self.error
        check(self.rc == 0, f"serve: serve_main returned {self.rc}")


def _send_loop(port, payload, sizes, rows, period, started, stop, sent,
               stripe=16):
    """A traffic process: once `port` is set, one datagram per slot of
    `rows` (a range of payload's rows; native egress) every `period` s
    with rising sequence until `stop` is set; `sent` counts the datagrams
    handed to the kernel.  Each period's rows leave in bursts of `stripe`
    spread over it, as callers' datagrams spread over a tick, so the
    receiving socket's buffer never takes more than a burst at once."""
    from lyra_tpu_torch.tools.udp_egress import UdpEgress

    while not port.value and not stop.is_set():
        time.sleep(0.001)
    bounds = list(range(rows.start, rows.stop, stripe)) + [rows.stop]
    with UdpEgress(payload.shape[0], ("127.0.0.1", port.value)) as tx:
        seq, t_next = 0, time.perf_counter()
        while not stop.is_set():
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                n = tx.send_range(payload, sizes, seq, lo, hi)
                with sent.get_lock():
                    sent.value += n
                t_next += period / (len(bounds) - 1)
                time.sleep(max(0.0, t_next - time.perf_counter()))
            started.set()
            seq += 1


class _Sender:
    """_send_loop in SERVE_SENDERS processes of their own, each over a
    contiguous share of the rows, so the serving thread's interpreter
    lock never delays the traffic and no one process's sends bound its
    rate.  Start it before the server; `aim(port)` starts the traffic."""

    def __init__(self, payload, sizes, period):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        procs = SERVE_SENDERS
        self.port, self.sent = ctx.Value("i", 0), ctx.Value("q", 0)
        self.stop = ctx.Event()
        self.started = [ctx.Event() for _ in range(procs)]
        cuts = np.linspace(0, payload.shape[0], procs + 1).astype(int)
        self.procs = [ctx.Process(target=_send_loop, daemon=True, args=(
            self.port, payload, sizes, range(cuts[i], cuts[i + 1]), period,
            self.started[i], self.stop, self.sent)) for i in range(procs)]
        for proc in self.procs:
            proc.start()

    def aim(self, port):
        self.port.value = port
        check(all(ev.wait(120) for ev in self.started),
              "serve: a traffic process never sent")

    def close(self):
        self.stop.set()
        for proc in self.procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(30)


def _read(path):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return "unreadable"


def _stats(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _recv_echo(sock, run, want, cap, width, timeout=240.0):
    """Downlink datagrams of sequences 0..want-1 from every slot →
    (payload [want, cap, width] u8, size [want, cap])."""
    import socket

    got = np.zeros((want, cap, width), np.uint8)
    size = np.full((want, cap), -1, np.int64)
    missing, deadline = want * cap, time.time() + timeout
    while missing and time.time() < deadline and run.error is None:
        try:
            d = sock.recv(65536)
        except socket.timeout:
            continue
        slot = int.from_bytes(d[:2], "big")
        seq = int.from_bytes(d[2:6], "big")
        if seq < want and slot < cap and size[seq, slot] < 0:
            size[seq, slot] = len(d) - 6
            got[seq, slot, :len(d) - 6] = np.frombuffer(d[6:], np.uint8)
            missing -= 1
    return got, size, missing


def _timeline(seed, cap, seqs):
    """The checked decode and bridge runs' uplink: per sequence a wire
    matrix [cap, 23] and sizes — 8, 15 and 23 bytes, 5% of an unknown
    size (counted drops), 15% lost (size 0: never sent) — and the order
    the sequences are sent in."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([8, 15, 23], (seqs, cap)).astype(np.int32)
    sizes[rng.random((seqs, cap)) < 0.05] = 5
    sizes[rng.random((seqs, cap)) < 0.15] = 0
    wire = rng.integers(0, 256, (seqs, cap, 23), dtype=np.uint8)
    return wire, sizes, rng.permutation(seqs)


def _preload(wire, sizes, order):
    """on_ready hook: every datagram of the timeline sent (native egress,
    one sendmmsg per sequence) before the first tick."""
    from lyra_tpu_torch.tools.udp_egress import UdpEgress

    def on_ready(port):
        with UdpEgress(wire.shape[1], ("127.0.0.1", port)) as tx:
            for seq in order:
                tx.send(wire[seq], sizes[seq], int(seq))
                time.sleep(0.002)  # the pump files a burst meanwhile
        time.sleep(0.5)

    return on_ready


def _replay_collects(wire, sizes, order, ticks, delay):
    """The timeline through a fresh JitterBuffer of the serve loop's
    geometry, collected `ticks` times."""
    from lyra_tpu_torch import config
    from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer

    cap = wire.shape[1]
    jb = JitterBuffer(cap, config.packet_size(184), depth=delay + 6)
    for slot in range(cap):
        jb.add_stream(slot, playout_delay=delay)
    for seq in order:
        for slot in np.flatnonzero(sizes[seq] > 0):
            jb.insert(int(slot), int(seq), wire[seq, slot, :sizes[seq, slot]]
                      .tobytes())
    return [jb.collect() for _ in range(ticks)]


def _path_kernels(*engines):
    """The kernels the engines' steps launch: each conv stack's fused
    launches, and the RVQ search of an encoder."""
    from lyra_tpu_torch.codec.engine import EncoderEngine
    from lyra_tpu_torch.ops import rvq_kernel

    out = []
    for e in engines:
        model = e.soundstream if isinstance(e, EncoderEngine) else e.gan
        out += [launch.kernel for launch in model._run.plan]
        if isinstance(e, EncoderEngine):
            out += list(rvq_kernel.KERNELS)
    return list(dict.fromkeys(out))


def _serve_check(path, mode, dev, tmp, kernels):
    """One checked run of `mode` at SERVE_CAP and its offline replay on
    eager engines on the card; → the serve process's launch counts."""
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.tools.conference import ConferenceBridge
    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    cap, delay = SERVE_CAP, SERVE_DELAY
    stats = os.path.join(tmp, f"{mode}-check.jsonl")
    echo = _echo_socket()
    argv = ["--mode", mode, "--capacity", str(cap), "--model_path", path,
            "--seconds", "0", "--report_every", "60", "--stats", stats,
            "--echo", f"127.0.0.1:{echo.getsockname()[1]}"]
    sender = None
    if mode == "encode":
        rate = 48000
        hop = rate // 50
        t = np.arange(hop) / rate
        hops = np.stack([(2000 + 20 * s) * np.sin(2 * np.pi * (100 + 3 * s) * t)
                         for s in range(cap)]).astype(np.int16)
        want = SERVE_CHECK_ENCODE
        argv += ["--sample_rate_hz", str(rate), "--bitrate", "6000"]

        # A fresh hop per slot every 8 ms, from before the first tick.
        sender = _Sender(hops, np.full(cap, 2 * hop, np.int32), 0.008)

        def on_ready(port):
            sender.aim(port)
            time.sleep(0.05)
    else:
        wire, sizes, order = _timeline(10 + len(mode), cap, delay + 6)
        want = delay + 6 + 4  # the timeline's hops, then four lost
        argv += ["--playout_delay", str(delay)]
        if mode == "bridge":
            argv += ["--room_size", "4", "--bitrate", "6000"]
        on_ready = _preload(wire, sizes, order)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    run = _ServeRun(argv, on_ready)
    width = 640 if mode == "decode" else 23
    try:  # the traffic outlives the serve loop: no tick of it goes short
        got, size, missing = _recv_echo(echo, run, want, cap, width)
        run.join()
    finally:
        if sender is not None:
            sender.close()
    wall = time.time() - t0
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() - base
    echo.close()
    check(missing == 0, f"serve {mode}: {missing} downlink datagrams of "
          f"sequences 0-{want - 1} never arrived")
    rec = _stats(stats)[-1]
    check(rec["final"] and rec["mode"] == mode and rec["capacity"] == cap,
          f"serve {mode}: stats record {rec}")
    check(peak > 0, f"serve {mode}: nothing was allocated on the card")

    # The offline replay, on eager engines on the card.
    t1 = time.time()
    if mode == "decode":
        check(rec["jb"]["late_drops"] == rec["jb"]["overflow_drops"] == 0
              and rec["ingest"]["datagrams"] == int((sizes > 0).sum()),
              f"serve decode: the timeline did not land whole {rec}")
        dec = DecoderServer(cap, engine=_eager(DecoderEngine(
            16000, path, emit_dtype="int16", max_bitrate=9200, device=dev)))
        dec.add_streams(range(cap))
        for seq, (pkts, received, sz) in enumerate(
                _replay_collects(wire, sizes, order, want, delay)):
            audio = dec.tick_wire(pkts, received, sz.astype(np.int32))
            check(np.array_equal(got[seq], audio.view(np.uint8))
                  and (size[seq] == 640).all(),
                  f"serve decode: echoed PCM differs from the replay at "
                  f"tick {seq}")
        check(rec["bad_packets"] == int(dec.bad_packets.sum()) > 0,
              f"serve decode: bad_packets {rec['bad_packets']} vs replay "
              f"{int(dec.bad_packets.sum())}")
        used = _path_kernels(dec.engine)
    elif mode == "bridge":
        check(rec["jb"]["late_drops"] == rec["jb"]["overflow_drops"] == 0
              and rec["ingest"]["datagrams"] == int((sizes > 0).sum()),
              f"serve bridge: the timeline did not land whole {rec}")
        bridge = ConferenceBridge(
            cap, bitrate=6000,
            dec_engine=_eager(DecoderEngine(16000, path, max_bitrate=9200,
                                            emit_dtype="int16", device=dev)),
            enc_engine=_eager(EncoderEngine(16000, path, max_bitrate=9200,
                                            device=dev)))
        bridge.add_participants({slot: slot // 4 for slot in range(cap)})
        for seq, (pkts, received, sz) in enumerate(
                _replay_collects(wire, sizes, order, want, delay)):
            w, s = bridge.tick_wire(pkts, received, sz.astype(np.int32))
            check(np.array_equal(size[seq], s) and np.array_equal(
                got[seq, :, :w.shape[1]], w),
                f"serve bridge: downlink differs from the replay at tick {seq}")
        check(rec["bad_packets"] == int(bridge.bad_packets.sum()) > 0,
              f"serve bridge: bad_packets {rec['bad_packets']} vs replay "
              f"{int(bridge.bad_packets.sum())}")
        used = _path_kernels(bridge._dec.engine, bridge._enc.engine)
    else:
        check(rec["pcm_gaps"] == 0,
              f"serve encode: {rec['pcm_gaps']} PCM gaps (a tick found no "
              f"fresh hop): {rec}; the traffic process sent "
              f"{sender.sent.value} datagrams; net.core.rmem_max "
              f"{_read('/proc/sys/net/core/rmem_max')}")
        enc = EncoderServer(cap, engine=_eager(EncoderEngine(
            rate, path, max_bitrate=9200, device=dev)), bitrate=6000)
        enc.add_streams(range(cap))
        for seq in range(want):
            w, s = enc.tick_wire(hops)
            check(np.array_equal(size[seq], s) and np.array_equal(
                got[seq, :, :w.shape[1]], w),
                f"serve encode: packets differ from the replay at tick {seq}")
        used = _path_kernels(enc.engine)
    for k in used:
        check(counts[k.name] > 0,
              f"serve {mode}: {k.name} never launched in the serve process")
    print(f"serve-process {mode}: ok, capacity {cap}, {want} ticks of "
          f"downlink bitwise equal to an offline replay on eager engines"
          + (f" (playout delay {delay}, {int((sizes > 0).sum())} datagrams "
             f"preloaded, {rec['bad_packets']} bad packets)"
             if mode != "encode" else " (constant 48 kHz hops, 0 PCM gaps)")
          + f"; {rec['ticks']} ticks in {wall:.1f} s (engines built and "
          f"captured), replay {time.time() - t1:.1f} s; launches in the serve "
          f"process {{{', '.join(f'{k.name}: {counts[k.name]}' for k in used)}}}"
          f"; peak device memory {peak / 2**20:.0f} MiB")
    return counts


def _serve_paced(path, mode, tmp, gpu):
    """`mode` with traffic every 20 ms until its downlink has carried
    SERVE_PACED ticks; → the final stats record."""
    from lyra_tpu_torch.tools.udp_ingest import SinkIngest

    cap = SERVE_CAP
    stats = os.path.join(tmp, f"{mode}-paced.jsonl")
    sink = SinkIngest(2048)
    argv = ["--mode", mode, "--capacity", str(cap), "--model_path", path,
            "--seconds", "0", "--report_every", "5",
            "--stats", stats, "--echo", f"127.0.0.1:{sink.port}"]
    rng = np.random.default_rng(20)
    if mode == "encode":
        argv += ["--sample_rate_hz", "48000", "--bitrate", "6000"]
        payload = rng.integers(-8000, 8000, (cap, 960)).astype(np.int16)
        sizes = np.full(cap, 1920, np.int32)
    else:
        payload = rng.integers(0, 256, (cap, 15), dtype=np.uint8)
        sizes = np.full(cap, 15, np.int32)
        if mode == "bridge":
            argv += ["--room_size", "4", "--bitrate", "6000"]
    sender = _Sender(payload, sizes, 0.02)
    try:
        run = _ServeRun(argv, sender.aim)  # traffic from the first tick on
        t0 = time.perf_counter()
        while (run.thread.is_alive() and time.perf_counter() - t0 < 120
               and sink.stats()["datagrams"] < (SERVE_PACED + 5) * cap):
            time.sleep(0.05)
        run.join()
    finally:
        sender.close()
    wall = time.perf_counter() - t0
    sink.close()
    records = _stats(stats)
    rec = records[-1]
    check(rec["final"] and rec["ticks"] >= SERVE_PACED,
          f"serve {mode} paced: {rec['ticks']} ticks, want >= {SERVE_PACED}")
    drops = {k: v for k, v in {**rec["ingest"], **rec.get("jb", {})}.items()
             if k != "datagrams"}
    last = records[-2] if len(records) > 1 else rec
    # The loop's own pace from its first report (after the captures) to
    # its final record: tick_ms leaves out the downlink send and the
    # pacer's wait.
    first = records[0]
    rate = ((rec["ticks"] - first["ticks"]) / (rec["ts"] - first["ts"])
            if rec["ts"] > first["ts"] else float("nan"))
    print(f"serve-process {mode} paced [{gpu}]: capacity {cap}, uplink "
          f"every 20 ms from {SERVE_SENDERS} processes of their own, "
          f"{wall:.1f} s; "
          f"final record: {rec['ticks']} ticks, tick_ms p50 "
          f"{rec['tick_ms_p50']} p95 {rec['tick_ms_p95']} (all ticks, the "
          f"captures included; last report's 256 ticks p50 "
          f"{last['tick_ms_p50']} p95 {last['tick_ms_p95']}), ingest "
          f"datagrams {rec['ingest']['datagrams']}, drops {drops}"
          + (f", pcm_gaps {rec['pcm_gaps']}" if mode == "encode" else
             f", bad_packets {rec['bad_packets']}")
          + f", egress sent {rec['egress'].get('sent')}; the loop ticked "
          f"{rate:.1f} times a second after its first report (real time: "
          f"50)")
    return rec


def _egress_ms(width, n=50):
    """Mean ms of one tick's downlink send, SERVE_CAP datagrams of `width`
    payload bytes through the native egress to a native sink on
    loopback, with nothing else running."""
    from lyra_tpu_torch.tools.udp_egress import UdpEgress
    from lyra_tpu_torch.tools.udp_ingest import SinkIngest

    wire = np.zeros((SERVE_CAP, width), np.uint8)
    sizes = np.full(SERVE_CAP, width, np.int32)
    with SinkIngest(width) as sink, \
            UdpEgress(SERVE_CAP, ("127.0.0.1", sink.port)) as tx:
        tx.send(wire, sizes, 0)
        total = 0.0
        for seq in range(1, n + 1):
            time.sleep(0.005)  # the sink drains between ticks
            t0 = time.perf_counter()
            tx.send(wire, sizes, seq)
            total += time.perf_counter() - t0
        return total / n * 1e3


def phase_serve_process(path, dev, gpu):
    """Phase 10: python -m lyra_tpu_torch.tools.serve_main's decode, encode
    and bridge modes at capacity SERVE_CAP on the card, native ingest and
    egress."""
    import tempfile

    from lyra_tpu_torch.ops import conv_stack, rvq_kernel
    from lyra_tpu_torch.utils import native

    check(native.load() is not None, "serve: the native library did not load")
    t0 = time.perf_counter()
    for _ in range(100):
        time.sleep(0.001)
    print(f"serve-process: native library {native.lib_path()}; on this "
          f"host time.sleep(0.001) takes "
          f"{(time.perf_counter() - t0) * 10:.3f} ms (mean of 100), the "
          f"serve loop's pacing step")
    every = conv_stack.KERNELS + rvq_kernel.KERNELS
    launched = dict.fromkeys((k.name for k in every), 0)
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("decode", "encode", "bridge"):
            for name, n in _serve_check(path, mode, dev, tmp, every).items():
                launched[name] += n
        for k in conv_stack.KERNELS_F32 + rvq_kernel.KERNELS:
            check(launched[k.name] > 0,
                  f"serve: {k.name} never launched in the serve processes")
        print(f"serve-process: launches in the three checked serve processes "
              f"(warm-ups and captures; a replay launches no wrapper) "
              f"{launched}")
        for mode in ("decode", "encode", "bridge"):
            _serve_paced(path, mode, tmp, gpu)
    print(f"serve-process: one tick's downlink send on this host, "
          f"{SERVE_CAP} datagrams through the native egress to a native "
          f"sink, nothing else running (means of 50 sends, 5 ms apart): PCM "
          f"hops of 640 B {_egress_ms(640):.3f} ms, packets "
          f"of 15 B {_egress_ms(15):.3f} ms")
    print(f"serve-process: phase 10 took {time.time() - t_phase:.1f} s")


# ---- phase 11: the single-stream codec and the offline tools ---------------


def _speech(rate, hops, seed=11):
    """Phase 11's signal: int16 noise at speech level (gain 3000 or 1000
    per hop) in 10-hop stretches with 5-hop near-silent gaps (gain 3)
    between them, so DTX both sends and suppresses."""
    hop = rate // 50
    rng = np.random.default_rng(seed)
    loud = np.where(rng.random(hops) < 0.5, 3000.0, 1000.0)
    gain = np.where(np.arange(hops) % 15 < 10, loud, 3.0)
    x = rng.normal(0.0, 1.0, (hops, hop)) * gain[:, None]
    return np.clip(x, -32768, 32767).astype(np.int16)


def _zero_launches():
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    for k in conv_stack.KERNELS + rvq_kernel.KERNELS:
        k.launches = 0


def _launched(where, kernels):
    """The launch counts since `_zero_launches`; each of `kernels` must
    have launched."""
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    counts = {k.name: k.launches
              for k in conv_stack.KERNELS + rvq_kernel.KERNELS}
    for k in kernels:
        check(counts[k.name] > 0, f"{where} never launched {k.name}")
    return counts


def _float_path_launches(where):
    """`_launched` for every kernel of the float path (the f32 K1 family
    and rvq_encode)."""
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    return _launched(f"offline: {where}",
                     conv_stack.KERNELS_F32 + rvq_kernel.KERNELS)


def _offline_models(path, dev):
    """11.1: each conv stack on the kernel path vs the plain executor at
    B = 1 and 3, float and bf16, 20 frames with state carried (phases 2-3's
    bars); rvq_encode at B = 1 vs its plain version."""
    import torch

    from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer
    from lyra_tpu_torch.ops import rvq_kernel
    from lyra_tpu_torch.ops.fused_stack import FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(12)
    parts = []
    for name, shape, scale in MODELS:
        p = os.path.join(path, f"{name}.tflite")
        plain32 = load_graph(p, device=dev)
        for mode in ("float", "bf16"):
            fused = FusedStack(p, mode=mode, device=dev)
            plain = (plain32 if mode == "float"
                     else load_graph(p, mode="bf16", device=dev))
            for b in (1, 3):
                fs, ps, s32 = (fused.init_state(b), plain.init_state(b),
                               plain32.init_state(b))
                err = plain_dev = 0.0
                for _ in range(20):
                    x = torch.tensor(rng.normal(0.0, scale, (b,) + shape),
                                     dtype=torch.float32, device=dev)
                    y, fs = fused(fs, x)
                    o, ps = plain(ps, input_audio=x)
                    check(bool(torch.isfinite(y).all()),
                          f"offline {name} {mode} B={b}: non-finite")
                    err = max(err, rel_err(y, o["output_0"]))
                    if mode == "bf16":
                        o32, s32 = plain32(s32, input_audio=x)
                        plain_dev = max(plain_dev, rel_err(o["output_0"],
                                                           o32["output_0"]))
                bar = REL_TOL if mode == "float" else bf16_bar(plain_dev)
                check(err <= bar, f"offline {name} {mode} B={b}: kernel vs "
                      f"plain rel err {err} > {bar}")
                parts.append(f"{name} {mode} B={b} {err:.3e} (bar {bar:.3e})")
    rvq = ResidualVectorQuantizer.from_model_path(path, dev)
    feats = torch.tensor(rng.normal(0.0, 1.0, (1000, 64)),
                         dtype=torch.float32, device=dev)
    rows = [feats[i:i + 1] for i in range(feats.shape[0])]
    got = torch.cat([rvq_kernel.rvq_encode(r, rvq.codebooks, rvq.c2, 46)
                     for r in rows])
    ref = torch.cat([rvq_kernel.rvq_encode_plain(r, rvq.codebooks, rvq.c2, 46)
                     for r in rows])
    n_diff = _rvq_near_ties("offline rvq_encode B=1", got, ref, feats, rvq)
    check(n_diff <= len(rows) // 1000,
          f"offline: rvq_encode at B=1, {n_diff} of {len(rows)} rows differ")
    print(f"offline: whole models, kernel path vs plain, max rel err over 20 "
          f"frames: {'; '.join(parts)}; rvq_encode at B=1 vs plain, 1000 "
          f"single-row launches: {n_diff} rows differ (near-ties)")


def _host_tree(tree):
    """A copy of a state tree on the host."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.cpu().clone()


def _differing_packet(enc, state, hop, got: bytes, want: bytes) -> str:
    """Why a card packet `got` differs from the CPU facade's `want`, both
    from the same pre-hop `state` (the CPU facade's): "dtx" if one of them
    is a DTX empty packet, which must be a decision at the noise bound
    (every log-mel bin within 1e-4 of estimate ± bound where it flips);
    else "rvq", which must first differ at a near-tie of the CPU
    features."""
    import torch

    from lyra_tpu_torch import packet
    from lyra_tpu_torch.dsp import utils as dsp_utils

    e = enc._engine
    x = torch.from_numpy(hop.astype(np.float32)[None])
    if e.resampler is not None:
        x, _ = e.resampler.resample(state["resampler"], x)
        x = dsp_utils.clip_to_int16(x).float()
    if (got == b"") != (want == b""):
        noise = state["noise"]
        cur, _ = e.noise._mel.extract(noise["mel"], x)
        margin = ((cur - noise["noise_estimate"]).abs()
                  - noise["noise_bound"]).max().item()
        check(abs(margin) <= 1e-4, f"offline: a DTX decision differs "
              f"{margin:.3e} from the noise bound (card {len(got)} B, CPU "
              f"{len(want)} B)")
        return "dtx"
    feats = e.soundstream.extract(state["soundstream"],
                                  dsp_utils.int16_to_unit(x))[0]
    n = len(packet.unpack_indices(want))
    pad = lambda p: torch.tensor(np.pad(packet.unpack_indices(p), (0, 46 - n),
                                        constant_values=-1))[None]
    check(_rvq_near_ties("offline LyraEncoder", pad(got), pad(want), feats,
                         e.rvq) == 1, "offline: differing packets, equal "
          "indices")
    return "rvq"


def _offline_facades(path, signal):
    """11.2: LyraEncoder and LyraDecoder at their default device (the card)
    vs the same facades on the CPU (the plain versions).  Each carries its
    own state, but with DTX on the CPU encoder starts every hop from the
    card's pre-hop state: a noise decision at the bound may fall either
    way on either device, and must not carry into later hops.  → (the
    card's packets per rate and DTX, launch counts, summary)."""
    from lyra_tpu_torch.codec import LyraDecoder, LyraEncoder
    from lyra_tpu_torch.tools.packet_loss import GilbertModel

    hops = OFFLINE_HOPS
    packets, differ, lines = {}, {"rvq": 0, "dtx": 0}, []
    _zero_launches()
    for rate, audio in signal.items():
        hop = rate // 50
        for dtx in (False, True):
            card = LyraEncoder(rate, 1, 6000, dtx, path)
            cpu = LyraEncoder(rate, 1, 6000, dtx, path, device="cpu")
            got = []
            for h in audio[:hops]:
                if dtx:
                    cpu._state = _host_tree(card._state)
                pre = cpu._state
                g, w = card.encode(h), cpu.encode(h)
                if g != w:
                    differ[_differing_packet(cpu, pre, h, g, w)] += 1
                got.append(g)
            packets[rate, dtx] = got
            empty = sum(p == b"" for p in got)
            check((empty > 0) == dtx, f"offline: {empty} DTX empty packets "
                  f"at {rate} Hz with DTX {'on' if dtx else 'off'}")
            lines.append(f"{rate} Hz DTX {'on' if dtx else 'off'}: "
                         f"{empty} empty")
        # The decoder on the card's packets, Gilbert losses, random requests.
        gilbert = GilbertModel.create(0.1, 2.0)
        rng = np.random.RandomState(rate)
        card, cpu = LyraDecoder(rate, 1, path), LyraDecoder(rate, 1, path,
                                                           device="cpu")
        worst = lost = comfort = 0
        for p in packets[rate, False]:
            if gilbert.is_packet_received():
                check(card.set_encoded_packet(p) and cpu.set_encoded_packet(p),
                      "offline: a packet was refused")
            else:
                lost += 1
            done = 0
            while done < hop:
                n = min(int(rng.randint(1, hop + 1)), hop - done)
                a, b = card.decode_samples(n), cpu.decode_samples(n)
                check(a is not None and a.shape == (n,) == b.shape,
                      f"offline: decode_samples({n}) gave {a!r}")
                worst = max(worst, int(np.abs(a.astype(int)
                                              - b.astype(int)).max()))
                check(card.is_comfort_noise() == cpu.is_comfort_noise(),
                      f"offline: is_comfort_noise differs at {rate} Hz")
                done += n
            comfort += card.is_comfort_noise()
        check(worst <= 2, f"offline: LyraDecoder at {rate} Hz differs from "
              f"the CPU by {worst} LSB")
        lines.append(f"{rate} Hz decoder {lost} of {hops} lost, {comfort} "
                     f"comfort-noise hops, max diff {worst} LSB")
    launches = _float_path_launches("the facades")
    total = 2 * len(signal) * hops
    check(sum(differ.values()) <= total // 1000,
          f"offline: {differ} of {total} packets differ")
    return packets, launches, (
        f"facades vs their CPU versions, {hops} hops each at 6 kbps: packets "
        f"identical but {differ['rvq']} of {total} (RVQ near-ties) and "
        f"{differ['dtx']} (DTX decisions at the noise bound); "
        + "; ".join(lines))


def _facade_pair(path, gpu):
    """Per-hop wall time of the facade pair on the card at 16 kHz (encode
    + set_encoded_packet + decode_samples(320), every hop function one
    replay), after 3 warm hops (the captures); then 3 hops under the
    profiler: device µs and CUDA kernels per hop."""
    import torch

    from lyra_tpu_torch.codec import LyraDecoder, LyraEncoder

    audio = _speech(16000, OFFLINE_HOPS + 7, seed=13)
    enc, dec = LyraEncoder(16000, 1, 6000, model_path=path), \
        LyraDecoder(16000, model_path=path)

    def hop(h):
        check(dec.set_encoded_packet(enc.encode(h)), "offline: pair refused")
        return dec.decode_samples(320)

    for h in audio[:3]:
        hop(h)
    times = []
    for h in audio[3:3 + OFFLINE_HOPS]:
        t0 = time.perf_counter()
        out = hop(h)
        times.append((time.perf_counter() - t0) * 1e3)
        check(out.shape == (320,), "offline: pair output shape")
    events = _device_events(_profile_ticks(
        lambda i: hop(audio[3 + OFFLINE_HOPS + i])))
    device_us = sum(us for us, _ in events.values()) / 3
    kernels = sum(c for n, (_, c) in events.items()
                  if not n.startswith(("Memcpy", "Memset"))) / 3
    copies = sum(c for n, (_, c) in events.items()
                 if n.startswith("Memcpy")) / 3
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    return (
        f"facade pair at 16 kHz, float, B=1, captured: per-hop wall p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms, min {min(times):.3f} ms over "
        f"{OFFLINE_HOPS} hops; per hop (profiler, 3 hops) {device_us:.1f} "
        f"device µs in {kernels:g} CUDA kernels and {copies:g} copies "
        f"[{gpu}]")


class _RateLog:
    """The CLIs' "Samples per second" log lines, as numbers."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                msg = record.getMessage()
                if msg.startswith("Samples per second"):
                    self.rates.append(float(msg.split(":")[1]))

        self.rates, self._handler = [], Handler()
        self._log = logging.getLogger("lyra_tpu")
        self._level = self._log.level
        self._log.addHandler(self._handler)
        self._log.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self._log.removeHandler(self._handler)
        self._log.setLevel(self._level)


def _offline_clis(path, tmp, signal, packets):
    """11.3: encoder_main and decoder_main in process (their default
    device, the card) on a 10 s wav per rate: `.lyra` = hops × 15 bytes,
    its first packets equal 11.2's facade packets of the same samples,
    decoded wavs of the right length twice (fixed loss pattern; Gilbert
    loss with randomized request sizes)."""
    from lyra_tpu_torch.tools import decoder_main, encoder_main
    from lyra_tpu_torch.utils import wav

    _zero_launches()
    lines, rms = [], []
    with _RateLog() as log:
        for rate, audio in signal.items():
            hops, hop = audio.shape
            src = os.path.join(tmp, f"speech_{rate}.wav")
            wav.write_wav_int16(src, audio.reshape(-1), rate)
            check(encoder_main.main([
                f"--input_path={src}", f"--output_dir={tmp}", "--bitrate=6000",
                f"--model_path={path}"]) == 0, "offline: encoder_main failed")
            lyra = os.path.join(tmp, f"speech_{rate}.lyra")
            with open(lyra, "rb") as f:
                data = f.read()
            check(len(data) == hops * 15, f"offline: .lyra of {len(data)} B")
            ref = b"".join(packets[rate, False])
            check(data[:len(ref)] == ref, f"offline: encoder_main's packets "
                  f"at {rate} Hz differ from the facade's")
            for suffix, flags in (
                    ("_fixed", ["--fixed_packet_loss_pattern=0.5,1.5:0.2,0.2"]),
                    ("_gilbert", ["--packet_loss_rate=0.1",
                                  "--average_burst_length=2",
                                  "--randomize_num_samples_requested"])):
                check(decoder_main.main([
                    f"--encoded_path={lyra}", f"--output_dir={tmp}",
                    f"--output_suffix={suffix}", f"--sample_rate_hz={rate}",
                    "--bitrate=6000", f"--model_path={path}", *flags]) == 0,
                    f"offline: decoder_main {suffix} failed")
                out = wav.read_wav_int16(
                    os.path.join(tmp, f"speech_{rate}{suffix}.wav"))
                check(len(out.samples) == hops * hop
                      and out.sample_rate_hz == rate,
                      f"offline: decoded wav of {len(out.samples)} samples")
                rms.append(float(np.sqrt(np.mean(
                    out.samples.astype(float) ** 2))))
                check(rms[-1] > 0.0, f"offline: decoder_main {suffix} wrote "
                      f"silence")
            enc_sps, *dec_sps = log.rates[-3:]
            lines.append(
                f"{rate} Hz: encoder_main {enc_sps / rate:.1f}x real time, "
                f"decoder_main {dec_sps[0] / rate:.1f}x (fixed loss), "
                f"{dec_sps[1] / rate:.1f}x (Gilbert, random requests), "
                f"decoded RMS {rms[-2]:.1f} / {rms[-1]:.1f}")
    check(len(log.rates) == 3 * len(signal), f"offline: {len(log.rates)} "
          f"'Samples per second' lines")
    return _float_path_launches("the CLIs"), "; ".join(lines)


def _offline_batch(path, tmp):
    """11.4: batch_transcode.main over 16 wavs of different lengths, each
    with a trailing partial hop, 7 at 16 kHz and 9 at 48 kHz (odd B):
    each `.lyra` (--mode=encode) byte for byte the single-stream
    encoder's on the card, each decoded wav (--mode=transcode) within 1
    LSB of cli_lib.decode_features through LyraDecoder."""
    from lyra_tpu_torch import config
    from lyra_tpu_torch.codec import LyraDecoder
    from lyra_tpu_torch.tools import batch_transcode, cli_lib
    from lyra_tpu_torch.utils import wav

    indir, outdir = os.path.join(tmp, "batch_in"), os.path.join(tmp, "batch")
    os.makedirs(indir)
    files = []
    for i in range(16):
        rate = 16000 if i < 7 else 48000
        hop = rate // 50
        hops = 12 + 3 * i
        samples = _speech(rate, hops + 1, seed=100 + i).reshape(-1)
        samples = samples[:hops * hop + 1 + 11 * i]  # a partial hop
        files.append((f"f{i:02d}", rate, samples))
        wav.write_wav_int16(os.path.join(indir, f"f{i:02d}.wav"), samples,
                            rate)
    args = ["--input_glob", os.path.join(indir, "*.wav"), "--output_dir",
            outdir, "--bitrate", "6000", "--model_path", path]
    _zero_launches()
    check(batch_transcode.main(args + ["--mode=encode"]) == 0,
          "offline: batch_transcode --mode=encode failed")
    check(batch_transcode.main(args + ["--mode=transcode"]) == 0,
          "offline: batch_transcode --mode=transcode failed")
    launches = _float_path_launches("batch_transcode")
    worst = 0
    for stem, rate, samples in files:
        hop = rate // 50
        whole = len(samples) // hop * hop
        with open(os.path.join(outdir, f"{stem}.lyra"), "rb") as f:
            data = f.read()
        ref = cli_lib.encode_wav(samples[:whole], 1, rate, 6000, False,
                                 False, path)
        check(data == ref, f"offline: batch_transcode's {stem}.lyra differs "
              f"from the single-stream encoder's ({len(data)} vs {len(ref)} "
              f"B, first difference at byte "
              f"{next((j for j, (a, b) in enumerate(zip(data, ref)) if a != b), None)})")
        out = wav.read_wav_int16(os.path.join(outdir, f"{stem}_decoded.wav"))
        want = cli_lib.decode_features(
            data, config.bitrate_to_packet_size(6000), False,
            LyraDecoder(rate, model_path=path, seed=0))
        check(len(out.samples) == len(want) == whole,
              f"offline: {stem} decoded {len(out.samples)} samples")
        worst = max(worst, int(np.abs(out.samples.astype(int)
                                      - want.astype(int)).max()))
    check(worst <= 1, f"offline: batch_transcode audio {worst} LSB from the "
          f"single-stream decoder")
    return launches, (f"batch_transcode over 16 wavs (B=7 at 16 kHz, B=9 at "
                      f"48 kHz, 12-57 hops + a partial hop): every .lyra "
                      f"identical to the single-stream encoder's, decoded "
                      f"audio within {worst} LSB of the single-stream "
                      f"decoder's")


def _b1_model_profiles(path, dev, gpu):
    """One captured hop of each model at B=1 in each mode, 3 replays under
    the profiler: device µs and CUDA kernels per hop, and the 3 kernels
    that take the most device time."""
    import torch

    from lyra_tpu_torch.models.streaming import LyraGanModel, SoundStreamEncoder
    from lyra_tpu_torch.utils.capture import GraphCache

    lines = []
    for cls, fn, width in ((SoundStreamEncoder, "extract", 320),
                           (LyraGanModel, "decode_hop", 64)):
        for mode in ("float", "bf16"):
            model = cls(path, mode=mode, device=dev)
            graphs = GraphCache(dev)
            x = torch.zeros((1, width), dtype=torch.float32, device=dev)
            state = [model.init_state(1)]

            def hop(_=None):
                _, state[0] = graphs.run(getattr(model, fn), "hop", state[0],
                                         x)

            for _ in range(3):
                hop()
            events = _device_events(_profile_ticks(hop))
            kernels = {n: v for n, v in events.items()
                       if not n.startswith(("Memcpy", "Memset"))}
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
            lines.append(
                f"{cls.__name__} {mode}: "
                f"{sum(us for us, _ in events.values()) / 3:.1f} device µs "
                f"in {sum(c for _, c in kernels.values()) / 3:g} kernels; "
                + ", ".join(f"{n[:60]} {us / 3:.1f} µs x {c // 3}"
                            for n, (us, c) in top))
    print(f"offline: one captured hop at B=1 per model and mode (profiler, "
          f"3 hops): {'; '.join(lines)} [{gpu}]")


def _offline_benchmarks(path, gpu):
    """11.5: tools/benchmark.run_benchmark in float and bf16 at batch 1
    and 1024, 200 conditioning vectors, then melspec_benchmark."""
    from lyra_tpu_torch.tools import benchmark, melspec_benchmark

    rows = []
    for mode in ("float", "bf16"):
        for batch in (1, 1024):
            print(f"offline: tools/benchmark.py --mode={mode} --batch={batch} "
                  f"--num_cond_vectors=200 [{gpu}]")
            r = benchmark.run_benchmark(200, batch, 120, path, mode=mode)
            rows.append(f"{mode} B={batch}: " + ", ".join(
                f"{n} {s.mean_us:.1f}" for n, s in r["rows"].items())
                + f" µs mean, {r['streams_per_chip']:.0f} streams per card")
    print(f"offline: stage benchmark {'; '.join(rows)} [{gpu}]")
    print(f"offline: melspec_benchmark --iters 50 [{gpu}]")
    check(melspec_benchmark.main(["--iters", "50"]) == 0,
          "offline: melspec_benchmark failed")


def phase_offline(path, dev, gpu):
    """Phase 11: the single-stream codec (LyraEncoder / LyraDecoder), the
    encoder and decoder CLIs, batch_transcode and the stage benchmarks, at
    each entry point's default device, the card."""
    import tempfile

    t_phase = time.time()
    _offline_models(path, dev)
    signal = {rate: _speech(rate, OFFLINE_CLI_SECONDS * 50)
              for rate in (16000, 48000)}
    launches = {}
    packets, launches["facades"], summary = _offline_facades(path, signal)
    print(f"offline: {summary}")
    print(f"offline: {_facade_pair(path, gpu)}")
    with tempfile.TemporaryDirectory() as tmp:
        launches["clis"], summary = _offline_clis(path, tmp, signal, packets)
        print(f"offline: CLIs in process, 10 s wavs: {summary} [{gpu}]")
        launches["batch_transcode"], summary = _offline_batch(path, tmp)
        print(f"offline: {summary}")
    print("offline launches (warm-ups and captures; a replay launches no "
          "wrapper): " + json.dumps(launches))
    _offline_benchmarks(path, gpu)
    _b1_model_profiles(path, dev, gpu)
    print(f"offline: phase 11 took {time.time() - t_phase:.1f} s")


# ---- phase 12: the islands fixture (K1's whole op set) ----------------------

def _islands_models(path, dev):
    """Both models' FusedStack on the islands fixture in float and bf16 vs
    the plain executor (B=64, 20 frames, state carried; phases 2-3's
    bars), bitwise equal to `unfused` in f32, and one profiled eager hop
    per mode whose core span holds only conv-stack kernels, one per launch
    of the plan: the fixture's conv ops plus its core-kernel calls.  →
    (summary, {dtype: the models' FusedStacks})."""
    import torch

    from lyra_tpu_torch.ops.fused_stack import CoreLaunch, FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(12)
    lines, stacks = [], {torch.float32: [], torch.bfloat16: []}
    for name, shape, scale in MODELS:
        p = os.path.join(path, f"{name}.tflite")
        plain32 = load_graph(p, device=dev)
        for mode in ("float", "bf16"):
            fused = FusedStack(p, mode=mode, device=dev)
            stacks[fused.graph.dtype].append(fused)
            plain = plain32 if mode == "float" else load_graph(
                p, mode="bf16", device=dev)
            fs, ps, s32 = (fused.init_state(64), plain.init_state(64),
                           plain32.init_state(64))
            err = err32 = plain_dev = 0.0
            for _ in range(20):
                x = torch.tensor(rng.normal(0.0, scale, (64,) + shape),
                                 dtype=torch.float32, device=dev)
                y, fs = fused(fs, x)
                o, ps = plain(ps, input_audio=x)
                r = o["output_0"]
                check(bool(torch.isfinite(y).all()),
                      f"islands {name} {mode}: non-finite")
                err = max(err, rel_err(y, r))
                if mode == "bf16":
                    o32, s32 = plain32(s32, input_audio=x)
                    err32 = max(err32, rel_err(y, o32["output_0"]))
                    plain_dev = max(plain_dev, rel_err(r, o32["output_0"]))
            bar = REL_TOL if mode == "float" else bf16_bar(plain_dev)
            check(err <= bar and err32 <= bar, f"islands {name} {mode}: rel "
                  f"err {err} (vs plain f32 {err32}) > {bar}")
            core = [launch for launch in fused.plan
                    if isinstance(launch, CoreLaunch)]
            convs = sum(fused.sg.ops[i].name in ("CONV_2D",
                                                 "DEPTHWISE_CONV_2D",
                                                 "TRANSPOSE_CONV")
                        for i in fused._core)
            check(len(fused.plan) - len(core) == convs and len(core) == sum(
                r == "kernel" for r in fused.roles.values()),
                  f"islands {name}: {len(fused.plan)} launches for {convs} "
                  f"core convs and {len(core)} core-kernel calls")
            line = (f"{name} {mode}: rel err vs plain {err:.3e}"
                    + (f", vs plain f32 {err32:.3e}, plain bf16 vs plain f32 "
                       f"{plain_dev:.3e}" if mode == "bf16" else "")
                    + f" (bar {bar:.3e}); {len(fused.plan)} launches per core"
                    f" = {len(fused.plan) - len(core)} convs + {len(core)} "
                    f"core-kernel calls "
                    f"({', '.join(f'{c.kind} op {c.op}' for c in core)}); ")
            if mode == "float":
                line += _bitwise_unfused(fused, shape, scale, dev) + "; "
            lines.append(line + _core_kernels(fused, shape, scale, BATCH, dev))
    return "; ".join(lines), stacks


def _core_calls(stacks, batch, dev, stats):
    """Each core-kernel call of one hop of `stacks` at `batch` on random
    operands of its shapes (divisors in [1, 2)) vs its plain version
    (bitwise) and vs one PyTorch call for the same function (torch.add /
    sub / mul / div; torch.cat of the slices, or a slice's .contiguous());
    → the timing calls with their (FLOP, bytes): every element of a
    window or operand read once, the output written once, one FLOP per
    elementwise output."""
    import torch

    from lyra_tpu_torch.ops.fused_stack import CoreLaunch, _mapped_shape

    gen = torch.Generator(device=dev).manual_seed(13)
    calls = []
    for fused in stacks:
        dtype = fused.graph.dtype
        for launch in fused.plan:
            if not isinstance(launch, CoreLaunch):
                continue
            srcs = (launch.args if launch.kind == "eltwise"
                    else [p[0] for p in launch.args])
            core = {}
            for k, a in enumerate(srcs):
                if isinstance(a, torch.Tensor):
                    continue
                shape = _mapped_shape(fused.sg.tensors[a].shape)
                v = torch.randn((batch,) + shape, device=dev, generator=gen)
                if launch.arg == "div" and k == 1:
                    v = torch.rand((batch,) + shape, device=dev,
                                   generator=gen) + 1.0
                core[a] = v.to(dtype)
            got, ref = launch(core), launch.plain(core)
            ops = launch.operands(core)
            if launch.kind == "eltwise":
                lib = partial({"add": torch.add, "sub": torch.sub,
                               "mul": torch.mul, "div": torch.div}[launch.arg],
                              *ops)
                nbytes = sum(t.numel() * t.element_size()  # each once
                             for t in {t.data_ptr(): t for t in ops}.values())
                flop = got.numel()
            else:
                wins = [p.window() for p in ops]
                wins = [w if w.shape[0] == batch else w.expand(batch, -1, -1)
                        for w in wins]
                lib = (partial(torch.cat, wins, launch.arg) if len(wins) > 1
                       else wins[0].contiguous)
                nbytes = sum(p.rows * p.cols * (batch if p.src.dim() == 3
                                                 else 1) * p.src.element_size()
                             for p in ops)
                flop = 0
            name = f"islands {launch.kernel.name} (op {launch.op})"
            check(got.dtype == ref.dtype == dtype and torch.equal(got, ref),
                  f"{name}: differs from its plain version")
            check(torch.equal(lib(), ref), f"library {name}: differs")
            st = stats[launch.kernel.name]
            st["calls"] += 1
            calls.append((launch.kernel.name, partial(launch, core),
                          partial(launch.plain, core), lib,
                          (flop, nbytes + got.numel() * got.element_size())))
    return calls


def _islands_engines(path, batch, ticks, dev, plain_ticks):
    """50 captured ticks of the engines at B=1024 on the islands fixture,
    float at 16 kHz and bf16 at 48 kHz (phases 6-7's `_drive`: ~10 % loss,
    launches counted, profiler window, finite speech-level output), then
    the kernel path vs the plain path (float: decoder within 2 int16 LSB on
    the same indices; bf16: phase 7's bars from identical inputs).  →
    (launches, per-tick launches, summary)."""
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, out_edge, rvq_kernel

    launches, per_tick, lines = {}, {}, []
    for mode, rate, kernels in (
            ("float", 16000, conv_stack.KERNELS_F32 + conv_stack.CORE_F32
             + (out_edge.OUT_EDGE,)),
            ("bf16", RATE_BF16,
             conv_stack.KERNELS_BF16 + conv_stack.CORE_BF16
             + (out_edge.OUT_EDGE_BF16,))):
        enc = EncoderEngine(rate, path, mode=mode, device=dev)
        dec = DecoderEngine(rate, path, mode=mode, device=dev)
        counts, ticks_, summary, tick = _drive(
            enc, dec, kernels + rvq_kernel.KERNELS, batch, ticks, dev, None)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
            per_tick[name] = per_tick.get(name, 0) + ticks_[name]
        if mode == "float":
            b_ref, same_idx, lsb = _vs_plain_f32(enc, dec, path, batch, dev,
                                                 "islands")
            vs = (f"vs plain path (B={b_ref}, 10 ticks): rows with identical "
                  f"indices {same_idx:.4f}, decoder max diff {lsb} LSB")
        else:
            vs = _vs_plain_bf16(enc, dec, path, batch, dev, "islands")
        plain = plain_ticks[mode]
        lines.append(
            f"{mode} {rate // 1000} kHz: {summary}; {vs}; per captured tick "
            f"{tick['device_us']:.1f} device µs in {tick['kernels']:g} CUDA "
            f"kernels vs the plain fixture's {plain['device_us']:.1f} µs in "
            f"{plain['kernels']:g} (phase {6 if mode == 'float' else 7})")
    return launches, per_tick, "; ".join(lines)


def phase_islands(batch, dev, stats, gpu, plain_ticks):
    """Phase 12: the islands fixture (int8 islands and the rest of K1's op
    set, tests/golden/synthetic_lyra_islands/full) through the fused
    stacks, the core kernels and the engines.  → (launches, per-tick
    launches) of its engine runs."""
    import torch

    from lyra_tpu_torch.ops import conv_stack

    t_phase = time.time()
    summary, stacks = _islands_models(ISLANDS_FIXTURE, dev)
    print(f"islands models: ok, {summary}")
    for dtype, kernels, phase in (
            (torch.float32, conv_stack.CORE_F32, "islands"),
            (torch.bfloat16, conv_stack.CORE_BF16, "islands-bf16")):
        calls = _core_calls(stacks[dtype], batch, dev, stats)
        print(f"{phase} core kernels: ok, every call of one hop at "
              f"B={batch} bitwise equal to its plain version and to its "
              f"library call: " + ", ".join(
                  f"{k.name} {stats[k.name]['calls']} calls" for k in kernels))
        _time_rounds(phase, calls, kernels, batch, stats, gpu,
                     PEAK_FP32_FLOPS, "FP32")
    launches, per_tick, summary = _islands_engines(
        ISLANDS_FIXTURE, batch, TICKS, dev, plain_ticks)
    print(f"islands engines: ok, {summary}")
    print(f"islands: phase 12 took {time.time() - t_phase:.1f} s")
    return launches, per_tick


# ---- phase 13: the fleet tier and the examples ------------------------------

FLEET_CALLERS = 16  # FleetCallers seated in (b)
FLEET_DELAY = 4  # (b)'s hosts' playout delay
FLEET_DEPTH = FLEET_DELAY + 6  # their jitter buffers' depth
FLEET_TICKS = 50  # (b)'s uplink ticks to host A before the migration
FLEET_CHECK = FLEET_DEPTH + FLEET_DELAY + 2  # (b)'s replayed ticks on B
MULTIHOST_SECONDS = 3.0  # (c)'s --seconds_each
# (b)'s hosts: serve_main.main, then the process's own launch counts and
# peak device memory (torch.cuda.max_memory_allocated) at exit.
_HOST = """\
import json, sys, torch
from lyra_tpu_torch.ops import conv_stack, rvq_kernel
from lyra_tpu_torch.tools import serve_main
rc = serve_main.main(sys.argv[1:])
print("LAUNCHES " + json.dumps({
    "launches": {k.name: k.launches
                 for k in conv_stack.KERNELS + rvq_kernel.KERNELS},
    "peak": torch.cuda.max_memory_allocated()
    if torch.cuda.is_available() else 0}))
sys.exit(rc)
"""


def _run_example(name, argv, kernels):
    """lyra_tpu_torch.examples.<name>.main(argv) in this process at its
    default device (the card), launch counts set to 0 before and read
    after; its exit code must be 0.  → its standard output."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"lyra_tpu_torch.examples.{name}")
    _zero_launches()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    out = buf.getvalue()
    check(rc == 0, f"fleet: {name} {' '.join(argv)} exited {rc}:\n{out}")
    counts = _launched(f"fleet: {name}", kernels or ())
    flags = " ".join(a for a in argv if not a.startswith("/"))
    print(f"fleet example {name} {flags}: ok in {time.time() - t0:.1f} s"
          + (f", launches {({k.name: counts[k.name] for k in kernels})}"
             if kernels else ""))
    return out


def _lines(out, *keys):
    return [ln.strip() for ln in out.splitlines()
            if any(k in ln for k in keys)]


class _MemSampler:
    """Device memory in use on the whole card (every process's), sampled
    every 20 ms in a thread: `peak` over the run, `now()` on demand."""

    def __init__(self):
        import threading

        import torch

        self._torch = torch
        self.peak = self.now()
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def now(self):
        free, total = self._torch.cuda.mem_get_info()
        return total - free

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.now())

    def close(self):
        self._stop.set()
        self._th.join(5)


def _spawn(argv, log):
    return subprocess.Popen([sys.executable, "-c", _HOST, *argv],
                            stdout=log, stderr=subprocess.STDOUT, cwd=REPO)


def _host_exit(path):
    with open(path) as f:
        lines = [ln for ln in f if ln.startswith("LAUNCHES ")]
    check(lines, f"fleet: {path} holds no exit record")
    return json.loads(lines[-1][len("LAUNCHES "):])


def _fleet_burst(heads, next_seq, rng, least=4):
    """The cutover's datagrams, as tests/test_torch_fleet.py sends them:
    per seated slot the sequences from the caller's next one (or the
    playout head) to the last the standby's jitter buffer holds, at least
    `least` of them; random 15-byte packets."""
    out = []
    for slot in range(FLEET_CALLERS):
        last = int(heads[slot]) + FLEET_DEPTH - 1
        first = max(int(heads[slot]),
                    min(int(next_seq[slot]), last + 1 - least))
        out += [(slot, seq, rng.integers(0, 256, 15, dtype=np.uint8)
                 .tobytes()) for seq in range(first, last + 1)]
    return out


def _fleet_replay(path, dev, snap, burst):
    """The offline replay of (b)'s cutover on eager engines on the card:
    one DecoderServer restores A's drain snapshot, a JitterBuffer takes
    its playout schedule and the burst (phase 10's method) → FLEET_CHECK
    ticks of int16 PCM [SERVE_CAP, 320]."""
    from lyra_tpu_torch import config
    from lyra_tpu_torch.codec.engine import DecoderEngine
    from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer
    from lyra_tpu_torch.tools.stream_server import DecoderServer

    dec = DecoderServer(SERVE_CAP, engine=_eager(DecoderEngine(
        16000, path, emit_dtype="int16", max_bitrate=9200, device=dev)))
    heads = dec.restore(snap)["jb_heads"]
    jb = JitterBuffer(SERVE_CAP, config.packet_size(184), depth=FLEET_DEPTH)
    for slot, head in enumerate(heads):
        check(head >= 0, f"fleet: slot {slot} inactive in the drain snapshot")
        jb.add_stream(slot, start_seq=int(head), playout_delay=FLEET_DELAY)
    for slot, seq, payload in burst:
        check(jb.insert(slot, seq, payload) == 0,
              f"fleet: the burst's ({slot}, {seq}) does not fit the buffer")
    out = []
    for _ in range(FLEET_CHECK):
        pkts, received, sizes = jb.collect()
        out.append(dec.tick_wire(pkts, received, sizes.astype(np.int32)))
    return out


def _fleet_hosts(path, dev, tmp, gpu):
    """(b): two serve_main decode hosts at SERVE_CAP (A active, B a warm
    standby; keyed control, periodic snapshots, --echo reply) under the
    port's fleet_main; FLEET_CALLERS FleetCallers admitted, streaming to
    A; the controller's migrate A → B; every caller relocates and B's PCM
    to it from B's first tick after the restore must be bitwise the
    offline replay of A's drain snapshot."""
    from lyra_tpu_torch.client import FleetCaller
    from lyra_tpu_torch.examples._common import free_udp_port
    from lyra_tpu_torch.ops import conv_stack
    from lyra_tpu_torch.tools.control_auth import load_key
    from lyra_tpu_torch.tools.fleet import HostControl
    from lyra_tpu_torch.utils import checkpoint

    key_file = os.path.join(tmp, "fleet.key")
    with open(key_file, "wb") as f:
        f.write(os.urandom(32))
    key = load_key(key_file)
    snap_dir = os.path.join(tmp, "fleet")
    os.makedirs(snap_dir)
    ports = {n: (free_udp_port(), free_udp_port()) for n in "AB"}
    procs, logs, ctls, mem = {}, {}, {}, {}
    mem_s = _MemSampler()
    base = mem_s.now()
    fleet = adm = None
    callers = []
    t_phase = time.time()
    try:
        for name, every in (("A", "2"), ("B", "3600")):
            data, ctl = ports[name]
            logs[name] = os.path.join(tmp, f"host_{name}.log")
            procs[name] = _spawn(
                ["--capacity", str(SERVE_CAP), "--seconds", "0",
                 "--model_path", path, "--playout_delay", str(FLEET_DELAY),
                 "--port", str(data), "--control", str(ctl),
                 "--control_key", key_file, "--echo", "reply",
                 "--snapshot", os.path.join(snap_dir, name),
                 "--snapshot_every", every, "--report_every", "60",
                 "--stats", os.path.join(tmp, f"host_{name}.jsonl")],
                open(logs[name], "w"))
            ctls[name] = HostControl(("127.0.0.1", ctl), key=key)
            ctls[name].wait_ready(300)
            deadline = time.time() + 300
            while ctls[name].stats()["ticks"] < 3:  # its graphs captured
                check(time.time() < deadline, f"fleet: host {name} stalls")
                time.sleep(0.1)
            mem[name] = mem_s.now() - base - sum(mem.values())
        fport = free_udp_port()
        flog = os.path.join(tmp, "fleet_main.log")
        fleet = subprocess.Popen(
            [sys.executable, "-m", "lyra_tpu_torch.tools.fleet_main",
             "--host", f"A=127.0.0.1:{ports['A'][0]}:{ports['A'][1]}:"
             f"{SERVE_CAP}",
             "--standby", f"B=127.0.0.1:{ports['B'][0]}:{ports['B'][1]}:"
             f"{SERVE_CAP}",
             "--snapshot_dir", snap_dir, "--key", key_file,
             "--port", str(fport), "--watch_every", "0", "--wait_ready",
             "--report_every", "60", "--seconds", "0"],
            stdout=open(flog, "w"), stderr=subprocess.STDOUT, cwd=REPO)
        adm = HostControl(("127.0.0.1", fport), key=key)
        deadline = time.time() + 120
        while True:
            try:
                adm.request("stats", _timeout=0.5, _retries=1)
                break
            except (OSError, RuntimeError):
                check(time.time() < deadline and fleet.poll() is None,
                      f"fleet: fleet_main never came up: {_read(flog)}")
        callers = [FleetCaller(("127.0.0.1", fport), f"caller{i}")
                   for i in range(FLEET_CALLERS)]
        check([c.host for c in callers] == ["A"] * FLEET_CALLERS
              and sorted(c.slot for c in callers)
              == list(range(FLEET_CALLERS)),
              f"fleet: seats {[(c.host, c.slot) for c in callers]}")
        rng = np.random.default_rng(13)
        got = {c.slot: {} for c in callers}

        def recv():
            for c in callers:
                for seq, payload in c.recv(256):
                    got[c.slot][seq] = payload

        def stream(ticks):
            t_next = time.perf_counter()
            for _ in range(ticks):
                for c in callers:
                    c.send_packet(rng.integers(0, 256, 15, dtype=np.uint8)
                                  .tobytes())
                t_next += 0.02
                time.sleep(max(0.0, t_next - time.perf_counter()))
                recv()

        stream(FLEET_TICKS)
        deadline = time.time() + 60
        while not all(got.values()):  # a slow host's first ticks
            check(time.time() < deadline,
                  "fleet: a caller got no PCM from host A")
            stream(5)
        lo = ctls["B"].stats()["ticks"]
        t0 = time.time()
        moved = adm.request("migrate", src="A", dst="B")["moved"]
        t_reply = time.time()
        drain = os.path.join(snap_dir, "A.drain")
        t_migrate = t_reply - t0
        t_restore = t_reply - os.path.getmtime(drain + ".npz")
        check(moved == FLEET_CALLERS, f"fleet: migrate moved {moved}")
        heads = checkpoint.peek_extra(drain)["transport"]["jb_heads"]
        # The callers re-resolve at once (the controller answers one poll
        # of its socket every 10 ms), so B learns their reply routes
        # before its first tick that plays a packet.
        with ThreadPoolExecutor(FLEET_CALLERS) as pool:
            moved_to = list(pool.map(lambda c: c.relocate() and c.host,
                                     callers))
        check(moved_to == ["B"] * FLEET_CALLERS,
              f"fleet: callers did not move to B: {moved_to}")
        next_seq = {c.slot: c.seq for c in callers}
        burst = _fleet_burst(heads, [next_seq[s] for s in
                                     range(FLEET_CALLERS)], rng)
        by_slot = {c.slot: c for c in callers}
        got = {c.slot: {} for c in callers}
        for slot, seq, payload in burst:
            by_slot[slot].seq = seq
            by_slot[slot].send_packet(payload)
        t_burst = time.perf_counter()
        deadline = time.time() + 60
        while min(len(g) for g in got.values()) < FLEET_CHECK + 2:
            check(time.time() < deadline, "fleet: no PCM from host B")
            recv()
            time.sleep(0.01)
        window = got
        st_b = ctls["B"].stats()
        check(st_b["jb"]["late_drops"] == st_b["jb"]["overflow_drops"] == 0,
              f"fleet: host B dropped burst datagrams {st_b['jb']}")
        # The call goes on at B: each caller's sequence has advanced with
        # its clock (one per 20 ms) meanwhile; B locks onto it and plays
        # every caller's packets (occupied = the seats).
        for c in callers:
            c.seq += round((time.perf_counter() - t_burst) / 0.02)
        got = {c.slot: {} for c in callers}
        stream(50)
        st_on = ctls["B"].stats()
        check(st_on["occupied"] == FLEET_CALLERS
              and all(len(g) >= 25 for g in got.values()),
              f"fleet: B does not play the callers' stream after the "
              f"cutover: {st_on}, hops {[len(g) for g in got.values()]}")
        t1 = time.time()
        expected = _fleet_replay(path, dev, drain, burst)
        check(max(np.abs(e[:FLEET_CALLERS]).max() for e in expected) > 1000,
              "fleet: the replay's audio is not at speech level")
        found = []
        for t_0 in range(lo, lo + 20):
            hops = [(s, q) for s, g in window.items() for q in g
                    if t_0 <= q < t_0 + FLEET_CHECK]
            if hops and all(window[s][q] == expected[q - t_0][s].tobytes()
                            for s, q in hops):
                found.append((t_0, len(hops)))
        check(len(found) == 1,
              f"fleet: B's PCM after the restore is not the replay's "
              f"(matches {found}, B's ticks from {lo})")
        # Every hop from B's first tick that plays a packet on was compared.
        t_0 = found[0][0]
        missing = [(s, t_0 + i) for s in window
                   for i in range(FLEET_DELAY, FLEET_CHECK)
                   if t_0 + i not in window[s]]
        check(not missing, f"fleet: hops of B never reached their caller "
              f"{missing[:8]} (B's ticks from {lo}, restore at {t_0})")
        t_replay = time.time() - t1
        for c in callers:
            c.release()
        t0 = time.time()
        ctls["B"].restore(drain)
        t_restore_b = time.time() - t0
        adm.request("quit")
        fleet.wait(60)
        ctls["B"].quit()
        procs["B"].wait(120)
        procs["A"].wait(120)
        peak = mem_s.peak - base
        exits = {n: _host_exit(logs[n]) for n in "AB"}
        launches = {n: {k: v for k, v in exits[n]["launches"].items() if v}
                    for n in "AB"}
        for n in "AB":
            for k in conv_stack.KERNELS_F32:
                check(launches[n].get(k.name, 0) > 0,
                      f"fleet: host {n} never launched {k.name}")
        print(f"fleet (b) [{gpu}]: ok, {FLEET_CALLERS} FleetCallers on two "
              f"serve_main hosts at capacity {SERVE_CAP} under fleet_main "
              f"(keyed), migrate A → B moved {moved} seats in "
              f"{t_migrate * 1e3:.1f} ms (drain + restore; "
              f"{t_restore * 1e3:.1f} ms from the drain snapshot's write to "
              f"the reply: B's restore at its next tick boundary and the "
              f"relay; a restore of the same snapshot on B alone "
              f"{t_restore_b * 1e3:.1f} ms round trip); B's PCM to the "
              f"callers bitwise the offline replay over the {FLEET_CHECK} "
              f"ticks from its first after the restore (B tick "
              f"{found[0][0]}): {found[0][1]} of {FLEET_CALLERS * FLEET_CHECK}"
              f" hops reached their callers and were compared, each from "
              f"the tick B learned the caller's reply route, every one from "
              f"B's first tick that plays a packet (replay "
              f"{t_replay:.1f} s), no late or overflow drop; then 50 ticks "
              f"of the callers' stream "
              f"played on B (occupied {st_on['occupied']}, jitter buffer "
              f"{st_on['jb']}); peak device memory of host A "
              f"{exits['A']['peak'] / 2**20:.0f} MiB, of host B "
              f"{exits['B']['peak'] / 2**20:.0f} MiB (max_memory_allocated "
              f"in each process); the card's memory in use with the hosts "
              f"up: A {mem['A'] / 2**20:.0f} MiB, B {mem['B'] / 2**20:.0f} "
              f"MiB (contexts and caches included), both at their peak "
              f"{peak / 2**20:.0f} MiB; launches in host A "
              f"{launches['A']}, in host B {launches['B']}; "
              f"{time.time() - t_phase:.1f} s")
    finally:
        for c in callers:
            c.close()
        if adm is not None:
            adm.close()
        for ctl in ctls.values():
            ctl.close()
        for proc in [*procs.values()] + ([fleet] if fleet else []):
            if proc.poll() is None:
                proc.terminate()
                proc.wait(30)
        mem_s.close()


def phase_fleet(path, dev, gpu):
    """Phase 13: the fleet tier (tools/fleet.py, fleet_main.py, client.py)
    and the examples (lyra_tpu_torch/examples) on the card at full width;
    the hosts spawned here find the kernels phase 1 built."""
    import tempfile

    from lyra_tpu_torch.ops import conv_stack, rvq_kernel
    from lyra_tpu_torch.utils import native, wav

    check(native.load() is not None, "fleet: the native library did not load")
    full = conv_stack.KERNELS_F32 + rvq_kernel.KERNELS
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        speech = os.path.join(tmp, "speech.wav")
        wav.write_wav_int16(speech, _speech(16000, 250).reshape(-1), 16000)
        base = ["--model_path", path]
        # (a) drain and migrate in one process, bitwise (its exit code).
        for callers in ("3", "64"):
            out = _run_example("drain_migrate", [
                "--callers", callers, "--input", speech,
                "--out_dir", os.path.join(tmp, "mig"), *base], full)
            print("fleet (a): " + " | ".join(_lines(out, "mismatches")))
        # (b) the fleet tier over two host processes.
        _fleet_hosts(path, dev, tmp, gpu)
        # (c) the live drain and the watchdog failover, three processes.
        for extra in ([], ["--failover"]):
            out = _run_example("multihost_migrate", [
                "--controller", "--callers", "8", "--seconds_each",
                str(MULTIHOST_SECONDS), "--max_gap_ms", "1000",
                "--log_dir", os.path.join(tmp, "multihost"), *extra, *base],
                None)
            mode = "failover" if extra else "drain"
            print(f"fleet (c) {mode} [{gpu}]: " + " | ".join(_lines(
                out, "streams A→B", "caller", "hosts after", "MIGRATION")))
        # (d) the other examples, short runs.
        out = _run_example("loopback_call", [
            "--seconds", "1", "--callers", "3", "--input", speech,
            "--out_dir", os.path.join(tmp, "call"), *base], full)
        for extra in ([], ["--mixed"]):
            out = _run_example("udp_call", [
                "--seconds", "1", "--callers", "3", "--loss", "0.1",
                "--input", speech, "--out_dir", os.path.join(tmp, "udp"),
                *extra, *base], full)
            print("fleet (d) udp_call " + " ".join(extra) + ": "
                  + " | ".join(_lines(out, "latency")))
        out = _run_example("conference_call", [
            "--seconds", "1", "--callers", "4", "--room_size", "2",
            "--input", speech, "--out_dir", os.path.join(tmp, "conf"),
            *base], full)
        print("fleet (d) conference_call: " + " | ".join(_lines(
            out, "downlink hops", "latency")))
        out = _run_example("rate_adapt_call", [
            "--callers", "4", "--seconds", "4", "--window_s", "0.4", *base],
            conv_stack.KERNELS_F32[:2] + rvq_kernel.KERNELS)  # SoundStream
        rates = [ln for ln in _lines(out, "window:")]
        check("ADAPT OK" in out and "9200" in rates[0]
              and all(f"s{s}:3200" in rates[-1] for s in range(4)),
              f"fleet: rate_adapt_call did not walk 9200 → 3200:\n{out}")
        print("fleet (d) rate_adapt_call: " + " | ".join(
            [rates[0], rates[-1]] + _lines(out, "ADAPT", "converged")))
    print(f"fleet: phase 13 took {time.time() - t_phase:.1f} s")


# ---- phase 14: multi-device serving (parallel/sharding.py) ------------------

SHARDS = 2  # phase 14: shards of each mesh
BRIDGE_TICKS = 100  # phase 14 (c): bridge ticks
BRIDGE_ROOM = 4  # phase 14 (c): participants per room
SHARD_TIMED = 100  # phase 14 (d): timed server ticks per turn


def _leaf(state, key):
    """One [B] leaf of a decoder state tree, sharded or not, on the host."""
    import torch

    from lyra_tpu_torch.parallel.sharding import Sharded

    if isinstance(state, Sharded):
        return torch.cat([p[key].cpu() for p in state.parts])
    return state[key].cpu()


def _cn_enters(pre, post):
    """[B] bool: the rows whose hop from decoder state `pre` to `post` has
    comfort noise in it (the engine's run_cng: a fade toward it has begun,
    or one away from it has not ended)."""
    from lyra_tpu_torch.codec.engine import FADE_TO_CNG

    return (_leaf(post, "fade_dir") == FADE_TO_CNG) | (_leaf(pre, "fade") != 0)


def _vs_one_engine(where, got, ref, cn):
    """Audio of the sharded path `got` vs one engine's `ref` ([B, hop] on
    the host): bitwise in every row whose hop has no comfort noise in it,
    within 1 int16 LSB where it has (`cn`): the decoder-side noise
    estimator's and the comfort-noise generator's DFT matmuls are cuBLAS
    GEMMs, whose bits depend on how many rows a call holds.  → (samples
    that differ, the largest difference)."""
    diff = (got.float() - ref.float()).abs()
    quiet = diff[~cn]
    check(not bool((quiet > 0).any()), f"{where}: {int((quiet > 0).sum())} "
          f"samples differ in hops without comfort noise")
    worst = float(diff.max())
    check(worst <= 1.0, f"{where}: comfort-noise hops {worst} int16 LSB "
          f"apart")
    return int((diff > 0).sum()), worst


def _sharded_ticks(enc, dec, audio, received, dec_in=None):
    """TICKS captured ticks of `enc`/`dec` (sharded or not) at 120 bits;
    the decoders take `dec_in` (the unsharded run's wire indices) where
    given, else the device wire round trip of this run's own indices.
    Launch counts are zeroed before and read after.  → (indices, decoder
    input, audio, comfort-noise flags, rows with comfort noise in the hop)
    per tick on the host, launches."""
    import torch

    from lyra_tpu_torch import packet
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    batch, bits = audio.shape[1], 120
    nq = bits // 4

    def host(x):  # a copy on the host, taken before the next replay
        return x.cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))

    es, ds = enc.init_state(batch), dec.init_state(batch)
    got = []
    _zero_launches()
    for t in range(audio.shape[0]):
        idx, _, es = enc.step(es, audio[t], nq)
        idx = host(idx)
        if dec_in is None:
            d = idx.to(audio.device)
            wire = packet.pack_wire_device(d, bits)
            dev_idx = torch.full_like(d, -1)
            dev_idx[:, :nq] = packet.unpack_wire_device(wire, bits)
        else:
            dev_idx = dec_in[t]
        pre = ds  # valid through one more step (the capture's ping-pong)
        out, cn, ds = dec.step(ds, dev_idx, received[t])
        got.append((idx, dev_idx, host(out), host(cn), _cn_enters(pre, ds)))
    launches = {k.name: k.launches
                for k in conv_stack.KERNELS + rvq_kernel.KERNELS}
    return got, launches


def _row_dependence(enc, dec):
    """Which ops of the tick give a row other bits at B=BATCH than in a
    call over half the rows (each half run apart), on random inputs:
    {op: bitwise?}.  Printed, not gated: it names where a sharded tick
    may leave one engine's bits."""
    import torch

    from lyra_tpu_torch.dsp import utils as dsp_utils

    dev, b = dec.device, BATCH
    g = torch.Generator().manual_seed(14)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def rows(tree, lo, hi):
        if isinstance(tree, dict):
            return {k: rows(v, lo, hi) for k, v in tree.items()}
        return tree[lo:hi].contiguous()

    def flat(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in flat(v)]
        if isinstance(tree, (tuple, list)):
            return [x for v in tree for x in flat(v)]
        return [tree]

    es, ds = enc.init_state(b), dec.init_state(b)
    hop = rnd(b, 320, scale=3000.0)
    ops = {
        "SoundStream": (lambda s, x: enc.soundstream.extract(s, x),
                        es["soundstream"], dsp_utils.int16_to_unit(hop)),
        "RVQ search": (lambda f: enc.rvq.quantize(f, 30, method="kernel"),
                       rnd(b, 64, scale=0.5)),
        "LyraGAN": (lambda s, f: dec.gan.decode_hop(s, f), ds["gan"],
                    rnd(b, 64, scale=0.5)),
        "RVQ decode": (lambda i: dec.rvq.decode(i, dtype=dec._decode_dtype),
                       torch.randint(0, 16, (b, 46), generator=g).to(dev)),
        "noise estimator": (lambda s, h: dec.noise.receive_hop(s, h),
                            ds["noise"], hop),
        "comfort noise": (lambda s, f: dec.cng.generate_hop(s, f), ds["cng"],
                          rnd(*ds["noise"]["noise_estimate"].shape,
                              scale=0.3)),
    }
    out = {}
    for name, (fn, *args) in ops.items():
        whole = flat(fn(*args))
        halves = [flat(fn(*[rows(a, lo, lo + b // 2) for a in args]))
                  for lo in (0, b // 2)]
        out[name] = all(torch.equal(w, torch.cat([x, y]))
                        for w, x, y in zip(whole, *halves))
    return out


def _sharded_engines(path, mesh, rate, mode, gpu):
    """Phase 14 (b): the encoder and decoder ShardedEngines over `mesh`
    against one engine at the whole batch, captured, TICKS ticks of the
    bring-up loss pattern; the decoders fed identical indices.  → the
    engine pairs (unsharded, sharded) for (c)-(d)."""
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.parallel.sharding import ShardedEngine

    dev = mesh.devices[0]
    audio, received = _inputs(BATCH, TICKS, dev, rate // 50)

    def engines():
        return (EncoderEngine(rate, path, mode=mode, device=dev),
                DecoderEngine(rate, path, mode=mode, device=dev))

    one = engines()
    sharded = tuple(ShardedEngine(e, mesh) for e in engines())
    ref, n_one = _sharded_ticks(*one, audio, received)
    got, n_sh = _sharded_ticks(*sharded, audio, received,
                               [r[1] for r in ref])
    kernels = _path_kernels(*one)
    for k in kernels:
        check(n_one[k.name] > 0 and n_sh[k.name] == SHARDS * n_one[k.name],
              f"sharded {mode}: {k.name} launched {n_sh[k.name]} times over "
              f"{SHARDS} shards, {n_one[k.name]} on one engine: not every "
              f"shard captured it")
    others = {n: c for n, c in n_sh.items()
              if c and n not in {k.name for k in kernels}}
    check(not others, f"sharded {mode}: kernels of another mode {others}")
    differ = worst = cn_hops = 0
    for t, ((i_r, _, o_r, c_r, m_r), (i_s, _, o_s, c_s, m_s)) in enumerate(
            zip(ref, got)):
        check(torch.equal(i_s, i_r), f"sharded {mode}: indices differ at "
              f"tick {t} in {int((i_s != i_r).any(dim=1).sum())} rows")
        check(torch.equal(c_s, c_r) and torch.equal(m_s, m_r),
              f"sharded {mode}: comfort-noise flags differ at tick {t}")
        n, w = _vs_one_engine(f"sharded {mode} tick {t}", o_s, o_r, m_r)
        differ, worst, cn_hops = differ + n, max(worst, w), cn_hops + int(
            m_r.sum())
    out = torch.stack([g[2] for g in got])
    check(out.shape == (TICKS, BATCH, rate // 50)
          and bool(torch.isfinite(out).all()), f"sharded {mode}: output "
          f"{tuple(out.shape)}")
    ops = _row_dependence(*one)
    print(f"sharding (b) {mode} {rate // 1000} kHz {mesh} [{gpu}]: ok, "
          f"{SHARDS} x {BATCH // SHARDS} vs one engine at B={BATCH}, "
          f"{TICKS} captured ticks, {1 - received.float().mean().item():.1%}"
          f" of hops lost, {int(sum(g[3].sum() for g in got))} comfort-noise "
          f"stream-hops, {cn_hops} stream-hops with comfort noise in them: "
          f"encoder indices and comfort-noise flags bitwise, decoder audio "
          f"bitwise outside comfort noise, {differ} samples of "
          f"{TICKS * BATCH * (rate // 50)} differ (max {worst:g} int16 LSB, "
          f"bar 1); each op at B={BATCH} vs over its two halves (random "
          f"inputs): {', '.join(f'{k} ' + ('bitwise' if v else 'DIFFERS') for k, v in ops.items())}; "
          f"launches over the runs (warm-up and two captures per "
          f"step and cache) sharded "
          f"{dict((k.name, n_sh[k.name]) for k in kernels)}, one engine "
          f"{dict((k.name, n_one[k.name]) for k in kernels)}")
    return one, sharded


def _bridge_inputs(ticks, batch, seed=14):
    """Uplink wire packets of three bitrates, one per stream, with ~10 %
    loss and 8-tick bursts on every 16th stream."""
    from lyra_tpu_torch import config, packet

    rng = np.random.default_rng(seed)
    bits = np.array([64, 120, 184])[np.arange(batch) % 3]
    width = config.packet_size(184)
    pkts = np.zeros((ticks, batch, width), np.uint8)
    for t in range(ticks):
        for b in (64, 120, 184):
            rows = np.flatnonzero(bits == b)
            idx = rng.integers(0, 16, (rows.size, b // 4)).astype(np.int32)
            pkts[t, rows, :b // 8] = packet.pack_indices_batch(idx, b)
    received = rng.random((ticks, batch)) >= 0.09
    received[ticks // 2:ticks // 2 + 8, ::16] = False
    sizes = np.broadcast_to(bits // 8, (ticks, batch)).astype(np.int32)
    return pkts, received, sizes


def _sharded_serving(one, sharded, mesh, gpu):
    """Phase 14 (c): phase 9's server schedule (admissions, evictions, a
    save and restore) and a conference bridge with shard-affine rooms over
    the sharded float engines, against the same over one engine: wire
    bytes bitwise, audio by `_vs_one_engine`'s bar; the bridge's downlink
    bitwise in every room none of whose uplinks has had comfort noise in
    it yet (a room's mix, and so its re-encoded downlink, carries the
    comfort noise's last bits on)."""
    import torch

    from lyra_tpu_torch.tools.conference import ConferenceBridge

    dev = mesh.devices[0]
    audio, received = _inputs(BATCH, TICKS, dev)
    pcm = audio.clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    received = received.cpu().numpy()
    cn_r, cn_s = [], []
    ref, re_r = _serve_run(*one, pcm, received, cn_in=cn_r)
    got, re_s = _serve_run(*sharded, pcm, received, cn_in=cn_s)
    check(re_r == re_s, "sharded serve: slot tables differ")
    differ = 0
    for t, (g_t, r_t) in enumerate(zip(got, ref)):
        for name, g, r in zip(("wire", "sizes", "comfort noise"),
                              (g_t[0], g_t[1], g_t[3]),
                              (r_t[0], r_t[1], r_t[3])):
            check(np.array_equal(g, r), f"sharded serve: {name} differs at "
                  f"tick {t}")
        check(torch.equal(cn_s[t], cn_r[t]), f"sharded serve: comfort-noise "
              f"rows differ at tick {t}")
        differ += _vs_one_engine(f"sharded serve tick {t}",
                                 torch.from_numpy(g_t[2]),
                                 torch.from_numpy(r_t[2]), cn_r[t])[0]
    pkts, rec, sizes = _bridge_inputs(BRIDGE_TICKS, BATCH)
    rooms = {i: i // BRIDGE_ROOM for i in range(BATCH)}
    bridges = [ConferenceBridge(BATCH, dec_engine=d, enc_engine=e)
               for e, d in (sharded, one)]
    slots = bridges[0].shard_affine_slots(rooms)
    per = BATCH // SHARDS
    check(all(len({slots[s] // per for s in rooms if rooms[s] == r}) == 1
              for r in set(rooms.values())), "shard_affine_slots split a room")
    for b in bridges:
        b.add_participants(rooms, slots=slots)
    room_of = np.zeros(BATCH, np.int64)
    for sid, slot in slots.items():
        room_of[slot] = rooms[sid]
    tainted = np.zeros(BATCH // BRIDGE_ROOM, bool)
    rows_differ = 0
    for t in range(BRIDGE_TICKS):
        pre = bridges[1]._dec._state
        (w_s, s_s), (w_r, s_r) = (b.tick_wire(pkts[t], rec[t], sizes[t])
                                  for b in bridges)
        tainted[room_of[_cn_enters(pre, bridges[1]._dec._state).numpy()]] = (
            True)
        same = (w_s == w_r).all(axis=1) & (s_s == s_r)
        clean = ~tainted[room_of]
        check(bool(same[clean].all()), f"sharded bridge: downlink differs at "
              f"tick {t} in {int((~same & clean).sum())} rows of rooms "
              f"without comfort noise")
        rows_differ += int((~same).sum())
    print(f"sharding (c) {mesh} [{gpu}]: ok, servers over the sharded float "
          f"engines at capacity {BATCH}, {TICKS} ticks of phase 9's schedule "
          f"(evictions, admissions, save + restore): wire, sizes and "
          f"comfort-noise flags bitwise the unsharded servers', audio "
          f"bitwise outside comfort noise ({differ} samples differ, each "
          f"by 1 LSB at most); bridge at capacity {BATCH}, rooms of {BRIDGE_ROOM} placed "
          f"by shard_affine_slots, {BRIDGE_TICKS} tick_wire ticks of 8/15/23-"
          f"byte uplinks with ~10 % loss: downlink bitwise the unsharded "
          f"bridge's in every room without comfort noise so far; "
          f"{int(tainted.sum())} of {len(tainted)} rooms had some, "
          f"{rows_differ} downlink rows of theirs differed over the run")


def _sharded_timing(one, sharded, mesh, mode, gpu):
    """Phase 14 (d), printed, not gated: captured server ticks over one
    engine vs the sharded engines in turns, device time and CUDA kernels
    per replayed tick, memory."""
    import torch

    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    rate = one[0].sample_rate_hz
    audio, received = _inputs(BATCH, TICKS, mesh.devices[0], rate // 50)
    pcm = audio.clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    received = received.cpu().numpy()
    cards = sorted(set(mesh.devices), key=str)
    pairs, held = {}, {}
    for kind, (e, d) in (("one engine", one), ("sharded", sharded)):
        gc.collect()
        torch.cuda.synchronize()
        base = {c: torch.cuda.memory_allocated(c) for c in cards}
        pairs[kind] = (EncoderServer(BATCH, engine=e, bitrate=6000),
                       DecoderServer(BATCH, engine=d))
        for srv in pairs[kind]:
            srv.add_streams(range(BATCH))
        _serve_ticks(pairs[kind], pcm, received, 3)
        torch.cuda.synchronize()
        held[kind] = {c: torch.cuda.memory_allocated(c) - base[c]
                      for c in cards}
    times = {kind: [] for kind in pairs}
    peak = {kind: dict.fromkeys(cards, 0) for kind in pairs}
    for kind in ("one engine", "sharded", "sharded", "one engine"):
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        _serve_ticks(pairs[kind], pcm, received, SHARD_TIMED, times[kind])
        for c in cards:
            peak[kind][c] = max(peak[kind][c],
                                torch.cuda.max_memory_allocated(c))
    device, kernels = {}, {}
    for kind, servers in pairs.items():
        events = _device_events(_profile_ticks(
            lambda i, servers=servers: _serve_ticks(servers, pcm, received, 1,
                                                    start=i)))
        device[kind] = sum(us for us, _ in events.values()) / 3 / 1e3
        kernels[kind] = sum(c for n, (_, c) in events.items()
                            if not n.startswith(("Memcpy", "Memset"))) / 3
    print(f"sharding (d) {mode} {rate // 1000} kHz {mesh} [{gpu}]: "
          f"EncoderServer.tick_wire → DecoderServer.tick_wire at capacity "
          f"{BATCH}, captured, {SHARD_TIMED} ticks per turn, turns one "
          f"engine, sharded, sharded, one engine; " + "; ".join(
              f"{kind} p50 {np.percentile(times[kind], 50):.3f} ms p99 "
              f"{np.percentile(times[kind], 99):.3f} ms, device "
              f"{device[kind]:.3f} ms per tick (profiler, 3 ticks), "
              f"{kernels[kind]:g} CUDA kernels per replayed tick, memory "
              f"held by the server pair "
              + ", ".join(f"{c} {held[kind][c] / 2**20:.1f} MiB"
                          for c in cards)
              + ", peak allocated over its turns "
              + ", ".join(f"{c} {peak[kind][c] / 2**20:.1f} MiB"
                          for c in cards)
              for kind in pairs))


def phase_sharding(path, gpu):
    """Phase 14: multi-device serving (parallel/sharding.py) on a mesh of
    SHARDS shards of cuda:0, and again over cuda:0 … cuda:SHARDS-1 where
    that many cards are attached."""
    import torch

    from lyra_tpu_torch.parallel.dryrun import dryrun_multichip
    from lyra_tpu_torch.parallel.sharding import make_mesh

    t_phase = time.time()
    meshes = [make_mesh(["cuda:0"] * SHARDS)]
    if torch.cuda.device_count() >= SHARDS:
        meshes.append(make_mesh([f"cuda:{i}" for i in range(SHARDS)]))
    for mesh in meshes:
        dryrun_multichip(SHARDS, devices=mesh.devices, model_path=path)
        print(f"sharding (a) {mesh}: ok, dryrun_multichip({SHARDS}): one "
              f"sharded encode → wire → decode tick and one bridge tick, 2 "
              f"streams per shard, every state leaf on its shard's device")
        for rate, mode in ((16000, "float"), (RATE_BF16, "bf16")):
            one, sharded = _sharded_engines(path, mesh, rate, mode, gpu)
            if mode == "float":
                _sharded_serving(one, sharded, mesh, gpu)
            _sharded_timing(one, sharded, mesh, mode, gpu)
            del one, sharded
            gc.collect()
    print(f"sharding: phase 14 took {time.time() - t_phase:.1f} s "
          f"({len(meshes)} mesh{'es' if len(meshes) > 1 else ''})")


# ---- phase 15: the quantized modes (int8, fakequant, int8 state, fp8) -------

QUANT_BATCH, QUANT_HOPS = 64, 20  # (a)-(d): the card-vs-CPU runs
QUANT_TIMED = 20  # (e): timed ticks per turn
QUANT_TICKS = 20  # (e): captured ticks of each configuration's main path
QUANT_ENV_EVERY = 4  # (b): int8 tensors compared on every 4th hop
# (b): per-hop log-spectral distance between the card's and the CPU's audio,
# mean and max over hops and streams, dB, set from the H100's readings
# (mean 0.0002 int8 / 0.0004 fakequant, max 0.0517 / 0.0657): the mean bar
# about 10 × the larger reading, the max bar 3 ×.  The control — the CPU's
# fakequant audio against its int8 audio, the same inputs — must fail both
# (measured on the CPU at B=16: mean 0.21, max 0.65 dB).
QUANT_LSD_MEAN, QUANT_LSD_MAX = 0.004, 0.2
# (b): the share of int8 elements that may differ from the CPU's (read:
# 4.8e-5; an f32 conv's last bit moves a QUANTIZE input across its edge).
QUANT_INT8_DIFF = 1e-3
# (e)'s configurations at B=1024, islands fixture: name → engine keywords.
# The first five are this phase's main path (their graphs run on the plain
# lowering, their RVQ search on rvq_encode); the last two are the float
# paths printed beside them.
QUANT_CONFIGS = (
    ("int8", {"mode": "int8", "backend": "plain"}),
    ("fakequant", {"mode": "fakequant", "backend": "plain"}),
    ("float int8-state", {"state_compression": "int8", "backend": "plain"}),
    ("float f8", {"boundary_store": "f8", "backend": "plain"}),
    ("bf16 f8", {"mode": "bf16", "boundary_store": "f8", "backend": "plain"}),
    ("float plain", {"backend": "plain"}),
    ("float kernel", {"backend": "kernel"}),
)
# fp8 e4m3 casts (d): inputs and the JAX package's bits (XLA's convert:
# round to nearest even, NaN past 464 with the sign of x), recorded from
# jax 0.9 by tests/test_torch_quant_f8.py's method; 465 is 464 in bf16.
FP8_INPUTS = np.array(
    [448, -448, 460, 464, -464, 465, 480, 500, 1000, -600, np.inf, -np.inf,
     np.nan, -np.nan, 2.0 ** -6, 2.0 ** -7, 2.0 ** -9, -2.0 ** -9,
     2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -11, 0.0, -0.0, 1.0625], np.float32)
FP8_BITS = {
    "float32": [0x7E, 0xFE, 0x7E, 0x7E, 0xFE, 0x7F, 0x7F, 0x7F, 0x7F, 0xFF,
                0x7F, 0xFF, 0x7F, 0xFF, 0x08, 0x04, 0x01, 0x81, 0x00, 0x01,
                0x00, 0x00, 0x80, 0x38],
    "bfloat16": [0x7E, 0xFE, 0x7E, 0x7E, 0xFE, 0x7E, 0x7F, 0x7F, 0x7F, 0xFF,
                 0x7F, 0xFF, 0x7F, 0xFF, 0x08, 0x04, 0x01, 0x81, 0x00, 0x01,
                 0x00, 0x00, 0x80, 0x38],
}


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (round to nearest even; a NaN keeps
    its sign), as numpy int16."""
    u = a.view(np.uint32).astype(np.uint64)
    rne = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    nan = (u >> 16) | 0x40
    return np.where(np.isnan(a), nan, rne).astype(np.uint16).view(np.int16)


def _to_card(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_card(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _quant_ops(path, dev):
    """(a) Every int8 op of both graphs (the int8 mode's ops: int8 convs,
    LEAKY_RELU, ADD, QUANTIZE, DEQUANTIZE of a tensor), fed the tensors of
    the third hop of a CPU run at B=64: on the card bit for bit the CPU's
    output.  → summary."""
    import torch

    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(15)
    kinds, elems = {}, 0
    for name, shape, scale in MODELS:
        p = os.path.join(path, f"{name}.tflite")
        host = load_graph(p, mode="int8", device="cpu")
        card = load_graph(p, mode="int8", device=dev)
        run = host.lower(capture_env=True)
        st = host.init_state(QUANT_BATCH)
        for _ in range(3):
            x = torch.tensor(rng.normal(0.0, scale, (QUANT_BATCH,) + shape),
                             dtype=torch.float32)
            _, st, env = run(st, input_audio=x)
        for oi, entry in host._int8.items():
            if entry is None:
                continue
            op = host.sg.ops[oi]
            fn, ins, args, kw = card._int8[oi]
            got = fn(*(env[i].to(dev) for i in ins), *args, **kw)
            want = env[op.outputs[0]]
            check(got.dtype == want.dtype and torch.equal(got.cpu(), want),
                  f"quant (a): {name} {op.name} (op {oi}) differs on the card")
            kinds[op.name] = kinds.get(op.name, 0) + 1
            elems += want.numel()
    per_kind = ", ".join(f"{k} {n}" for k, n in sorted(kinds.items()))
    return (f"{sum(kinds.values())} int8 ops ({per_kind}), {elems} output "
            f"elements at B={QUANT_BATCH}, bitwise the CPU's")


def _int8_envs(graphs, state, x, dev):
    """Differing int8 elements, and all int8 elements, of one graph hop on
    the card vs the CPU from the same state and input."""
    import torch

    host, card = graphs
    _, _, env_h = host.lower(capture_env=True)(state, input_audio=x)
    _, _, env_c = card.lower(capture_env=True)(_to_card(state, dev),
                                               input_audio=x.to(dev))
    diff = total = 0
    for i, v in env_h.items():
        if v.dtype == torch.int8:
            diff += int((env_c[i].cpu() != v).sum())
            total += v.numel()
    return diff, total


def _hop_lsd(a, b):
    """Log-spectral distance (dB) of each hop of each stream between two
    [hops, B, hop] audio runs at int16 scale, each through its own
    streaming log-mel extractor (the JAX oracle test's metric)."""
    from lyra_tpu_torch import config
    from lyra_tpu_torch.dsp import melspec
    from lyra_tpu_torch.dsp import utils as dsp_utils

    cfg = melspec.MelConfig.for_rate(16000, config.NUM_FEATURES)
    ea, eb = (melspec.LogMelExtractor(cfg, device="cpu") for _ in "ab")
    sa, sb = ea.init_state(a.shape[1]), eb.init_state(b.shape[1])
    out = []
    for x, y in zip(a, b):
        ma, sa = ea.extract(sa, x)
        mb, sb = eb.extract(sb, y)
        out.append(dsp_utils.log_spectral_distance(ma, mb))
    return np.stack([o.numpy() for o in out])


def _quant_engines(path, dev, kwargs, gate=True):
    """(b)/(d): the engines (encoder → device wire → decoder) of `kwargs`
    on the card vs the same engines on the CPU, QUANT_HOPS hops at
    QUANT_BATCH with phase 6's loss pattern: the CPU carries its state,
    and each hop the card starts from the CPU's pre-hop state, as the CPU
    tests start the port from the JAX engines'.  Per hop: the card's
    features vs the CPU's; the RVQ kernel on the CPU's features vs the
    CPU's search (a row may differ only at a near-tie, as in phase 4); the
    card's captured encoder step's indices vs the CPU's (printed); the
    card's captured decoder step on the CPU's wire indices vs the CPU's
    audio and comfort-noise flags; for int8, on every QUANT_ENV_EVERY-th
    hop, the int8 elements of both graphs that differ from the CPU's.  With
    `gate`: near-ties only (≤ 0.1 % of rows), flags equal, at most
    QUANT_INT8_DIFF of the int8 elements differing, and the audio's per-hop
    log-spectral distance within QUANT_LSD_MEAN / QUANT_LSD_MAX — not the
    CPU tests' 1 int16 LSB: the card's f32 convs round differently from the
    CPU's, and now and then that carries a QUANTIZE input across its
    rounding edge, a whole int8 step that the layers after it spread (which
    the small fixture's CPU tests never met).  → (summary, the CPU's audio
    [hops, B, hop])."""
    import torch

    from lyra_tpu_torch import packet
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.dsp import utils as dsp_utils

    cpu = torch.device("cpu")
    enc_h, dec_h = (E(16000, path, device=cpu, **kwargs)
                    for E in (EncoderEngine, DecoderEngine))
    enc_c, dec_c = (E(16000, path, device=dev, **kwargs)
                    for E in (EncoderEngine, DecoderEngine))
    int8 = kwargs.get("mode") == "int8"
    pairs = [(m_h._run._graph, m_c._run._graph) for m_h, m_c in (
        (enc_h.soundstream, enc_c.soundstream), (dec_h.gan, dec_c.gan))]
    audio, received = _inputs(QUANT_BATCH, QUANT_HOPS, cpu)
    es, ds = enc_h.init_state(QUANT_BATCH), dec_h.init_state(QUANT_BATCH)
    nq, bits = 30, 120
    feat_err = lsb = 0.0
    near = own_rows = cn_diff = off_lsb = diff8 = all8 = 0
    outs_c, outs_h = [], []
    for t in range(QUANT_HOPS):
        x, rec = audio[t], received[t]
        unit = dsp_utils.int16_to_unit(x)
        feats_h, _ = enc_h.soundstream.extract(es["soundstream"], unit)
        feats_c, _ = enc_c.soundstream.extract(
            _to_card(es["soundstream"], dev), unit.to(dev))
        feat_err = max(feat_err, rel_err(feats_c.cpu(), feats_h))
        idx_h, _, es_next = enc_h.step(es, x, nq)
        idx_k = enc_c.rvq.quantize(feats_h.to(dev), nq,
                                   method=enc_c._rvq_method).cpu()
        near += _rvq_near_ties(f"quant {kwargs}", idx_k, idx_h, feats_h,
                               enc_h.rvq)
        idx_c = enc_c.step(_to_card(es, dev), x.to(dev), nq)[0].cpu()
        own_rows += int((idx_c != idx_h).any(dim=1).sum())
        dec_idx = torch.full_like(idx_h, -1)
        dec_idx[:, :nq] = packet.unpack_wire_device(
            packet.pack_wire_device(idx_h, bits), bits)
        a_c, cn_c, _ = dec_c.step(_to_card(ds, dev), dec_idx.to(dev),
                                  rec.to(dev))
        a_c, cn_c = a_c.cpu(), cn_c.cpu()
        if int8 and t % QUANT_ENV_EVERY == 0:
            lossy = dec_h.rvq.decode(dec_idx)
            for (graphs, state, inp) in (
                    (pairs[0], es["soundstream"], unit),
                    (pairs[1], ds["gan"], lossy[:, None, :])):
                d, n = _int8_envs(graphs, state, inp, dev)
                diff8, all8 = diff8 + d, all8 + n
        a_h, cn_h, ds = dec_h.step(ds, dec_idx, rec)
        es = es_next
        check(bool(torch.isfinite(a_c).all()), f"quant {kwargs}: non-finite")
        d = (a_c - a_h).abs()
        lsb = max(lsb, float(d.max()))
        off_lsb += int((d > 1.0).sum())
        cn_diff += int((cn_c != cn_h).sum())
        outs_c.append(a_c)
        outs_h.append(a_h)
    lsd = _hop_lsd(torch.stack(outs_c), torch.stack(outs_h))
    line = (f"features rel err {feat_err:.3e}; RVQ kernel on the CPU's "
            f"features: rows differing at near-ties {near} of "
            f"{QUANT_HOPS * QUANT_BATCH}; the card's encoder step: rows "
            f"differing {own_rows}; audio max diff {lsb:g} LSB ({off_lsb} "
            f"samples > 1 LSB), per-hop LSD mean {lsd.mean():.6f} max "
            f"{lsd.max():.6f} dB; comfort-noise flags differing {cn_diff}")
    if int8:
        line += (f"; int8 elements differing {diff8} of {all8} "
                 f"({diff8 / all8:.3e})")
    if gate:
        check(cn_diff == 0 and near <= 0.001 * QUANT_HOPS * QUANT_BATCH
              and diff8 <= QUANT_INT8_DIFF * all8
              and lsd.mean() < QUANT_LSD_MEAN and lsd.max() < QUANT_LSD_MAX,
              f"quant {kwargs}: card vs CPU beyond the bars: {line}")
    return line, torch.stack(outs_h)


def _quant_state(path, dev):
    """(c) state_compression="int8", float and bf16, at QUANT_BATCH:
    QUANT_HOPS captured ticks bitwise an eager run's (audio, indices,
    state); a snapshot round trip through save_state / load_state bitwise;
    the compressed decoder snapshot under 0.55 × the bytes of the float32
    state's (the JAX package's bar); the int8 and f8 graphs' bits the same
    with cuDNN's TF32 allowed and not.  → summary."""
    import tempfile

    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.tflite.executor import load_graph
    from lyra_tpu_torch.utils import checkpoint
    from lyra_tpu_torch.utils.state import state_from_numpy

    lines = []
    audio, received = _inputs(QUANT_BATCH, QUANT_HOPS, dev)
    for mode in ("float", "bf16"):
        kw = dict(mode=mode, backend="plain", state_compression="int8",
                  device=dev)
        cap = (EncoderEngine(16000, path, **kw), DecoderEngine(16000, path,
                                                               **kw))
        eag = tuple(_eager(E(16000, path, **kw))
                    for E in (EncoderEngine, DecoderEngine))
        st = {"cap": [cap[0].init_state(QUANT_BATCH),
                      cap[1].init_state(QUANT_BATCH)],
              "eag": [eag[0].init_state(QUANT_BATCH),
                      eag[1].init_state(QUANT_BATCH)]}
        for t in range(QUANT_HOPS):
            got = {}
            for k, (enc, dec) in (("cap", cap), ("eag", eag)):
                out, cn, st[k][0], st[k][1], idx = _tick(
                    enc, dec, *st[k], audio[t], received[t], 120)
                got[k] = (out.clone(), cn.clone(), idx.clone())
            check(all(torch.equal(a, b) for a, b in zip(got["cap"],
                                                        got["eag"])),
                  f"quant (c) {mode}: captured tick {t} differs from eager")
        for a, b in zip(_leaves_of(st["cap"]), _leaves_of(st["eag"])):
            check(torch.equal(a, b), f"quant (c) {mode}: state differs")
        q = [v for v in _leaves_of(st["cap"][1]["gan"])
             if v.dtype == torch.int8]
        check(bool(q), f"quant (c) {mode}: no int8 leaf in the state")
        with tempfile.TemporaryDirectory() as tmp:
            sizes = {}
            plain = DecoderEngine(16000, path, backend="plain", device=dev)
            for name, state in (("int8", st["cap"][1]),
                                ("float", plain.init_state(QUANT_BATCH))):
                f = os.path.join(tmp, name)
                checkpoint.save_state(f, state)
                sizes[name] = os.path.getsize(f + ".npz")
            back = state_from_numpy(checkpoint.load_state(
                os.path.join(tmp, "int8"))[0], dev)
        for a, b in zip(_leaves_of(back), _leaves_of(st["cap"][1])):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"quant (c) {mode}: snapshot round trip differs")
        ratio = sizes["int8"] / sizes["float"]
        check(ratio < 0.55, f"quant (c) {mode}: compressed snapshot "
              f"{sizes['int8']} B is {ratio:.3f} of the float one")
        lines.append(f"{mode}: {QUANT_HOPS} captured ticks bitwise eager, "
                     f"snapshot round trip bitwise, decoder snapshot "
                     f"{sizes['int8']} B = {ratio:.3f} × the float32 "
                     f"state's {sizes['float']} B")
    rng = np.random.default_rng(16)
    for kw in ({"mode": "int8"}, {"boundary_store": "f8"},
               {"mode": "bf16", "boundary_store": "f8"}):
        for name, shape, scale in MODELS:
            g = load_graph(os.path.join(path, f"{name}.tflite"), device=dev,
                           boundary_scale=0.5 if name == MODELS[0][0]
                           else 1.0, **kw)
            xs = [torch.tensor(rng.normal(0.0, scale, (QUANT_BATCH,) + shape),
                               dtype=torch.float32, device=dev)
                  for _ in range(3)]
            outs = []
            for tf32 in (True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                s, ys = g.init_state(QUANT_BATCH), []
                for x in xs:
                    o, s = g(s, input_audio=x)
                    ys.append(o["output_0"])
                outs.append(ys)
            torch.backends.cudnn.allow_tf32 = False
            check(all(torch.equal(a, b) for a, b in zip(*outs)),
                  f"quant (c): {name} {kw} depends on cuDNN's TF32 flag")
    lines.append("int8 and f8 (float, bf16) graphs: the same bits with "
                 "cuDNN's TF32 allowed and not (3 hops each)")
    return "; ".join(lines)


def _leaves_of(tree):
    """Every tensor of a nested dict or list, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


def _fp8_casts(dev):
    """(d) `_to_e4m3` on the card: the JAX package's bits; and a boundary
    store at the encoder's pre-scale 0.5 of twice the inputs: the same
    bits (the card's multiply drops a NaN's sign; XLA's keeps it)."""
    import torch

    from lyra_tpu_torch.tflite.executor import _BoundaryEnv, _to_e4m3

    scales = _BoundaryEnv.scales(0.5, dev)
    twice = np.where(np.isnan(FP8_INPUTS), FP8_INPUTS, FP8_INPUTS * 2)
    for dtype, want in FP8_BITS.items():
        for what, a in (("cast", FP8_INPUTS), ("store at scale 0.5", twice)):
            if dtype == "bfloat16":
                x = torch.tensor(_bf16_bits(a), device=dev).view(
                    torch.bfloat16)
            else:
                x = torch.tensor(a, device=dev)
            if what == "cast":
                got = _to_e4m3(x)
            else:
                env = _BoundaryEnv(frozenset([0]), 0.5, x.dtype, scales)
                env[0] = x
                got = env[0]
            got = got.view(torch.uint8).cpu().numpy().tolist()
            check(got == want, f"quant (d): {dtype} {what} → e4m3 bits "
                  f"{got} != the JAX package's {want}")
    return (f"{len(FP8_INPUTS)} casts from float32 and bfloat16 (±448, ties "
            f"at 464, 465-1000, ±inf and ±NaN to NaN, subnormals) and the "
            f"same stored at scale 0.5: the JAX bits")


def _quant_timing(path, dev, gpu):
    """(e) B=1024: each configuration's main path (`_drive`: fresh
    engines, QUANT_TICKS captured ticks, launch counts zeroed before and
    read after — rvq_encode launched, no conv-stack kernel on the plain
    configurations — device µs and CUDA kernels per replayed tick from the
    profiler), the memory its engines hold and its run's peak; then
    encode + wire + decode wall time per captured tick, p50/p99, in
    alternating turns (the configurations in order, then reversed,
    QUANT_TIMED ticks each).  Nothing here is gated but the main path's
    checks.  → (launches, per-tick launches of the first five)."""
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, out_edge, rvq_kernel

    launches, per_tick, runs, lines = {}, {}, {}, []
    for i, (name, kw) in enumerate(QUANT_CONFIGS):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        enc = EncoderEngine(16000, path, device=dev, **kw)
        dec = DecoderEngine(16000, path, device=dev, **kw)
        if kw["backend"] == "kernel":
            kernels = (conv_stack.KERNELS_F32 + conv_stack.CORE_F32
                       + rvq_kernel.KERNELS + (out_edge.OUT_EDGE,))
        else:
            kernels = list(rvq_kernel.KERNELS) if i < 5 else []
        counts, ticks, summary, tick = _drive(enc, dec, kernels, BATCH,
                                              QUANT_TICKS, dev, None)
        held = torch.cuda.memory_allocated(dev) - base
        peak = torch.cuda.max_memory_allocated(dev) - base
        if i < 5:
            for n, c in counts.items():
                launches[n] = launches.get(n, 0) + c
                per_tick[n] = per_tick.get(n, 0) + ticks[n]
        runs[name] = [enc, dec, enc.init_state(BATCH),
                      dec.init_state(BATCH), []]
        lines.append(f"{name}: {tick['device_us']:.1f} device µs in "
                     f"{tick['kernels']:g} CUDA kernels per captured tick, "
                     f"engines and graphs hold {held / 2**20:.0f} MiB, run "
                     f"peak {peak / 2**20:.0f} MiB; {summary}")
    audio, received = _inputs(BATCH, QUANT_TIMED, dev)
    for run in runs.values():  # both ping-pong trees captured
        for t in range(2):
            _, _, run[2], run[3], _ = _tick(run[0], run[1], run[2], run[3],
                                            audio[t], received[t], 120)
    for name in [n for n, _ in QUANT_CONFIGS] + [n for n, _ in
                                                 QUANT_CONFIGS][::-1]:
        enc, dec, es, ds, times = runs[name]
        for t in range(QUANT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, es, ds, _ = _tick(enc, dec, es, ds, audio[t], received[t],
                                    120)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        runs[name][2:4] = [es, ds]
    walls = "; ".join(
        f"{name} p50 {np.percentile(r[4], 50):.3f} ms p99 "
        f"{np.percentile(r[4], 99):.3f} ms" for name, r in runs.items())
    print(f"quant (e): B={BATCH} per captured tick, islands fixture, 16 kHz "
          f"[{gpu}]: " + " | ".join(lines))
    print(f"quant (e): B={BATCH} encode+wire+decode wall time per captured "
          f"tick, {2 * QUANT_TIMED} ticks each in alternating turns [{gpu}]:"
          f" {walls}; card peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB since the "
          f"last reset")
    return launches, per_tick


def phase_quant(dev, gpu):
    """Phase 15: the quantized modes on the islands fixture at full width
    (tests/golden/synthetic_lyra_islands/full): int8 and fakequant, int8
    state storage and fp8 boundaries, through the engines on the plain
    backend, which alone runs them.  → (launches, per-tick launches) of
    (e)'s main-path runs."""
    t_phase = time.time()
    path = ISLANDS_FIXTURE
    print(f"quant (a): ok, {_quant_ops(path, dev)}")
    cpu_audio = {}
    for mode in ("int8", "fakequant"):
        line, cpu_audio[mode] = _quant_engines(
            path, dev, {"mode": mode, "backend": "plain"})
        print(f"quant (b) {mode}: ok, card vs CPU over {QUANT_HOPS} hops at "
              f"B={QUANT_BATCH}: {line}")
    ctl = _hop_lsd(cpu_audio["fakequant"], cpu_audio["int8"])
    check(ctl.mean() >= QUANT_LSD_MEAN and ctl.max() >= QUANT_LSD_MAX,
          f"quant (b): the control passes the LSD bars (mean "
          f"{ctl.mean():.6f}, max {ctl.max():.6f} dB), which then tell "
          f"nothing")
    print(f"quant (b) control: ok, the CPU's fakequant audio vs its int8 "
          f"audio fails the bars: per-hop LSD mean {ctl.mean():.6f} max "
          f"{ctl.max():.6f} dB (bars {QUANT_LSD_MEAN} / {QUANT_LSD_MAX})")
    print(f"quant (c): ok, {_quant_state(path, dev)}")
    print(f"quant (d): ok, {_fp8_casts(dev)}")
    for mode in ("float", "bf16"):
        line, _ = _quant_engines(path, dev, {"mode": mode, "backend": "plain",
                                             "boundary_store": "f8"},
                                 gate=False)
        print(f"quant (d) f8 {mode}: card vs CPU over {QUANT_HOPS} hops at "
              f"B={QUANT_BATCH} (printed, not gated): {line}")
    launches, per_tick = _quant_timing(path, dev, gpu)
    print(f"quant: phase 15 took {time.time() - t_phase:.1f} s")
    return launches, per_tick


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
    from lyra_tpu_torch.ops import conv_stack, out_edge, rvq_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    path, weights = model_dir()
    print(f"weights: {weights}")
    gpu = gpu_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} [{gpu}]")

    phase_build()
    kernels = conv_stack.KERNELS + rvq_kernel.KERNELS + out_edge.KERNELS
    stats = {k.name: {"max_abs_err": 0.0, "calls": 0, "cold_ms": None}
             for k in kernels}
    phase_k1(path, BATCH, dev, stats, gpu)
    phase_k1_bf16(path, BATCH, dev, stats, gpu)
    phase_k2(ResidualVectorQuantizer.from_model_path(path, dev), BATCH, dev,
             stats, gpu)
    phase_rates(BATCH, dev)
    launches, per_tick, plain_ticks = {}, {}, {}
    for phase, mode in ((phase_main, "float"), (phase_main_bf16, "bf16")):
        counts, ticks, plain_ticks[mode] = phase(path, BATCH, TICKS, dev,
                                                 args.profile_out)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
            per_tick[name] = per_tick.get(name, 0) + ticks[name]
    phase_timing(path, BATCH, dev, gpu)
    phase_serve(path, BATCH, dev, gpu)
    phase_serve_process(path, dev, gpu)
    phase_offline(path, dev, gpu)
    counts, ticks = phase_islands(BATCH, dev, stats, gpu, plain_ticks)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
        per_tick[name] = per_tick.get(name, 0) + ticks[name]
    phase_fleet(path, dev, gpu)
    phase_sharding(path, gpu)
    counts, ticks = phase_quant(dev, gpu)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
        per_tick[name] = per_tick.get(name, 0) + ticks[name]

    # Per hop at B=1024: eager medians, then graph-replay medians, and the
    # RVQ kernel's cold-L2 single launch; the launches of phases 6, 7, 12
    # and 15's runs and per replayed tick.  The conv kernels' library call
    # is one cuDNN call (TF32 off) with the weights laid out beforehand; no
    # single PyTorch call computes the RVQ search.
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
