"""Per-stage codec benchmark (reference: lyra/lyra_benchmark{,_lib}.{h,cc})
— port of lyra_tpu/tools/benchmark.py.  Runs on the card unless the caller
names another device (`run_benchmark(..., device=)`, `main(argv, device=)`);
on the card every stage call is one CUDA-graph replay followed by
`torch.cuda.synchronize()`, inside the stage's clock.

Reproduces the reference protocol — N conditioning vectors of random noise
through feature_extractor → quantizer_quantize → quantizer_decode →
model_decode with per-stage wall-clock stats {mean, max, min, stdev} and a
total row (reference: lyra_benchmark_lib.cc:199-293, 2000 frames default,
120-bit quantizer at lyra_benchmark_lib.cc:58) — and adds the batched
axis the reference doesn't have: `--batch` to measure batched throughput
and derived concurrent real-time streams per chip.

The models run on the kernel backend in float and bf16, and on the plain
backend in fakequant (the quantized modes have no kernel: the JAX tool
runs them on its xla lowering); the report names the backend.

Usage:
    python -m lyra_tpu_torch.tools.benchmark --num_cond_vectors=2000 \
        [--batch=1] [--csv=/tmp/benchmarks/lyra_tpu_torch.csv] [--model_path=DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time
from functools import partial
from typing import Callable, Optional

import numpy as np

from lyra_tpu_torch import config

log = logging.getLogger("lyra_tpu")


@dataclasses.dataclass
class TimingStats:
    max_us: float
    min_us: float
    mean_us: float
    stdev_us: float
    num_calls: int

    @classmethod
    def from_durations(cls, durations_us: np.ndarray) -> "TimingStats":
        d = np.asarray(durations_us, np.float64)
        return cls(float(d.max()), float(d.min()), float(d.mean()),
                   float(d.std(ddof=1)) if d.size > 1 else 0.0, int(d.size))


def _time_stage(fn: Callable, iters: int, sync: Callable) -> np.ndarray:
    durations = np.empty(iters, np.float64)
    for i in range(iters):
        t0 = time.perf_counter()
        fn(i)
        sync()
        durations[i] = (time.perf_counter() - t0) * 1e6
    return durations


class _RotatingPool:
    """frames[i] over a small device-resident pool (timing-equivalent to
    distinct random frames; avoids materializing them all)."""

    def __init__(self, pool):
        self._pool = pool

    def __getitem__(self, i):
        return self._pool[i % self._pool.shape[0]]


def run_benchmark(num_cond_vectors: int = 2000, batch: int = 1,
                  num_bits: int = 120,
                  model_path: str = config.DEFAULT_MODEL_PATH,
                  csv_path: Optional[str] = None,
                  profile_dir: Optional[str] = None,
                  mode: str = "float",
                  benchmark_feature_extraction: bool = True,
                  benchmark_quantizer: bool = True,
                  benchmark_generative_model: bool = True,
                  *, device=None) -> dict:
    import contextlib

    import torch

    from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer
    from lyra_tpu_torch.models.streaming import LyraGanModel, SoundStreamEncoder
    from lyra_tpu_torch.tflite.executor import QUANT_MODES, compute_dtype
    from lyra_tpu_torch.utils.capture import GraphCache, replay
    from lyra_tpu_torch.utils.device import resolve

    dev = resolve(device)
    compute_dtype(mode)  # an unknown mode raises
    backend = "plain" if mode in QUANT_MODES else "kernel"
    hop = config.num_samples_per_hop(config.INTERNAL_SAMPLE_RATE)
    nq = num_bits // config.BITS_PER_QUANTIZER
    rng = np.random.RandomState(0)

    # Per-stage disable flags match the reference exactly: a disabled stage's
    # component is never constructed and its bracket times a zeros substitute
    # (reference: lyra_benchmark.cc:34-41, lyra_benchmark_lib.cc:85-162 —
    # null component → std::vector<float>(kNumFeatures, 0) etc., timing row
    # still recorded).
    soundstream = (SoundStreamEncoder(model_path, mode=mode, device=dev,
                                      backend=backend)
                   if benchmark_feature_extraction else None)
    gan = (LyraGanModel(model_path, mode=mode, device=dev, backend=backend)
           if benchmark_generative_model else None)
    rvq = (ResidualVectorQuantizer.from_model_path(model_path, dev)
           if benchmark_quantizer else None)

    # Stage kernels, each one CUDA-graph replay on the card (the JAX
    # tool's standalone jits), so each stage is timed in isolation exactly
    # like the reference's MaybeRun* brackets
    # (reference: lyra_benchmark_lib.cc:85-162).  The stateless stages run
    # over an empty state tree.
    graphs = GraphCache(dev) if dev.type == "cuda" else None

    def compiled(fn, key):
        return partial(replay, graphs, dev, fn, key)

    ss_state = soundstream.init_state(batch) if soundstream else {}
    gan_state = gan.init_state(batch) if gan else {}

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    zero_feats = zeros(batch, config.NUM_FEATURES)
    zero_idx = torch.zeros((batch, nq), dtype=torch.int32, device=dev)
    zero_audio = zeros(batch, hop)
    if soundstream:
        extract = compiled(soundstream.extract, "feature_extractor")
    else:
        extract = lambda st, frame: (zero_feats, st)
    if rvq:
        quantize = compiled(lambda st, f: (rvq.quantize(f, nq), st),
                            "quantizer_quantize")
        dequantize = compiled(lambda st, i: (rvq.decode(i), st),
                              "quantizer_decode")
    else:
        quantize = lambda st, f: (zero_idx, st)
        dequantize = lambda st, i: (zero_feats, st)
    if gan:
        decode = compiled(gan.decode_hop, "model_decode")
    else:
        decode = lambda st, feats: (zero_audio, st)

    # A small rotating pool instead of [num_cond_vectors, batch, hop]: the
    # full tensor would be ~84 GB of host float64 at B=16384.
    pool = torch.tensor(
        rng.uniform(-1.0, 1.0, (min(num_cond_vectors, 8), batch, hop))
        .astype(np.float32), device=dev)
    frames = _RotatingPool(pool)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else lambda: None)

    # Warm up each stage, then measure.  Twice: on the card a stateful
    # stage captures one graph per state tree of its ping-pong pair.
    for _ in range(2):
        feats, ss_state = extract(ss_state, frames[0])
        idx, _ = quantize({}, feats)
        lossy, _ = dequantize({}, idx)
        _, gan_state = decode(gan_state, lossy)
    sync()

    states = {"ss": ss_state, "gan": gan_state}
    feats_buf, idx_buf, lossy_buf = [feats], [idx], [lossy]

    def stage_extract(i):
        f, states["ss"] = extract(states["ss"], frames[i])
        feats_buf[0] = f
        return f

    def stage_quantize(i):
        idx_buf[0], _ = quantize({}, feats_buf[0])
        return idx_buf[0]

    def stage_dequantize(i):
        lossy_buf[0], _ = dequantize({}, idx_buf[0])
        return lossy_buf[0]

    def stage_decode(i):
        out, states["gan"] = decode(states["gan"], lossy_buf[0])
        return out

    # Optional device trace (the torch.profiler analog of the reference's
    # absl::Now() brackets): a Chrome trace in profile_dir.
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace_cm = (torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
        if profile_dir else contextlib.nullcontext())
    rows = {}
    with trace_cm:
        for name, fn in (
            ("feature_extractor", stage_extract),
            ("quantizer_quantize", stage_quantize),
            ("quantizer_decode", stage_dequantize),
            ("model_decode", stage_decode),
        ):
            with torch.profiler.record_function(name):
                rows[name] = TimingStats.from_durations(
                    _time_stage(fn, num_cond_vectors, sync))

    total_mean = sum(r.mean_us for r in rows.values())
    lines = [f"mode {mode}, backend {backend}"]
    for name, r in rows.items():
        lines.append(
            f"{name:20s} max: {r.max_us:9.1f} us  min: {r.min_us:9.1f} us  "
            f"mean: {r.mean_us:9.1f} us  stdev: {r.stdev_us:8.1f} us  "
            f"({r.num_calls} calls)")
    per_frame_ms = total_mean / 1e3
    realtime_factor = 20.0 / per_frame_ms  # one step covers 20 ms per stream
    streams = batch * realtime_factor
    lines.append(
        f"{'total':20s} mean: {total_mean:9.1f} us/step  batch: {batch}  "
        f"=> {realtime_factor:.1f}x realtime per step, "
        f"~{streams:.0f} concurrent streams/chip")
    report = "\n".join(lines)
    print(report)

    if csv_path:
        if os.path.dirname(csv_path):
            os.makedirs(os.path.dirname(csv_path), exist_ok=True)
        with open(csv_path, "w") as f:
            f.write("stage,max_us,min_us,mean_us,stdev_us,num_calls\n")
            for name, r in rows.items():
                f.write(f"{name},{r.max_us},{r.min_us},{r.mean_us},"
                        f"{r.stdev_us},{r.num_calls}\n")

    return {"rows": rows, "total_mean_us": total_mean,
            "streams_per_chip": streams, "batch": batch, "backend": backend}


def main(argv=None, *, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_cond_vectors", type=int, default=2000)
    p.add_argument("--batch", type=int, default=1,
                   help="Streams per kernel launch (reference equivalent: 1).")
    p.add_argument("--num_bits", type=int, default=120)
    p.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH)
    p.add_argument("--csv", default=None,
                   help="Optional CSV output path (reference writes "
                        "/tmp/benchmarks/ CSVs).")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a torch.profiler trace to DIR.")
    p.add_argument("--mode", default="float", choices=["float", "fakequant", "bf16"],
                   help="Conv compute mode (fakequant runs on the plain "
                        "backend).")
    # Per-stage toggles (reference: lyra_benchmark.cc:34-41). absl-style
    # bools: --benchmark_quantizer=false / true / 1 / 0.
    for flag, doc in (
        ("benchmark_feature_extraction", "feature extraction"),
        ("benchmark_quantizer", "quantizer"),
        ("benchmark_generative_model", "generative model"),
    ):
        p.add_argument(f"--{flag}", type=_parse_bool, default=True,
                       metavar="BOOL",
                       help=f"Whether to benchmark the {doc}.")
    args = p.parse_args(argv)
    run_benchmark(args.num_cond_vectors, args.batch, args.num_bits,
                  args.model_path, args.csv, args.profile, args.mode,
                  args.benchmark_feature_extraction,
                  args.benchmark_quantizer,
                  args.benchmark_generative_model, device=device)
    return 0


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


if __name__ == "__main__":
    sys.exit(main())
