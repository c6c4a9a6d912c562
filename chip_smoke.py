#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (lyra_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-out DIR]

Drives the port's main path — the lockstep codec tick: EncoderEngine.step
→ device wire pack → unpack → DecoderEngine.step — at the full width of the
Lyra v2 models: the real weights when LYRA_TPU_MODEL_PATH names a directory
that holds them, otherwise the synthetic full-width fixture
(tests/golden/synthetic_lyra/full, random weights from a seed).

Phases, one line each; any failed check raises and exits nonzero:
  1. build   the CUDA kernels from lyra_tpu_torch/ops/csrc with nvcc;
  2. K1      the fused conv stack vs the plain executor (SoundStream and
             LyraGAN, B=64, 20 frames, state carried, TF32 off; bar
             1e-5 × max|plain|), then every conv-stack kernel call of one
             hop vs its plain version at B=1024, timed;
  3. K2      the RVQ kernel vs its plain version at B=4096: rows may
             differ only at near-ties, at most 0.1% of rows;
  4. main    50 ticks at B=1024 with ~10% of hops lost, launch
             counts reset before and read after, kernel names checked in
             a torch.profiler window, output finite at speech level, and
             the kernel path's decoder vs the plain path's on the same
             indices (within 2 int16 LSB);
  5. timing  p50/p99 ms per tick, kernel path vs plain path.
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
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
FULL_FIXTURE = os.path.join(REPO, "tests", "golden", "synthetic_lyra", "full")
REL_TOL = 1e-5
BATCH, TICKS = 1024, 50  # the main path's streams and ticks


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
    libs = [cuda_build.build(src) for src in ("conv_stack.cu", "rvq_encode.cu")]
    ptxas = []
    for src in ("conv_stack", "rvq_encode"):
        with open(os.path.join(cuda_build.BUILD_DIR, f"{src}.ptxas.txt")) as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"build: ok, {len(libs)} libraries from lyra_tpu_torch/ops/csrc in "
          f"{time.time() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")


def phase_k1(path, batch, dev, stats):
    import torch

    from lyra_tpu_torch.ops.fused_stack import FusedStack
    from lyra_tpu_torch.tflite.executor import load_graph

    rng = np.random.default_rng(1)
    worst = {}
    for name, shape, scale in (("soundstream_encoder", (320,), 0.1),
                               ("lyragan", (1, 64), 1.0)):
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
          f"B={batch}: " + ", ".join(
              f"{k} {v['calls']} calls {v['ms']:.4f} ms vs plain "
              f"{v['plain_ms']:.4f} ms" for k, v in stats.items()
              if k != "rvq_encode"))


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


def _inputs(batch, ticks, dev):
    import torch

    rng = np.random.default_rng(3)
    gain = np.where(rng.random((ticks, batch, 1)) < 0.8, 3000.0, 300.0)
    audio = torch.tensor(rng.normal(0.0, 1.0, (ticks, batch, 320)) * gain,
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


def phase_main(path, batch, ticks, dev, profile_out):
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.ops import conv_stack, rvq_kernel

    kernels = conv_stack.KERNELS + rvq_kernel.KERNELS
    enc = EncoderEngine(16000, path, device=dev)
    dec = DecoderEngine(16000, path, device=dev)
    audio, received = _inputs(batch, ticks, dev)
    lost = 1.0 - received.float().mean().item()
    es, ds = enc.init_state(batch), dec.init_state(batch)
    num_bits = 120
    outs, cn_count = [], 0
    prof_window = range(ticks - 3, ticks)
    for k in kernels:
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
    launches = {k.name: k.launches for k in kernels}
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")

    out = torch.stack(outs)
    check(out.shape == (ticks, batch, 320), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "main path: non-finite audio")
    rms = out[10:].float().pow(2).mean().sqrt().item()
    check(300.0 <= rms <= 15000.0, f"main path: RMS {rms} not speech-level")

    events = prof.key_averages()
    cuda_names = [e.key for e in events
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    check(bool(cuda_names), "profiler recorded no CUDA events")
    seen = {k.name: any(k.name in n for n in cuda_names) for k in kernels}
    check(all(seen.values()), f"profiler: kernels missing {seen}")
    if profile_out:
        os.makedirs(profile_out, exist_ok=True)
        with open(os.path.join(profile_out, "chip_smoke_profile.txt"), "w") as f:
            f.write(events.table(sort_by="cuda_time_total", row_limit=60))

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
    print(f"main path: ok, B={batch} x {ticks} ticks, {lost:.1%} of hops "
          f"lost, audio RMS "
          f"{rms:.1f} (int16), {cn_count} comfort-noise stream-hops; "
          f"launches {launches}; kernel names in profiler: "
          f"{', '.join(seen)}; vs plain path (B={b_ref}, 10 "
          f"ticks): rows with identical indices {same_idx:.4f}, decoder max "
          f"diff {worst_lsb} LSB")
    return launches


def phase_timing(path, batch, dev, gpu):
    import torch

    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine

    audio, received = _inputs(batch, 20, dev)
    paths = {}
    for backend in ("kernel", "plain"):
        enc = EncoderEngine(16000, path, backend=backend, device=dev)
        dec = DecoderEngine(16000, path, backend=backend, device=dev)
        paths[backend] = [enc, dec, enc.init_state(batch),
                          dec.init_state(batch), []]
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
    res = {}
    for backend, (_, _, _, _, times) in paths.items():
        res[backend] = (float(np.percentile(times, 50)),
                        float(np.percentile(times, 99)))
    print(f"timing: B={batch} encode+wire+decode per tick, 40 ticks each: "
          f"kernel p50 {res['kernel'][0]:.3f} ms p99 {res['kernel'][1]:.3f} ms; "
          f"plain p50 {res['plain'][0]:.3f} ms p99 {res['plain'][1]:.3f} ms "
          f"[{gpu}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-out", default=None,
                    help="directory for the profiler's kernel table")
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
    phase_k2(ResidualVectorQuantizer.from_model_path(path, dev), BATCH, dev,
             stats)
    launches = phase_main(path, BATCH, TICKS, dev, args.profile_out)
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
