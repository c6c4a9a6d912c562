"""Log-mel extractor micro-benchmark — port of
lyra_tpu/tools/melspec_benchmark.py.

Analog of the reference's google-benchmark for the feature extractor
(reference: lyra/log_mel_spectrogram_extractor_impl_benchmark.cc:27-71,
which sweeps hop sizes); on an accelerator the relevant axis is the stream
batch, so this sweeps hop sizes AND batch sizes of the batched extractor,
each call one CUDA-graph replay on the card (`main(argv, device=)` names
another device; the CPU runs it eagerly).

Usage: python -m lyra_tpu_torch.tools.melspec_benchmark [--iters=200]
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial

import numpy as np

from lyra_tpu_torch import config


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--sample_rate_hz", type=int, default=16000)
    args = p.parse_args(argv)

    import torch

    from lyra_tpu_torch.dsp import melspec
    from lyra_tpu_torch.utils.capture import GraphCache, replay
    from lyra_tpu_torch.utils.device import resolve

    dev = resolve(device)
    graphs = GraphCache(dev) if dev.type == "cuda" else None
    sync = torch.cuda.synchronize if graphs is not None else (lambda: None)
    rng = np.random.RandomState(0)
    for hop in (160, 320, 640):
        for batch in (1, 256, 4096):
            cfg = melspec.MelConfig(
                args.sample_rate_hz, hop, 2 * hop, config.NUM_MEL_BINS)
            ex = melspec.LogMelExtractor(cfg, device=dev)

            def step(state, frames, ex=ex):
                feats, mel = ex.extract(state["mel"], frames)
                return feats, {"mel": mel}

            extract = partial(replay, graphs, dev, step, ("extract", hop))
            state = {"mel": ex.init_state(batch)}
            frames = torch.tensor(
                rng.uniform(-32768, 32767, (batch, hop)).astype(np.float32),
                device=dev)
            for _ in range(2):  # on the card: a graph per state tree
                feats, state = extract(state, frames)
            sync()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                feats, state = extract(state, frames)
            sync()
            dt = (time.perf_counter() - t0) / args.iters
            print(f"hop={hop:5d} batch={batch:5d}: {dt*1e6:10.1f} us/step  "
                  f"({batch/dt:12.0f} frames/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
