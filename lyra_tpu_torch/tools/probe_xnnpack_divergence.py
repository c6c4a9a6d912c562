"""Measure builtin-kernel vs XNNPACK-delegate divergence on the shipped graphs.

The reference's shipped runtime path enables the XNNPACK delegate
(reference: lyra/tflite_model_wrapper.cc:63-84); this repo's arithmetic
oracle is the *builtin* kernels instead (the int8 mode of
tflite/executor.py).  This
probe backs that choice with a number: it streams the same frames through
both interpreter configurations (each carrying its own VAR_HANDLE state)
and reports the output divergence.  Measured 2026-08 (recorded in
PARITY.md): soundstream features diverge up to ~1.3 units (4.1% of range),
lyragan audio up to ~0.07 on the unit scale, over 50 streaming frames —
i.e. XNNPACK itself is NOT bit-faithful to the builtin kernels, so there
is no single "reference arithmetic" to match; builtin is the canonical,
delegate-independent one.

Usage: python -m lyra_tpu_torch.tools.probe_xnnpack_divergence [model_coeffs_dir]
"""

from __future__ import annotations

import sys

import numpy as np

from lyra_tpu_torch import config


def probe(model_dir: str = config.DEFAULT_MODEL_PATH, frames: int = 50):
    import tensorflow as tf

    results = {}
    for model, make_input in (
        ("soundstream_encoder",
         lambda r: {"input_audio":
                    r.uniform(-0.5, 0.5, (1, 320)).astype(np.float32)}),
        ("lyragan",
         lambda r: {"input_audio":
                    r.normal(0, 5, (1, 1, 64)).astype(np.float32)}),
    ):
        path = f"{model_dir}/{model}.tflite"
        ip_b = tf.lite.Interpreter(
            model_path=path,
            experimental_op_resolver_type=tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES)
        ip_x = tf.lite.Interpreter(model_path=path)  # default: XNNPACK
        rb = ip_b.get_signature_runner("serving_default")
        rx = ip_x.get_signature_runner("serving_default")
        rng_b, rng_x = np.random.default_rng(0), np.random.default_rng(0)
        diffs = []
        for _ in range(frames):
            ob = rb(**make_input(rng_b))
            ox = rx(**make_input(rng_x))
            for k in ob:
                diffs.append(np.abs(np.asarray(ob[k], np.float64)
                                    - np.asarray(ox[k], np.float64)).max())
        results[model] = {"max_abs": float(max(diffs)),
                          "mean_abs": float(np.mean(diffs)),
                          "frames": frames}
        print(f"{model}: max abs output diff {max(diffs):.6g}, "
              f"mean abs {np.mean(diffs):.6g} over {frames} frames")
    return results


if __name__ == "__main__":
    probe(*(sys.argv[1:2] or [config.DEFAULT_MODEL_PATH]))
