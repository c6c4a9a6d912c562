"""Probe which requantization rounding each TFLite kernel actually uses —
port of lyra_tpu/tools/probe_int8_rounding.py on the port's int8 helpers.

The interpreter mixes MultiplyByQuantizedMultiplier implementations per
kernel (the ruy-backed CONV_2D still uses the legacy gemmlowp double
rounding; most other int8 kernels use TFLITE_SINGLE_ROUNDING).  This tool
feeds every int8 op of a model directory's graphs its *exact* interpreter
input tensors (experimental_preserve_all_tensors), runs it through the int8
lowering of lyra_tpu_torch.tflite.executor on the CPU, and counts, per op
kind, how many elements each rounding variant mismatches.  The table in use
is `lyra_tpu_torch.tflite.executor._INT8_ROUNDING`; it is restored however
the probe exits.  Needs TensorFlow (imported when the probe runs).

Usage: python -m lyra_tpu_torch.tools.probe_int8_rounding [model_coeffs_dir]
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

from lyra_tpu_torch import config

PROBE_OPS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV", "LEAKY_RELU",
             "ADD", "QUANTIZE")


def probe(model_dir: str = config.DEFAULT_MODEL_PATH, frames: int = 8):
    import tensorflow as tf

    from lyra_tpu_torch.tflite import executor

    totals = defaultdict(lambda: defaultdict(int))

    # The probe mutates the module-global rounding table; restore the real
    # defaults however the probe exits, so a mid-probe failure can't leave
    # arbitrary probe values corrupting later int8 graph loads.
    saved_rounding = dict(executor._INT8_ROUNDING)
    try:
        return _probe(model_dir, frames, totals, executor, tf)
    finally:
        executor._INT8_ROUNDING.clear()
        executor._INT8_ROUNDING.update(saved_rounding)


def _probe(model_dir, frames, totals, executor, tf):
    from lyra_tpu_torch.tflite import model as tfl

    for model, sig, make_input in (
        ("soundstream_encoder", "serving_default",
         lambda r: {"input_audio": r.uniform(-0.5, 0.5, (1, 320)).astype(np.float32)}),
        ("lyragan", "serving_default",
         lambda r: {"input_audio": r.normal(0, 5, (1, 1, 64)).astype(np.float32)}),
    ):
        path = f"{model_dir}/{model}.tflite"
        ip = tf.lite.Interpreter(
            model_path=path,
            experimental_op_resolver_type=tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES,
            experimental_preserve_all_tensors=True)
        runner = ip.get_signature_runner(sig)
        graph = executor.GraphFn(tfl.load(path), sig, mode="int8",
                                 device="cpu")
        sg = graph.sg
        rng = np.random.default_rng(0)
        for _ in range(frames):
            runner(**make_input(rng))
            for op in sg.ops:
                if not op.outputs:
                    continue
                o0 = op.outputs[0]
                t_out = sg.tensors[o0]
                if t_out.dtype != np.int8 or op.name not in PROBE_OPS:
                    continue
                try:
                    ref = ip.get_tensor(o0)
                except Exception:
                    continue
                # CONV_2D's rounding is chosen per instance by filter depth
                # (executor._conv_rounding): bucket its results by input
                # channels so the table validates that threshold directly.
                key = op.name
                if op.name == "CONV_2D":
                    cin = int(sg.tensors[op.inputs[1]].shape[-1])
                    key = f"CONV_2D:cin={cin}"
                for rounding in ("single", "double", "ruy"):
                    executor._INT8_ROUNDING[op.name] = rounding
                    got = _run_op(graph, op, ip)
                    if got is None:
                        continue
                    totals[key][rounding] += int(
                        (np.asarray(got) != ref).sum())

    print(f"{'op kind':20s} {'single':>10s} {'double':>10s} {'ruy':>10s}   winner")
    for kind, counts in sorted(totals.items()):
        if not counts:  # every attempt for this kind failed to run
            print(f"{kind:20s} {'(no runs)':>34s}")
            continue
        winner = min(counts, key=counts.get)
        print(f"{kind:20s} {counts.get('single', -1):10d} "
              f"{counts.get('double', -1):10d} {counts.get('ruy', -1):10d}"
              f"   {winner}")
    return totals


def _run_op(graph, op, ip):
    """Run one int8 op through the port's int8 lowering (the op's entry of
    `graph`: helper, operands, parameters) on the interpreter's inputs;
    its rounding is read from the table when it runs."""
    import torch

    entry = graph._int8.get(op.index)
    if entry is None:
        return None
    fn, ins, args, kw = entry
    try:
        inputs = [torch.from_numpy(np.array(ip.get_tensor(i))) for i in ins]
        return fn(*inputs, *args, **kw).numpy()
    except (ValueError, KeyError):
        return None


if __name__ == "__main__":
    probe(*(sys.argv[1:2] or [config.DEFAULT_MODEL_PATH]))
