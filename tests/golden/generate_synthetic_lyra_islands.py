"""Write the islands variant of the synthetic Lyra fixture (random weights).

The shipped models are not plain float graphs: SURVEY.md §2.1 counts 6
QUANTIZE and 10 DEQUANTIZE ops in soundstream_encoder.tflite, and
lyragan.tflite holds int8 islands too: regions of the float graph that run
as int8 ops with int8 per-channel weights and int32 biases, entered through
a QUANTIZE and left through a DEQUANTIZE, a state slice reaching its
ASSIGN_VARIABLE through a DEQUANTIZE.  This script builds the graphs of
generate_synthetic_lyra.py (its builders, imported, with the same I/O
signatures, state variables and state float counts) and changes two things:

  * int8 islands: some layers are quantized by TFLite's own full-integer
    quantizer (a representative dataset of random hops) while the selective
    quantization debugger's deny-list keeps every other op in float, so
    float regions stay between the islands.  SoundStream: the residual units
    enc0_d3 and enc2_d3 and the strided conv enc1_down; LyraGAN: the
    residual units gan1_d3 and gan2_d3, and every TRANSPOSE_CONV (the five
    upsamplers and the output edge), which TF 2.21's quantizer takes into
    int8 whatever the deny-list says.
  * one residual unit per model (enc0_d9, gan2_d9) carries the rest of the
    fused stack's op vocabulary, which real Lyra graphs do not hold: a MUL by
    a per-channel constant after a LEAKY_RELU, STRIDED_SLICEs that are
    neither a crop nor a state slice (a channel range feeding a conv, and
    stride-2 time slices), a CONCATENATION along time of those slices and
    one along channels feeding a conv, and a DIV of two core tensors whose
    divisor (q·q + 1) is positive by construction.  It keeps the unit's
    state variable and its three convs.

  full/   published widths (as synthetic_lyra/full).
  small/  internal channels divided by 8: the CPU test fixture.

Both hold the plain fixture's quantizer.tflite and lyra_config.binarypb.
Weights are random from fixed seeds and the converter is deterministic.
Regenerate (needs TensorFlow, ~1 min):

    python tests/golden/generate_synthetic_lyra_islands.py
"""

from __future__ import annotations

import os
import sys
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import generate_synthetic_lyra as base  # noqa: E402

OUT_ROOT = os.path.join(HERE, "synthetic_lyra_islands")
SEED = 20261017
ISLAND = "island"  # name scope of the quantized layers
# Layer indices into base.build_encoder / base.build_gan's layer lists.
ENC_ISLANDS = (2, 8, 10)  # enc0_d3, enc1_down, enc2_d3
GAN_ISLANDS = (7, 11)  # gan1_d3, gan2_d3
ENC_EXTRA = (3, "enc0_d9", 9)  # (layer, its state variable, dilation)
GAN_EXTRA = (12, "gan2_d9", 9)
CALIBRATION_HOPS = 16


def _island(layer, k: int):
    """The layer with its ops under the island name scope."""
    def f(tf, x, read, write):
        with tf.name_scope(f"{ISLAND}{k}"):
            return layer(tf, x, read, write)
    return f


def _extra_unit(net: base._Net, p: base._Params, c: int, d: int, name: str):
    """A residual unit over the state variable `name` of an existing unit,
    with the ops listed in the module docstring (3 convs, as before)."""
    if net.states[name] != (1, 2 * d, 1, c):
        raise ValueError(f"{name}: {net.states[name]}")
    dw = p.depthwise(3, c)
    pw1 = p.conv(1, c // 2, c)  # reads channels c/2 .. c of h
    scale = p.rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
    pw2 = p.conv(1, c // 2, c, gain=0.5)  # 2c channels in, groups 4

    def f(tf, x, read, write):
        xc = base._context(tf, x, name, 2 * d, read, write)
        h = base._leaky(tf, base._depthwise(tf, xc, *dw, dilation=d))
        g = base._leaky(tf, base._conv(tf, h[:, :, :, c // 2:], *pw1))
        g = g * tf.constant(scale)
        q = tf.concat([g[:, 0::2], g[:, 1::2]], axis=1)
        r = q / (q * q + 1.0)
        y = base._conv(tf, tf.concat([r, h], axis=3), *pw2)
        return x + y

    return f


def _build(tf, name: str, div: int, seed: int, scale: float = 1.0):
    """The net of `name` with its islands scoped and its extra unit."""
    build, islands, (layer, var, d) = {
        "soundstream_encoder": (base.build_encoder, ENC_ISLANDS, ENC_EXTRA),
        "lyragan": (base.build_gan, GAN_ISLANDS, GAN_EXTRA)}[name]
    rng = np.random.default_rng(seed)
    net = build(base._Params(np.random.default_rng(rng.integers(1 << 31))),
                div)
    for a in net.out_weights:
        a *= scale
    c = net.states[var][3]
    net.layers[layer] = _extra_unit(
        net, base._Params(np.random.default_rng(rng.integers(1 << 31))), c,
        d, var)
    for k in islands:
        net.layers[k] = _island(net.layers[k], k)
    return net


def _hops(in_shape, seed: int, n: int):
    rng = np.random.default_rng(seed)
    sd = 0.1 if in_shape[-1] == base.HOP else 1.0
    return [rng.normal(0.0, sd, in_shape).astype(np.float32)
            for _ in range(n)]


def _convert(tf, module, in_shape, seed: int) -> bytes:
    """Full-integer quantization of the island scopes, the rest denied."""
    cf = module.__call__.get_concrete_function()

    def converter():
        conv = tf.lite.TFLiteConverter.from_concrete_functions([cf], module)
        conv.experimental_enable_resource_variables = True
        return conv

    conv = converter()
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS]
    names = [t["name"] for t in tf.lite.Interpreter(
        model_content=conv.convert()).get_tensor_details()]
    deny = [n for n in names if not n.startswith(ISLAND)]

    def dataset():
        for x in _hops(in_shape, seed, CALIBRATION_HOPS):
            yield [x]

    conv = converter()
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = dataset
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8,
                                      tf.lite.OpsSet.TFLITE_BUILTINS]
    debugger = tf.lite.experimental.QuantizationDebugger(
        converter=conv, debug_dataset=dataset,
        debug_options=tf.lite.experimental.QuantizationDebugOptions(
            denylisted_nodes=deny))
    return debugger.get_nondebug_quantized_model()


def op_histogram(blob: bytes) -> Counter:
    """Builtin op name → count over the main subgraph (tflite/model.py of
    the port parses the flatbuffer; no TensorFlow needed)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from lyra_tpu_torch.tflite import model as tfl
    return Counter(op.name for op in tfl._parse("", blob).subgraphs[0].ops)


def build_conv_models(tf, div: int, seed: int):
    """name → (flatbuffer, state floats, state variables)."""
    out = {}
    for name, in_shape, target_rms in (
            ("soundstream_encoder", [1, base.HOP], 1.0),
            ("lyragan", [1, 1, base.NUM_FEATURES], 0.1)):
        s = seed + (0 if name == "lyragan" else 1)
        # Two passes, as the plain fixture: measure the eager output RMS,
        # then rebuild with the last layer rescaled to a speech-like level.
        net = _build(tf, name, div, s)
        rms = base._calibrate(tf, base._module(tf, net, in_shape), in_shape,
                              np.random.default_rng(seed))
        net = _build(tf, name, div, s, target_rms / max(rms, 1e-6))
        module = base._module(tf, net, in_shape)
        out[name] = (_convert(tf, module, in_shape, s),
                     sum(int(np.prod(v)) for v in net.states.values()),
                     len(net.states))
    return out


def main(argv=None) -> int:
    tf = base._tf()
    tf.random.set_seed(SEED)
    quant = base.build_quantizer(tf, base.SEED)
    for sub, div in (("full", 1), ("small", 8)):
        d = os.path.join(OUT_ROOT, sub)
        os.makedirs(d, exist_ok=True)
        for name, (blob, floats, nvars) in build_conv_models(
                tf, div, SEED).items():
            with open(os.path.join(d, f"{name}.tflite"), "wb") as f:
                f.write(blob)
            hist = dict(sorted(op_histogram(blob).items()))
            print(f"{sub}/{name}.tflite: {len(blob)} B, {nvars} state vars, "
                  f"{floats} state floats, ops {hist}")
        with open(os.path.join(d, "quantizer.tflite"), "wb") as f:
            f.write(quant)
        with open(os.path.join(d, "lyra_config.binarypb"), "wb") as f:
            f.write(b"\x08" + base._varint(base.VERSION_MINOR))
    return 0


if __name__ == "__main__":
    sys.exit(main())
