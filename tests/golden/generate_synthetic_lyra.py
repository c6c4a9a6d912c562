"""Write weight-free synthetic Lyra v2 model directories (random weights).

The shipped Lyra weights are not vendored in this repository, and the model
architecture lives only inside those flatbuffers.  This script builds
stand-in graphs with the published shapes (SURVEY.md §2.1) in TensorFlow and
converts them with TFLite's own converter, so they carry the shipped models'
op vocabulary: CALL_ONCE / VAR_HANDLE / READ_VARIABLE / ASSIGN_VARIABLE
streaming state, CONCATENATION + STRIDED_SLICE context splicing, CONV_2D
(temporal, strided, grouped), DEPTHWISE_CONV_2D at dilations 1/3/9,
TRANSPOSE_CONV with stride dividing the kernel, SPLIT, ADD/SUB and
LEAKY_RELU as a separate op (no fused activations).

  full/   published widths.  SoundStream-like: [1,320] -> [1,1,64],
          14 state variables / 13,808 floats, ladder 1->64->128->256->512.
          LyraGAN-like: [1,1,64] -> [1,320], 18 state variables /
          12,912 floats, ladder 64->256->128->64->1.
  small/  same topology, internal channels divided by 8 (the model I/O
          stays 64 features / 320 samples so the RVQ and engines are
          unchanged).  This is the CPU test fixture.

Both hold quantizer.tflite (random 46x16x64 codebooks; `encode` and
`decode` signatures) and lyra_config.binarypb carrying the identifier the
codec checks (lyra_tpu.config.VERSION_MINOR).

Weights are random from a fixed seed.  Regenerate (needs TensorFlow):

    python tests/golden/generate_synthetic_lyra.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_ROOT = os.path.join(HERE, "synthetic_lyra")
SEED = 20261016
ALPHA = 0.2  # LEAKY_RELU slope
HOP = 320
NUM_FEATURES = 64
NUM_STAGES = 46
NUM_CODES = 16
VERSION_MINOR = 3  # lyra_tpu.config.VERSION_MINOR (kept literal: no jax here)

# Residual unit dilations: K=3 depthwise convs need (K-1)*d frames of context.
DILATIONS = (1, 3, 9)


def _tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import tensorflow as tf

    return tf


class _Params:
    """Random weights drawn in a fixed order from one generator."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def conv(self, k: int, cin_per_group: int, cout: int, gain: float = 1.0):
        std = gain * np.sqrt(2.0 / (k * cin_per_group))
        w = self.rng.normal(0.0, std, (k, 1, cin_per_group, cout))
        b = self.rng.normal(0.0, 0.02, (cout,))
        return w.astype(np.float32), b.astype(np.float32)

    def depthwise(self, k: int, c: int):
        w = self.rng.normal(0.0, np.sqrt(1.0 / k), (k, 1, c, 1))
        b = self.rng.normal(0.0, 0.02, (c,))
        return w.astype(np.float32), b.astype(np.float32)

    def tconv(self, k: int, cin: int, cout: int, stride: int,
              gain: float = 1.0):
        # Each output sample sees k/stride taps of cin channels.
        std = gain * np.sqrt(2.0 / (cin * (k // stride)))
        w = self.rng.normal(0.0, std, (k, 1, cout, cin))
        b = self.rng.normal(0.0, 0.02, (cout,))
        return w.astype(np.float32), b.astype(np.float32)


class _Net:
    """A streaming conv net as a list of layers over [1, T, 1, C] tensors.

    `forward(tf, x, read, write)` runs one hop; `read(name)` returns the
    current value of a state variable and `write(name, value)` assigns it.
    Building the layer list also records every state shape.
    """

    def __init__(self):
        self.states = {}  # name -> shape
        self.layers = []
        self.out_weights = None  # (w, b) of the output layer

    def state(self, name, shape):
        self.states[name] = tuple(shape)
        return name


def _leaky(tf, x):
    return tf.nn.leaky_relu(x, alpha=ALPHA)


def _conv(tf, x, w, b, stride=1):
    y = tf.nn.conv2d(x, tf.constant(w), strides=[1, stride, 1, 1],
                     padding="VALID")
    return tf.nn.bias_add(y, tf.constant(b))


def _depthwise(tf, x, w, b, dilation):
    y = tf.raw_ops.DepthwiseConv2dNative(
        input=x, filter=tf.constant(w), strides=[1, 1, 1, 1],
        padding="VALID", dilations=[1, dilation, 1, 1])
    return tf.nn.bias_add(y, tf.constant(b))


def _tconv(tf, x, w, b, stride, t_out):
    cout = w.shape[2]
    y = tf.nn.conv2d_transpose(
        x, tf.constant(w), output_shape=[1, t_out, 1, cout],
        strides=[1, stride, 1, 1], padding="VALID")
    return tf.nn.bias_add(y, tf.constant(b))


def _context(tf, x, name, ctx, read, write):
    """Prepend the saved left context, save the new tail."""
    xc = tf.concat([read(name), x], axis=1)
    write(name, xc[:, xc.shape[1] - ctx:])
    return xc


def _residual_unit(net, p, c, d, prefix):
    """Depthwise-separable dilated residual unit (2 CONV_2D, 1 DEPTHWISE)."""
    name = net.state(f"{prefix}_d{d}", (1, 2 * d, 1, c))
    dw = p.depthwise(3, c)
    pw1 = p.conv(1, c, c)
    groups = 4
    pw2 = p.conv(1, c // groups, c, gain=0.5)

    def f(tf, x, read, write):
        xc = _context(tf, x, name, 2 * d, read, write)
        h = _leaky(tf, _depthwise(tf, xc, *dw, dilation=d))
        h = _leaky(tf, _conv(tf, h, *pw1))
        h = _conv(tf, h, *pw2)
        return x + h

    return f


def build_encoder(p: _Params, div: int) -> _Net:
    """SoundStream-like encoder: 320 samples -> 64 features."""
    net = _Net()
    c64, c128, c256, c512 = 64 // div, 128 // div, 256 // div, 512 // div
    layers = net.layers

    # Audio edge: 48-sample input context, K=56 stride-8 conv to 64 ch.
    in_ctx = net.state("enc_in", (1, 48, 1, 1))
    w_in = p.conv(56, 1, c64)

    def first(tf, x, read, write):
        xc = _context(tf, tf.reshape(x, [1, HOP, 1, 1]), in_ctx, 48,
                      read, write)
        return _leaky(tf, _conv(tf, xc, *w_in, stride=8))  # T=40
    layers.append(first)

    def stage(c, cout, k, stride, idx, final=False):
        for d in DILATIONS:
            layers.append(_residual_unit(net, p, c, d, f"enc{idx}"))
        ctx = k - stride
        name = net.state(f"enc{idx}_down", (1, ctx, 1, c))
        w = p.conv(k, c, cout, gain=0.5 if final else 1.0)

        def down(tf, x, read, write):
            xc = _context(tf, x, name, ctx, read, write)
            y = _conv(tf, xc, *w, stride=stride)
            return y if final else _leaky(tf, y)
        layers.append(down)

    stage(c64, c128, 10, 5, 0)     # T 40 -> 8
    stage(c128, c256, 4, 2, 1)     # T 8 -> 4
    stage(c256, c512, 4, 2, 2)     # T 4 -> 2
    # Last transition (no residual units): 512 -> 64 features, T 2 -> 1.
    name = net.state("enc3_down", (1, 2, 1, c512))
    w_out = net.out_weights = p.conv(4, c512, NUM_FEATURES, gain=0.5)

    def last(tf, x, read, write):
        xc = _context(tf, x, name, 2, read, write)
        return tf.reshape(_conv(tf, xc, *w_out, stride=2),
                          [1, 1, NUM_FEATURES])
    layers.append(last)
    return net


def build_gan(p: _Params, div: int) -> _Net:
    """LyraGAN-like decoder: 64 features -> 320 samples."""
    net = _Net()
    c256, c128, c64 = 256 // div, 128 // div, 64 // div
    layers = net.layers

    # Conditioning conv 64 -> 256 (K=3 causal, T=1).
    in_ctx = net.state("gan_in", (1, 2, 1, NUM_FEATURES))
    w_in = p.conv(3, NUM_FEATURES, c256)

    def first(tf, x, read, write):
        xc = _context(tf, tf.reshape(x, [1, 1, 1, NUM_FEATURES]), in_ctx, 2,
                      read, write)
        return _leaky(tf, _conv(tf, xc, *w_in))
    layers.append(first)

    def up(cin, cout, stride, idx, split=None):
        """Streaming transpose conv (K = 2*stride) on one frame of input
        context; `split` runs it as two half-channel transpose convs whose
        outputs are added or subtracted."""
        name = net.state(f"gan_up{idx}", (1, 1, 1, cin))
        k = 2 * stride
        if split is None:
            ws = [p.tconv(k, cin, cout, stride)]
        else:
            ws = [p.tconv(k, cin // 2, cout, stride) for _ in range(2)]

        def f(tf, x, read, write):
            t = x.shape[1]
            xc = _context(tf, x, name, 1, read, write)
            t_full = t * stride + k
            parts = [xc] if split is None else tf.split(xc, 2, axis=3)
            ys = [_tconv(tf, xp, *w, stride=stride, t_out=t_full)
                  for xp, w in zip(parts, ws)]
            y = ys[0] if split is None else (
                ys[0] + ys[1] if split == "add" else ys[0] - ys[1])
            return _leaky(tf, y[:, stride:stride + t * stride])
        layers.append(f)

    def res(c, idx):
        for d in DILATIONS:
            layers.append(_residual_unit(net, p, c, d, f"gan{idx}"))

    def causal_conv(c, k, idx):
        name = net.state(f"gan_conv{idx}", (1, k - 1, 1, c))
        w = p.conv(k, c, c)

        def f(tf, x, read, write):
            xc = _context(tf, x, name, k - 1, read, write)
            return _leaky(tf, _conv(tf, xc, *w))
        layers.append(f)

    res(c256, 0)                          # T=1
    up(c256, c128, 2, 0, split="add")     # T 1 -> 2
    causal_conv(c128, 3, 0)
    res(c128, 1)
    up(c128, c64, 2, 1, split="sub")      # T 2 -> 4
    res(c64, 2)
    up(c64, c64, 2, 2)                    # T 4 -> 8
    up(c64, c64, 5, 3)                    # T 8 -> 40
    up(c64, c64, 2, 4)                    # T 40 -> 80
    causal_conv(c64, 5, 1)

    # Audio edge: 64 -> 1 transpose conv, K=52 stride 4, overlap-add of the
    # 48-sample tail into the next hop.
    ola = net.state("gan_out", (1, 48, 1, 1))
    w_out = net.out_weights = p.tconv(52, c64, 1, 4, gain=0.25)

    def last(tf, x, read, write):
        y = _tconv(tf, x, *w_out, stride=4, t_out=HOP + 48)  # [1,368,1,1]
        head = y[:, :48] + read(ola)
        write(ola, y[:, HOP:])
        out = tf.concat([head, y[:, 48:HOP]], axis=1)
        return tf.reshape(out, [1, HOP])
    layers.append(last)
    return net


def _module(tf, net: _Net, in_shape):
    class M(tf.Module):
        def __init__(self):
            super().__init__()
            self.vars = {k: tf.Variable(tf.zeros(s), name=k)
                         for k, s in net.states.items()}

        @tf.function(input_signature=[
            tf.TensorSpec(in_shape, tf.float32, name="input_audio")])
        def __call__(self, input_audio):
            return self.run(input_audio)

        def run(self, x):
            reads = {k: v.read_value() for k, v in self.vars.items()}
            writes = {}

            def read(name):
                return reads[name]

            def write(name, value):
                writes[name] = value

            for layer in net.layers:
                x = layer(tf, x, read, write)
            for k, v in writes.items():
                self.vars[k].assign(v)
            return x

    return M()


def _convert(tf, module) -> bytes:
    cf = module.__call__.get_concrete_function()
    conv = tf.lite.TFLiteConverter.from_concrete_functions([cf], module)
    conv.experimental_enable_resource_variables = True
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS]
    return conv.convert()


def _calibrate(tf, module, in_shape, rng, hops=8):
    """RMS of the eager output over a few hops of random input."""
    outs = []
    for _ in range(hops):
        x = rng.normal(0.0, 0.1 if in_shape[-1] == HOP else 1.0, in_shape)
        outs.append(module.run(tf.constant(x.astype(np.float32))).numpy())
    for v in module.vars.values():
        v.assign(tf.zeros_like(v))
    return float(np.sqrt(np.mean(np.square(np.stack(outs)))))


def build_conv_models(tf, div: int, seed: int):
    """(encoder flatbuffer, gan flatbuffer, state float counts)."""
    out = {}
    for name, build, in_shape, target_rms in (
            ("soundstream_encoder", build_encoder, [1, HOP], 1.0),
            ("lyragan", build_gan, [1, 1, NUM_FEATURES], 0.1)):
        rng = np.random.default_rng(seed + (0 if name == "lyragan" else 1))
        # Two passes: draw, measure the output RMS, then redraw the same
        # weights with the last layer rescaled to a speech-like level.
        net = build(_Params(np.random.default_rng(rng.integers(1 << 31))),
                    div)
        rms = _calibrate(tf, _module(tf, net, in_shape), in_shape,
                         np.random.default_rng(seed))
        scale = target_rms / max(rms, 1e-6)
        module = _module(tf, net, in_shape)
        for a in net.out_weights:
            a *= scale
        out[name] = (_convert(tf, module),
                     sum(int(np.prod(s)) for s in net.states.values()),
                     len(net.states))
    return out


def build_quantizer(tf, seed: int) -> bytes:
    rng = np.random.default_rng(seed + 2)
    # Coarse-to-fine residual codebooks: each stage's spread shrinks.
    cbs = np.stack([
        rng.normal(0.0, 0.8 * 0.92 ** s, (NUM_CODES, NUM_FEATURES))
        for s in range(NUM_STAGES)]).astype(np.float32)

    class Q(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([1, 1, NUM_FEATURES], tf.float32,
                          name="input_frames"),
            tf.TensorSpec([], tf.int32, name="num_quantizers")])
        def encode(self, input_frames, num_quantizers):
            r = tf.reshape(input_frames, [1, NUM_FEATURES])
            idxs = []
            for s in range(NUM_STAGES):
                cb = tf.constant(cbs[s])
                d = tf.reduce_sum(tf.math.squared_difference(r, cb), axis=-1)
                i = tf.cast(tf.argmin(d, axis=-1), tf.int32)  # []
                r = r - tf.gather(cb, i)
                idxs.append(i)
            idx = tf.stack(idxs)  # [46]
            keep = tf.range(NUM_STAGES) < num_quantizers
            idx = tf.where(keep, idx, -tf.ones_like(idx))
            return {"output_0": tf.reshape(idx, [NUM_STAGES, 1, 1]),
                    "output_1": tf.constant(4, tf.int32)}

        @tf.function(input_signature=[
            tf.TensorSpec([NUM_STAGES, 1, 1], tf.int32,
                          name="encoding_indices")])
        def decode(self, encoding_indices):
            idx = tf.reshape(encoding_indices, [NUM_STAGES])
            acc = tf.zeros([1, NUM_FEATURES])
            for s in range(NUM_STAGES):
                i = idx[s]
                used = tf.cast(tf.not_equal(i, -1), tf.float32)
                row = tf.gather(tf.constant(cbs[s]), tf.maximum(i, 0))
                acc = acc + used * row[None, :]
            return {"output_0": tf.reshape(acc, [1, 1, NUM_FEATURES])}

    q = Q()
    with tempfile.TemporaryDirectory() as d:
        tf.saved_model.save(q, d, signatures={
            "encode": q.encode.get_concrete_function(),
            "decode": q.decode.get_concrete_function()})
        conv = tf.lite.TFLiteConverter.from_saved_model(
            d, signature_keys=["encode", "decode"])
        conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS]
        return conv.convert()


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def main(argv=None) -> int:
    tf = _tf()
    tf.random.set_seed(SEED)
    quant = build_quantizer(tf, SEED)
    for sub, div in (("full", 1), ("small", 8)):
        d = os.path.join(OUT_ROOT, sub)
        os.makedirs(d, exist_ok=True)
        models = build_conv_models(tf, div, SEED)
        for name, (blob, floats, nvars) in models.items():
            with open(os.path.join(d, f"{name}.tflite"), "wb") as f:
                f.write(blob)
            print(f"{sub}/{name}.tflite: {len(blob)} B, {nvars} state "
                  f"vars, {floats} state floats")
        with open(os.path.join(d, "quantizer.tflite"), "wb") as f:
            f.write(quant)
        with open(os.path.join(d, "lyra_config.binarypb"), "wb") as f:
            f.write(b"\x08" + _varint(VERSION_MINOR))  # field 1, varint
        print(f"{sub}/quantizer.tflite: {len(quant)} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
