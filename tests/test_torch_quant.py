"""The port's quantized modes vs the JAX package, on the CPU.

The int8 and fakequant executor modes, int8 state storage and fp8 layer
boundaries (lyra_tpu_torch/tflite/executor.py, models/streaming.py), on
inputs made from a numpy seed:

  * the int8 arithmetic helpers, the three integer accumulations (with the
    extreme operands: x = −128 with zp_in = 127, w = −127, at the full
    fixture's widest C_in·K), `_fq` and the state (de)compression: bitwise equal to the JAX package's
    functions run eagerly (jitted, XLA rewrites a division by a constant
    into a multiplication by its reciprocal and fuses `x·r + zp` into one
    FMA; the port computes what the code says, as eager JAX does);
  * whole graphs on the islands fixture (tests/golden/
    synthetic_lyra_islands/small: int8 CONV_2D, DEPTHWISE_CONV_2D,
    TRANSPOSE_CONV, LEAKY_RELU, ADD, QUANTIZE and SPLIT / STRIDED_SLICE of
    int8 tensors) vs the JAX lowering, jitted and vmapped: every int8
    tensor of the environment (int8 mode) and every tensor fakequant
    snaps to the int8 grid bitwise, the output and state within
    GRAPH_BAR × max|ref| (measured on this fixture: ≤ 4.6e-7);
  * B-invariance: a row at B=4 is the stream run alone at B=1;
  * every refusal of the JAX lowering, and the kernel backend's (the JAX
    fused backend's), naming backend="plain";
  * `benchmark --mode fakequant` at B=1 on the plain backend.

The engines in these modes: tests/test_torch_quant_engines.py; fp8
boundaries: tests/test_torch_quant_f8.py.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu.models import streaming as jax_streaming
from lyra_tpu.tflite import executor as jexe
from lyra_tpu.tflite import model as jtfl
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.models import streaming
from lyra_tpu_torch.tflite import executor as texe
from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.tools import benchmark

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ISLANDS = os.path.join(GOLDEN, "synthetic_lyra_islands")
SMALL = os.path.join(ISLANDS, "small")
FULL = os.path.join(ISLANDS, "full")
LYRAGAN = os.path.join(SMALL, "lyragan.tflite")
B, FRAMES = 4, 6
MODELS = {"soundstream_encoder": ((320,), 0.1), "lyragan": ((1, 64), 1.0)}
BF16_BAR = 3e-2  # × max|ref|, as tests/test_torch_bf16.py
# × max|ref|: whole int8 / fakequant graphs' float output and state vs the
# JAX lowering, 10 × the largest reading (4.6e-7; one quantization step of
# the graphs' last int8 tensors is 6.4e-3 and 4.0e-2 × max|ref|).
GRAPH_BAR = 5e-6
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread for the module: tier-1 runs six test
    workers on the machine's cores, and these small ops gain nothing from
    more threads (measured: the same time alone) but lose several times
    over to the others' oversubscription."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(fixture, name):
    """(JAX SubGraphDef, port SubGraphDef) of one model."""
    path = os.path.join(fixture, f"{name}.tflite")
    return jtfl.load(path).subgraphs[0], tfl.load(path).subgraphs[0]


def _ops(sg, kind, int8_out=True):
    return [op for op in sg.ops if op.name == kind and (
        not int8_out or sg.tensors[op.outputs[0]].dtype == np.int8)]


def _int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---- helpers ----------------------------------------------------------------

QM_GRID = [0.0, 2.0 ** -33, 2.0 ** -31.5, 2.0 ** -31, 3e-10, 1e-6, 0.01,
           0.37, 0.5, 0.75, 1.0, 1.5, 3.0, 2.0 ** 29, 2.0 ** 30 * 1.5,
           2.0 ** 31, 1e12] + [(1.0 - 2.0 ** -k) * 2.0 ** e
                               for k in (31, 32, 33, 40) for e in (-5, 0, 3)]


def test_quantize_multiplier_matches_jax():
    """0, underflow below 2^-31, saturation above 2^30, and mantissas that
    round up to 2^31."""
    for m in QM_GRID:
        assert texe._quantize_multiplier(m) == jexe._quantize_multiplier(m), m
    assert texe._quantize_multiplier(1.0 - 2.0 ** -33) == (1 << 30, 1)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("rounding", ["single", "double", "ruy"])
def test_mbqm_is_bitwise_jax(rounding, per_channel):
    """Random int32 accumulators over the whole int32 range and small ones,
    multipliers from random reals (shifts −31 … 30; positive shifts wrap
    `(acc << left) * qmult` in int64 as XLA does)."""
    rng = np.random.default_rng(1)
    acc = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31, (8, 5, 16)),
        rng.integers(-300, 300, (8, 5, 16))]).astype(np.int32)
    ms = np.exp2(rng.uniform(-32, 31, 16)) * rng.uniform(0.5, 1.0, 16)
    pairs = [texe._quantize_multiplier(float(m)) for m in ms]
    if per_channel:
        qm = np.array([p[0] for p in pairs], np.int32)
        sh = np.array([p[1] for p in pairs], np.int32)
        calls = [(qm, sh, torch.from_numpy(qm.astype(np.int64)),
                  torch.from_numpy(sh.astype(np.int64)))]
    else:
        calls = [(q, s, q, s) for q, s in pairs + [(0, 0), ((1 << 31) - 1, 30)]]
    for jq, js, tq, ts in calls:
        got = texe._mbqm(torch.from_numpy(acc), tq, ts, rounding)
        assert got.dtype == torch.int32
        _eq(got, jexe._mbqm(jnp.asarray(acc), jq, js, rounding))


def test_int8_elementwise_helpers_are_bitwise_jax():
    """QUANTIZE (float → int8 and int8 → int8), DEQUANTIZE, LEAKY_RELU and
    ADD on every such op of both graphs, random operands, the fixture's
    quantization parameters."""
    rng = np.random.default_rng(2)
    for name in MODELS:
        jsg, tsg = _both(SMALL, name)
        int8 = [t.index for t in tsg.tensors if t.dtype == np.int8
                and t.quant is not None and t.data is None]
        for op in _ops(tsg, "QUANTIZE"):
            # int8 → int8: onto the next int8 tensor's parameters.
            other = int8[(int8.index(op.outputs[0]) + 1) % len(int8)]
            jt = [jsg.tensors[i] for i in (other, op.outputs[0])]
            tt = [tsg.tensors[i] for i in (other, op.outputs[0])]
            scale, zp = texe._tensor_qparams(tt[1])
            x = rng.normal(0.0, 60 * scale, (B, 7, 16)).astype(np.float32)
            x[0, 0, :4] = (np.arange(4) + 0.5) * scale  # ties
            _eq(texe._int8_quantize(torch.from_numpy(x), torch.tensor(scale),
                                    zp), jexe._int8_quantize(x, jt[1]))
            q = _int8(rng, (B, 7, 16))
            _eq(texe._int8_requantize(torch.from_numpy(q),
                                      *texe._requantize_params(tt[1], tt[0])),
                jexe._int8_requantize(q, jt[1], jt[0]))
            _eq(texe._int8_dequantize(torch.from_numpy(q), torch.tensor(scale),
                                      zp), jexe._int8_dequantize(q, jt[1]))
        for op in _ops(tsg, "LEAKY_RELU"):
            t_in, t_out = (tsg.tensors[i] for i in (op.inputs[0],
                                                     op.outputs[0]))
            q = _int8(rng, (B, 9, 16))
            alpha = op.options["alpha"]
            _eq(texe._int8_leaky_relu(torch.from_numpy(q), *texe._leaky_params(
                alpha, t_in, t_out)), jexe._int8_leaky_relu(
                    q, alpha, jsg.tensors[op.inputs[0]],
                    jsg.tensors[op.outputs[0]]))
        for op in _ops(tsg, "ADD"):
            a, b = _int8(rng, (B, 9, 16)), _int8(rng, (B, 9, 16))
            params = texe._add_params(*(tsg.tensors[i] for i in (
                *op.inputs, op.outputs[0])))
            _eq(texe._int8_add(torch.from_numpy(a), torch.from_numpy(b),
                               *params),
                jexe._int8_add(a, b, *(jsg.tensors[i] for i in (
                    *op.inputs, op.outputs[0]))))


def _conv_case(tsg, op, rng, batch, extreme=False):
    """(x int8 NHWC, raw weights) of an int8 conv op at its graph shapes;
    `extreme`: x = −128 everywhere, w = −127."""
    x_i = op.inputs[2 if op.name == "TRANSPOSE_CONV" else 0]
    shape = (batch,) + tuple(tsg.tensors[x_i].shape[1:])
    w = tsg.tensors[op.inputs[1]].data
    if extreme:
        return np.full(shape, -128, np.int8), np.full_like(w, -127)
    return _int8(rng, shape), w


def _accumulate(op, x, w, jt_in, zp_in):
    """The op's integer accumulation in both packages: (port, JAX)."""
    opts = op.options
    w64 = torch.from_numpy(w.astype(np.float64))
    if op.name == "TRANSPOSE_CONV":
        got = texe._int8_transpose_conv_acc(
            torch.from_numpy(x), w64.permute(3, 0, 1, 2), zp_in,
            (opts["stride_h"], opts["stride_w"]))
        return got, jexe._int8_transpose_conv_acc(jnp.asarray(x), w, opts,
                                                  jt_in)
    stride = (opts["stride_h"], opts["stride_w"])
    dil = (opts.get("dilation_h", 1), opts.get("dilation_w", 1))
    if op.name == "DEPTHWISE_CONV_2D":
        got = texe._int8_conv_acc(torch.from_numpy(x),
                                  w64.permute(3, 0, 1, 2), zp_in, stride,
                                  dil, x.shape[-1])
        return got, jexe._int8_depthwise_acc(jnp.asarray(x), w, opts, jt_in)
    got = texe._int8_conv_acc(torch.from_numpy(x), w64.permute(0, 3, 1, 2),
                              zp_in, stride, dil, x.shape[-1] // w.shape[-1])
    return got, jexe._int8_conv_acc(jnp.asarray(x), w, opts,
                                    (x.shape[-1], w.shape[-1]), jt_in)


def _with_zp(t, zp):
    return dataclasses.replace(t, quant=dataclasses.replace(
        t.quant, zero_point=np.array([zp], np.int64)))


@pytest.mark.parametrize("fixture", ["small", "full"])
def test_int8_accumulations_and_epilogue_are_bitwise_jax(fixture):
    """Every int8 conv op's accumulation on random operands at B=2 (the
    small fixture: all of them; the full fixture: the widest C_in·K of each
    kind — SoundStream's CONV_2D 4 × 128, LyraGAN's output TRANSPOSE_CONV
    52 × 64 — also with x = −128, zp_in = 127, w = −127), then
    `_int8_conv_out` (bias, per-channel requantization) on it."""
    rng = np.random.default_rng(3)
    seen = set()
    for name in MODELS:
        jsg, tsg = _both(SMALL if fixture == "small" else FULL, name)
        ops = [op for kind in texe._CONVS for op in _ops(tsg, kind)]
        if fixture == "small":  # the first and the last of each kind
            ops = [op for kind in texe._CONVS
                   for op in {id(o): o for o in _ops(tsg, kind)[::-1][:1]
                              + _ops(tsg, kind)[:1]}.values()]
        else:
            ops = [max((op for op in ops if op.name == kind), default=None,
                       key=lambda op: np.prod(tsg.tensors[op.inputs[1]]
                                              .shape[1:]))
                   for kind in texe._CONVS]
        for op in filter(None, ops):
            seen.add(op.name)
            x_i = op.inputs[2 if op.name == "TRANSPOSE_CONV" else 0]
            for extreme in ((False, True) if fixture == "full" else (False,)):
                x, w = _conv_case(tsg, op, rng, 2, extreme)
                jt_in = jsg.tensors[x_i]
                zp_in = texe._tensor_qparams(tsg.tensors[x_i])[1]
                if extreme:
                    jt_in, zp_in = _with_zp(jt_in, 127), 127
                got, want = _accumulate(op, x, w, jt_in, zp_in)
                assert got.dtype == torch.int64
                _eq(got, want)
                if extreme:
                    k = np.prod(w.shape[1:-1]) if op.name == "CONV_2D" else \
                        -(-w.shape[1] // op.options["stride_h"])
                    assert int(got.max()) == 255 * 127 * k * w.shape[-1] \
                        or op.name != "CONV_2D"
                    continue
                nb = 3 if op.name == "TRANSPOSE_CONV" else 2
                bias_t = tsg.tensors[op.inputs[nb]] if len(op.inputs) > nb \
                    else None
                t_w, t_out = tsg.tensors[op.inputs[1]], tsg.tensors[
                    op.outputs[0]]
                qm, sh = texe._per_channel_requant_params(
                    tsg.tensors[x_i], t_w, t_out, t_out.shape[-1])
                out = texe._int8_conv_out(
                    got, None if bias_t is None else torch.from_numpy(
                        bias_t.data.astype(np.int64)),
                    torch.from_numpy(qm.astype(np.int64)),
                    torch.from_numpy(sh.astype(np.int64)),
                    texe._tensor_qparams(t_out)[1], op.name, w.shape[-1])
                # Jitted (integer ops only: XLA keeps their values).
                _eq(out, jax.jit(partial(
                    jexe._int8_conv_out,
                    bias=None if bias_t is None else bias_t.data,
                    t_in=jsg.tensors[x_i], t_w=jsg.tensors[op.inputs[1]],
                    t_out=jsg.tensors[op.outputs[0]], kind=op.name))(want))
    assert seen == set(texe._CONVS)


def test_fq_is_bitwise_jax():
    rng = np.random.default_rng(4)
    for name in MODELS:
        jsg, tsg = _both(SMALL, name)
        for t in tsg.tensors:
            p = texe._fq_params(t)
            if p is None or t.data is not None:
                continue
            x = rng.normal(0.0, 80 * p[0], (B, 11, 16)).astype(np.float32)
            x[0, 0, :4] = (np.arange(4) + 0.5 - p[1]) * p[0]  # ties
            _eq(texe._fq(torch.from_numpy(x), torch.tensor(p[0]), p[1]),
                jexe._fq(jnp.asarray(x), jsg.tensors[t.index]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_leaf_compression_is_bitwise_jax(dtype):
    """`_quantize_leaf` / `_dequantize_leaf` on a [B, 3, 1, 40] buffer with
    a silent row (scale 1, q 0) and an amax tie."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 3.0, (B, 3, 1, 40)).astype(np.float32)
    x[1] = 0.0
    x[2, 0, 0, :2] = [5.0, -5.0]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got, want = streaming._quantize_leaf(tx), jax_streaming._quantize_leaf(jx)
    for k in ("q", "s"):
        assert got[k].dtype == {"q": torch.int8, "s": torch.float32}[k]
        _eq(got[k], want[k])
    back = streaming._dequantize_leaf(got, tx.dtype)
    jback = jax_streaming._dequantize_leaf(want, jx.dtype)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback, np.float32))


# ---- whole graphs -----------------------------------------------------------

def _frames(name, seed=0, b=B, frames=FRAMES):
    shape, scale = MODELS[name]
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, (frames, b) + shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["int8", "fakequant"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_matches_jax_lowering(name, mode):
    """FRAMES hops at B=4, each package with its own state: every int8
    tensor of the environment (int8 mode) and every float tensor that
    fakequant snaps to the int8 grid bitwise, the output and the state
    within GRAPH_BAR × max|ref|."""
    path = os.path.join(SMALL, f"{name}.tflite")
    jg = jexe.GraphLowering(jtfl.load(path), "serving_default",
                            mode=mode).lower(capture_env=True)
    step = jax.jit(jax.vmap(lambda st, x: jg(st, input_audio=x)))
    js = {k: jnp.broadcast_to(v, (B,) + v.shape)
          for k, v in jg.init_state().items()}
    tg = texe.load_graph(path, mode=mode, **CPU)
    fn = tg.lower(capture_env=True)
    ts = tg.init_state(B)
    snapped = {tg.sg.ops[i].outputs[0] for i in tg._fq}
    assert bool(snapped) == (mode == "fakequant")
    n_int8 = n_snapped = 0
    for x in _frames(name):
        jo, js, jenv = step(js, jnp.asarray(x[:, None]))
        to, ts, tenv = fn(ts, input_audio=torch.from_numpy(x))
        for i, v in jenv.items():
            v = np.asarray(v)
            if v.dtype == np.int8 or i in snapped:
                assert tenv[i].dtype == getattr(torch, v.dtype.name), i
                np.testing.assert_array_equal(
                    tenv[i].numpy(), v.reshape(tenv[i].shape), err_msg=str(i))
                n_int8 += v.dtype == np.int8
                n_snapped += i in snapped
        y = np.asarray(jo["output_0"]).reshape(B, -1)
        assert np.abs(to["output_0"].numpy().reshape(B, -1) - y).max() <= \
            GRAPH_BAR * np.abs(y).max()
    assert (n_int8 > 0) == (mode == "int8")
    assert n_snapped == len(snapped) * FRAMES
    for k, v in js.items():
        v = np.asarray(v)
        np.testing.assert_allclose(ts[k].numpy(), v, rtol=0,
                                   atol=GRAPH_BAR * np.abs(v).max())


@pytest.mark.parametrize("mode", ["int8", "fakequant"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_rows_at_b4_equal_streams_run_alone(name, mode):
    """As tests/test_tflite_executor.py's int8 vmap check: each row of a
    B=4 run is the same stream run at B=1 — every int8 tensor bit for bit
    (integer arithmetic is batch-invariant), the float tensors, output and
    state within 1e-5 × max|row| (torch's CPU convs sum in an order that
    depends on the batch: measured ≤ 5e-5 absolute)."""
    tg = texe.load_graph(os.path.join(SMALL, f"{name}.tflite"), mode=mode,
                         **CPU)
    fn = tg.lower(capture_env=True)
    frames = _frames(name, seed=6, frames=4)
    st, envs = tg.init_state(B), []
    for x in frames:
        _, st, env = fn(st, input_audio=torch.from_numpy(x))
        envs.append(env)
    for b in range(B):
        s1 = tg.init_state(1)
        for t, x in enumerate(frames):
            _, s1, env = fn(s1, input_audio=torch.from_numpy(x[b:b + 1]))
            for i, v in env.items():
                want = envs[t][i][b]
                if v.dtype == torch.int8:
                    assert torch.equal(v[0], want), (b, t, i)
                else:
                    assert (v[0] - want).abs().max() <= 1e-5 * max(
                        want.abs().max(), 1.0), (b, t, i)
        for k in st:
            assert (s1[k][0] - st[k][b]).abs().max() <= 1e-5 * max(
                st[k][b].abs().max(), 1.0), k


# ---- refusals ---------------------------------------------------------------

def _mutated(path, edit):
    """(JAX ModelDef, port ModelDef) of `path` after `edit(mdef)`."""
    out = []
    for mod in (jtfl, tfl):
        mdef = mod.load(path)
        edit(mdef.subgraphs[0])
        out.append(mdef)
    return out


def _first(sg, name, int8_out=True):
    return _ops(sg, name, int8_out)[0]


def _float_out(sg):  # an int8 conv read as a float op: hybrid quantization
    op = _first(sg, "CONV_2D")
    sg.tensors[op.outputs[0]] = dataclasses.replace(
        sg.tensors[op.outputs[0]], dtype=np.float32)


def _relu(sg):
    _first(sg, "CONV_2D").options["activation"] = "RELU"


def _add_to(kind):
    def edit(sg):
        _first(sg, "ADD").name = kind
    return edit


def _concat_qparams(sg):  # an int8 concatenation of differing qparams
    split = _first(sg, "SPLIT")
    tcv = next(op for op in sg.ops if split.outputs[0] in op.inputs)
    tcv.name, tcv.inputs = "CONCATENATION", list(split.outputs)
    tcv.options = {"axis": 3}
    t = sg.tensors[split.outputs[1]]
    sg.tensors[t.index] = dataclasses.replace(t, quant=dataclasses.replace(
        t.quant, scale=t.quant.scale * 2))


def _tconv_shape(sg):
    op = _first(sg, "TRANSPOSE_CONV")
    t = sg.tensors[op.inputs[0]]
    data = t.data.copy()
    data[1] += 1
    sg.tensors[t.index] = dataclasses.replace(t, data=data)


@pytest.mark.parametrize("edit,model", [
    (_float_out, "soundstream_encoder"), (_relu, "soundstream_encoder"),
    (_add_to("SUB"), "lyragan"), (_add_to("MUL"), "lyragan"),
    (_add_to("DIV"), "lyragan"), (_concat_qparams, "lyragan"),
    (_tconv_shape, "lyragan")],
    ids=["hybrid", "fused-relu", "sub", "mul", "div", "concat-qparams",
         "tconv-shape"])
def test_int8_graph_refusals_match_jax(edit, model):
    """What the JAX int8 lowering refuses at trace time, the port refuses
    when the graph is built, with the same exception class."""
    jm, tm = _mutated(os.path.join(SMALL, f"{model}.tflite"), edit)
    g = jexe.GraphLowering(jm, "serving_default", mode="int8").lower()
    x = np.zeros((1,) + MODELS[model][0], np.float32)
    with pytest.raises(NotImplementedError) as jerr:  # at trace time
        jax.eval_shape(lambda st: g(st, input_audio=x), g.init_state())
    with pytest.raises(NotImplementedError) as terr:
        texe.GraphFn(tm, mode="int8", **CPU)
    assert str(terr.value).split()[:2] == str(jerr.value).split()[:2]



@pytest.mark.parametrize("kwargs", [
    {"mode": "int8", "boundary_store": "f8"},
    {"mode": "fakequant", "boundary_store": "f8"},
    {"boundary_store": "int4"}, {"boundary_store": "f8",
                                 "boundary_scale": 0.3},
    {"boundary_store": "f8", "boundary_scale": -2.0}, {"mode": "int4"}])
def test_load_graph_refusals_match_jax(kwargs):
    with pytest.raises(ValueError):
        jexe.load_graph(LYRAGAN, **kwargs)
    with pytest.raises(ValueError):
        texe.load_graph(LYRAGAN, **kwargs, **CPU)


def test_int8_computes_its_float_ops_in_float32():
    """The JAX lowering refuses int8 with another compute dtype; the port's
    mode sets the dtype, float32 for int8 (and fakequant)."""
    with pytest.raises(ValueError, match="float32"):
        jexe.GraphLowering(jtfl.load(LYRAGAN), "serving_default",
                           mode="int8", compute_dtype=jnp.bfloat16)
    for mode in ("int8", "fakequant"):
        g = texe.load_graph(LYRAGAN, mode=mode, **CPU)
        assert g.dtype == torch.float32
        assert all(v.dtype == torch.float32 for v in g.init_state(1).values()
                   if v.is_floating_point())


@pytest.mark.parametrize("kw,pinned", [
    ({}, False), ({"mode": "bf16"}, False), ({"mode": "int8"}, True),
    ({"mode": "fakequant"}, True), ({"state_dtype": "int8"}, True),
    ({"mode": "bf16", "state_dtype": "int8"}, True),
    ({"boundary_store": "f8"}, True)])
def test_plain_lowering_pins_the_configurations_it_alone_serves(kw, pinned):
    """The configurations only the plain lowering serves pin its convs
    (cuDNN deterministic, no TF32: GraphFn._pinned); the float and bf16
    plain reference keeps cuDNN's choice."""
    model = streaming.LyraGanModel(SMALL, backend="plain", **kw, **CPU)
    assert model._run._graph.pinned is pinned


@pytest.mark.parametrize("kw", [
    {"mode": "int8"}, {"mode": "fakequant"}, {"state_compression": "int8"},
    {"boundary_store": "f8"}, {"state_compression": "int4"}])
def test_kernel_backend_and_bad_options_are_refused(kw):
    """The kernel backend (the JAX "fused") refuses the four, naming
    backend="plain"; a bad state_compression is refused on both."""
    bad = kw.get("state_compression") == "int4"
    for engine in (EncoderEngine, DecoderEngine):
        for backend in (("plain", "kernel") if bad else ("kernel", "fused")):
            with pytest.raises(ValueError, match=None if bad else
                               'backend="plain"'):
                engine(16000, SMALL, backend=backend, **kw, **CPU)
    if not bad and "mode" in kw:
        with pytest.raises(ValueError, match='backend="plain"'):
            streaming.FusedStack(LYRAGAN, mode=kw["mode"], **CPU)
    jkw = {"state_dtype" if k == "state_compression" else k: v
           for k, v in kw.items()}
    with pytest.raises(ValueError):
        jax_streaming.LyraGanModel(SMALL, backend="xla" if bad else "fused",
                                   **jkw)


def test_benchmark_fakequant_runs_on_the_plain_backend(capsys):
    assert benchmark.main(["--mode=fakequant", "--num_cond_vectors=2",
                           "--batch=1", f"--model_path={SMALL}"], **CPU) == 0
    out = capsys.readouterr().out
    assert "backend plain" in out and "model_decode" in out
