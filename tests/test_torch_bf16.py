"""The port's bf16 mode vs the JAX package's, on the small fixture.

bf16 rounds at other places in the two packages (the JAX XLA lowering
rounds each conv result and then its bias add; the Pallas kernel and the
port's kernels round once after an f32 sum), so whole-model bars are
relative to the float32 output: 3e-2 × max|f32 output| (measured on this
fixture: the JAX bf16 paths deviate from f32 by 0.6-1.8 % and from each
other by up to 2.1 %).  Discrete decisions are compared from identical
inputs: each engine stage starts from the JAX pre-tick state.

  (a) executor, mode="bf16", vs JAX `load_graph(mode="bf16")`, one hop at a
      time from the JAX bf16 state, 5 hops, both graphs; state trees of
      the JAX dtypes and shapes;
  (b) FusedStack(mode="bf16") vs the JAX Pallas kernel in bf16
      (interpret mode), 5 hops from the initial state;
  (c) the bf16 plain conv versions vs an f32 computation on bf16-rounded
      operands: within one bf16 rounding (2⁻⁸ relative);
  (d) `decode(dtype=bf16)` vs JAX `decode(dtype=bfloat16)`: 1e-6 × max;
  (e) a bf16 state tree through utils/state.py and back: bitwise;
  (f) bf16 engines vs the JAX bf16 engines, stage by stage.
"""

import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lyra_tpu.codec.engine import DecoderEngine as JaxDecoder
from lyra_tpu.codec.engine import EncoderEngine as JaxEncoder
from lyra_tpu.dsp import utils as jax_dsp_utils
from lyra_tpu.models.rvq import ResidualVectorQuantizer as JaxRvq
from lyra_tpu.ops.fused_stack import FusedStackKernel
from lyra_tpu.tflite.executor import load_graph as jax_load_graph
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.dsp import utils as dsp_utils
from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer, extract_codebooks
from lyra_tpu_torch.ops import conv_stack
from lyra_tpu_torch.ops.fused_stack import FusedStack
from lyra_tpu_torch.tflite.executor import load_graph
from lyra_tpu_torch.utils.state import state_from_numpy, state_to_numpy

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
B, HOPS, REL_BAR = 4, 5, 3e-2
BF16_ROUNDING = 2.0 ** -8  # unit roundoff of bfloat16 (8-bit significand)
MODELS = {"soundstream_encoder": ((320,), 0.1), "lyragan": ((1, 64), 1.0)}


def _inputs(name, seed=0):
    shape, scale = MODELS[name]
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, (HOPS, B) + shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_graph_run(name, mode):
    """JAX executor over HOPS hops: per hop (pre-state, output)."""
    g = jax_load_graph(os.path.join(SMALL, f"{name}.tflite"), mode=mode)
    step = jax.jit(jax.vmap(lambda st, x: g(st, input_audio=x)))
    st = {k: jnp.broadcast_to(v, (B,) + v.shape)
          for k, v in g.init_state().items()}
    hops = []
    for x in _inputs(name):
        pre = jax.tree.map(np.asarray, st)
        o, st = step(st, jnp.asarray(x[:, None]))
        hops.append((pre, np.asarray(o["output_0"]).reshape(B, -1)))
    return hops, jax.tree.map(np.asarray, st)


def _dtypes(tree):
    return {k: (tuple(np.shape(v)), np.asarray(v).dtype.name)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_executor_bf16_matches_jax_per_hop(name):
    ref16, end16 = _jax_graph_run(name, "bf16")
    ref32, _ = _jax_graph_run(name, "float")
    g = load_graph(os.path.join(SMALL, f"{name}.tflite"), mode="bf16",
                   device="cpu")
    assert _dtypes(state_to_numpy(g.init_state(B))) == _dtypes(ref16[0][0])
    assert any(v.dtype == torch.bfloat16 for v in g.init_state(B).values())
    for t, (x, (pre, y16), (_, y32)) in enumerate(zip(_inputs(name), ref16,
                                                      ref32)):
        out, st = g(state_from_numpy(pre, "cpu"), input_audio=torch.from_numpy(x))
        y = out["output_0"]
        assert y.dtype == torch.float32
        err = np.abs(y.reshape(B, -1).numpy() - y16).max()
        assert err <= REL_BAR * np.abs(y32).max(), (t, err)
    assert _dtypes(state_to_numpy(st)) == _dtypes(end16)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_stack_bf16_matches_pallas_bf16(name):
    path = os.path.join(SMALL, f"{name}.tflite")
    pallas = FusedStackKernel(path, mode="bf16", block_streams=B,
                              interpret=True)
    ref32, _ = _jax_graph_run(name, "float")
    ours = FusedStack(path, mode="bf16", device="cpu")
    ps, ts = pallas.init_state(B), ours.init_state(B)
    assert all(v.dtype == torch.bfloat16 for v in ts.values()
               if v.is_floating_point())
    before = [k.launches for k in conv_stack.KERNELS]
    for t, (x, (_, y32)) in enumerate(zip(_inputs(name), ref32)):
        yp, ps = pallas(ps, jnp.asarray(x))
        y, ts = ours(ts, torch.from_numpy(x))
        assert y.dtype == torch.float32
        err = np.abs(y.reshape(B, -1).numpy()
                     - np.asarray(yp).reshape(B, -1)).max()
        assert err <= REL_BAR * np.abs(y32).max(), (t, err)
    assert [k.launches for k in conv_stack.KERNELS] == before  # CPU: plain


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _within_one_rounding(got, ref):
    assert got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    slack = 1e-5 * ref.abs().max()  # f32 summation order
    assert bool(((got - ref).abs() <= BF16_ROUNDING * ref.abs() + slack).all())


@pytest.mark.parametrize("kind", ["conv1d", "depthwise", "transpose"])
def test_bf16_plain_convs_round_once(kind):
    rng = np.random.default_rng(7)
    x = _bf16(rng.normal(size=(3, 21, 16)))
    b = _bf16(rng.normal(size=(24 if kind != "depthwise" else 16,)))
    if kind == "conv1d":
        w = _bf16(rng.normal(size=(3, 4, 24)))  # groups = 4
        got = conv_stack.conv1d(x, w, b, 2)
        ref = conv_stack.conv1d_plain(x.float(), w.float(), b.float(), 2)
    elif kind == "depthwise":
        w = _bf16(rng.normal(size=(3, 16)))
        got = conv_stack.depthwise_conv1d(x, w, b, 3)
        ref = conv_stack.depthwise_conv1d_plain(x.float(), w.float(),
                                                b.float(), 3)
    else:
        w = _bf16(rng.normal(size=(4, 16, 24)))
        got = conv_stack.transpose_conv1d(x, w, b, 2, 40)
        ref = conv_stack.transpose_conv1d_plain(x.float(), w.float(),
                                                b.float(), 2, 40)
    assert got.shape == ref.shape
    _within_one_rounding(got, ref)


@pytest.mark.parametrize("max_stages", [None, 16])
def test_rvq_decode_bf16_matches_jax(max_stages):
    cbs = extract_codebooks(os.path.join(SMALL, "quantizer.tflite"))
    rng = np.random.default_rng(6)
    idx = rng.integers(-1, 16, (8, 46)).astype(np.int32)
    idx[:, 30:] = -1
    ref = np.asarray(JaxRvq(cbs).decode(jnp.asarray(idx), dtype=jnp.bfloat16,
                                        max_stages=max_stages))
    got = ResidualVectorQuantizer(cbs, "cpu").decode(
        torch.from_numpy(idx), dtype=torch.bfloat16,
        max_stages=max_stages).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    f32 = ResidualVectorQuantizer(cbs, "cpu").decode(torch.from_numpy(idx)).numpy()
    assert np.abs(got - f32).max() > 0  # the codewords were rounded


def test_bf16_state_tree_roundtrip_is_bitwise():
    jd = JaxDecoder(16000, SMALL, mode="bf16")
    st = jax.tree.map(np.asarray, jd.init_state(B, seed=3))
    rng = np.random.default_rng(8)
    st["gan"] = {k: rng.normal(size=v.shape).astype(v.dtype)
                 for k, v in st["gan"].items()}
    t = state_from_numpy(st, "cpu")
    assert all(v.dtype == torch.bfloat16 for v in t["gan"].values())
    back = state_to_numpy(t)

    def same_bits(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == ml_dtypes.bfloat16:
            a, b = a.view(np.int16), b.view(np.int16)
        np.testing.assert_array_equal(a, b)

    jax.tree.map(same_bits, back, st)
    assert back["gan"] and all(v.dtype == ml_dtypes.bfloat16
                               for v in back["gan"].values())


WARM, TICKS, NQ = 4, 18, 30


@pytest.fixture(scope="module")
def jax_bf16_run():
    """The JAX bf16 engines' per-tick pre-states, features and outputs."""
    je = JaxEncoder(16000, SMALL, mode="bf16")
    jd = JaxDecoder(16000, SMALL, mode="bf16")
    extract = jax.jit(je.soundstream.extract)
    rng = np.random.default_rng(0)
    gain = np.where(rng.random((TICKS, B, 1)) < 0.7, 4000.0, 40.0)
    audio = (rng.normal(0.0, 1.0, (TICKS, B, 320)) * gain).astype(np.float32)
    rec = np.ones((TICKS, B), bool)
    rec[WARM + 2:WARM + 10, :2] = False  # 8-hop burst: fade → comfort noise
    rec[np.arange(TICKS) % 5 == 3, 3] = False
    jes, jds = je.init_state(B), jd.init_state(B, seed=4)
    ticks = []
    for t in range(TICKS):
        pre_e = jax.tree.map(np.asarray, jes)
        pre_d = jax.tree.map(np.asarray, jds)
        feats, _ = extract(jes["soundstream"],
                           jax_dsp_utils.int16_to_unit(jnp.asarray(audio[t])))
        idx, _, jes = je.step(jes, audio[t], NQ)
        out, cn, jds = jd.step(jds, idx, rec[t])
        ticks.append(jax.tree.map(np.array, (pre_e, pre_d, feats, idx, out,
                                             cn, jds)))
    return audio, rec, ticks


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_bf16_engines_match_jax_stage_by_stage(jax_bf16_run, backend):
    te = EncoderEngine(16000, SMALL, backend=backend, mode="bf16",
                       device="cpu")
    td = DecoderEngine(16000, SMALL, backend=backend, mode="bf16",
                       device="cpu")
    audio, rec, ticks = jax_bf16_run
    reached = set()
    for t, (pre_e, pre_d, jf, jidx, ja, jcn, jds) in enumerate(ticks):
        if t < WARM:
            continue
        tes = state_from_numpy(pre_e, "cpu")
        tf, _ = te.soundstream.extract(
            tes["soundstream"],
            dsp_utils.int16_to_unit(torch.from_numpy(audio[t])))
        assert np.abs(tf.numpy() - jf).max() <= REL_BAR * np.abs(jf).max(), t
        _, _, tes = te.step(tes, torch.from_numpy(audio[t]), NQ)
        assert {k: v.dtype for k, v in tes["soundstream"].items()} == \
            {k: torch.bfloat16 for k in pre_e["soundstream"]}
        tidx = te.rvq.quantize(torch.from_numpy(jf), NQ,
                               method="kernel" if backend == "kernel" else "fast")
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        ta, tcn, tds = td.step(state_from_numpy(pre_d, "cpu"),
                               torch.from_numpy(jidx), torch.from_numpy(rec[t]))
        assert np.abs(ta.numpy() - ja).max() <= REL_BAR * np.abs(ja).max(), t
        np.testing.assert_array_equal(tcn.numpy(), jcn)
        for k in ("concealment", "fade", "fade_dir"):
            np.testing.assert_array_equal(tds[k].numpy(), jds[k])
        reached.update(tds["fade"].numpy().tolist())
    assert {0, 640} <= reached and reached - {0, 640}, reached


@pytest.mark.parametrize("kwargs,error", [
    ({"mode": "int8"}, 'backend="plain"'),
    ({"mode": "fakequant"}, 'backend="plain"'),
    ({"state_compression": "int8"}, 'backend="plain"'),
    ({"boundary_store": "f8"}, 'backend="plain"'),
    ({"mode": "fp16"}, "unknown mode"),
])
def test_engines_refuse_unported_modes(kwargs, error):
    """The kernel backend (the default) runs float and bf16: the quantized
    modes, int8 state and fp8 boundaries run on backend="plain" only (the
    JAX fused backend's ValueError); an unknown mode is refused."""
    for engine in (EncoderEngine, DecoderEngine):
        with pytest.raises(ValueError, match=error):
            engine(16000, SMALL, **kwargs)
