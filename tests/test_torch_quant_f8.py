"""fp8 layer-boundary storage (boundary_store="f8") vs the JAX package,
on the CPU.

The small fixtures have no float intermediate of the 1024 elements a
boundary needs to be stored as fp8, so these run on the full islands
fixture (tests/golden/synthetic_lyra_islands/full), inputs made from a
numpy seed:

  * the cast itself (`_to_e4m3`): XLA's bits — round to nearest even, NaN
    where the result would pass 448 (torch's cast saturates), ±inf and NaN
    with their sign, subnormals and their ties — from float32 and bfloat16;
  * every boundary cast of a real hop, bitwise on identical values, and
    the value loaded back;
  * whole graphs at the models' scales (0.5 SoundStream, 1.0 LyraGAN) vs
    the JAX lowering from its pre-hop state: the same tensors stored as
    fp8, their bits, the output, and a control that fails a port storing
    nothing in fp8.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lyra_tpu.tflite import executor as jexe
from lyra_tpu.tflite import model as jtfl
from lyra_tpu_torch.tflite import executor as texe
from lyra_tpu_torch.utils.state import state_from_numpy

FULL = os.path.join(os.path.dirname(__file__), "golden",
                    "synthetic_lyra_islands", "full")
MODELS = {"soundstream_encoder": ((320,), 0.1), "lyragan": ((1, 64), 1.0)}
SCALES = {"soundstream_encoder": 0.5, "lyragan": 1.0}
CPU = {"device": "cpu"}
# The full-width graph check, set from readings over 8 hops (seeds 9-16) of
# both models: the share of the fp8 boundary bits equal to the JAX
# lowering's (read ≥ 0.99985 in float; 0.707-0.818 in bf16, whose pre-cast
# values differ already: the plain bf16 port is 0.5-1.7e-2 × max|ref| from
# JAX's), the port's output vs JAX's as a multiple of what fp8 storage moves
# JAX's output (read ≤ 0.098 float, ≤ 1.27 bf16), and the control, the
# port's f8 output vs its plain output as a multiple of the same (read ≥
# 0.99 float, ≥ 0.71 bf16; 0 for a port that stores nothing in fp8).
F8_BITS_AGREE = {"float": 0.999, "bf16": 0.6}
F8_OUT_BAR = {"float": 0.5, "bf16": 2.0}
F8_CONTROL = 0.5


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


def _hop(name, seed, b=2):
    shape, scale = MODELS[name]
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, (b,) + shape).astype(np.float32)


FP8_VALUES = np.array(
    [448, -448, 460, 464, -464, 464.5, 465, 470, 480, 500, 1000, -600,
     np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 2.0 ** -6, 2.0 ** -7,
     2.0 ** -9, -2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -10 * 1.001,
     2.0 ** -11, 1e-30, 1.0625, 1.1875, 240, 248, 264, 272, 0.3, -17.7],
    np.float32)


def _both(vals, dtype):
    """`vals` as a torch tensor and a JAX array of `dtype` with the same
    bits (torch's f32 → bf16 cast drops a NaN's sign; ml_dtypes' keeps it,
    as XLA's)."""
    vals = vals.astype(getattr(ml_dtypes, dtype, np.float32))
    x = torch.from_numpy(vals.view(np.int16 if dtype == "bfloat16"
                                   else np.float32))
    return (x.view(torch.bfloat16) if dtype == "bfloat16" else x,
            jnp.asarray(vals))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_casts_are_the_jax_bits(dtype):
    """±448, the ties at ±464, 480, 500 and beyond (NaN in XLA, ±448 in
    torch's saturating cast), ±inf, NaN, subnormals and their ties."""
    x, jx = _both(FP8_VALUES, dtype)
    got = texe._to_e4m3(x).view(torch.uint8).numpy()
    want = np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(np.asarray(jx.astype(jnp.float8_e4m3fn),
                               np.float32)[FP8_VALUES.tolist().index(500)])


@pytest.mark.parametrize("mode", ["float", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_boundary_casts_of_a_hop_are_bitwise_jax(name, mode):
    """Every tensor that boundary_store="f8" wraps (the full fixture: the
    small one has no float intermediate of 1024 elements), with the values
    one hop of the float (bf16) graph gives it at B=2, cast by both
    packages' `_BoundaryEnv` at the model's scale (0.5 SoundStream, 1.0
    LyraGAN): the same fp8 bits, and the same value loaded back; and
    FP8_VALUES / scale stored at one of them: XLA's bits past 448 too."""
    path = os.path.join(FULL, f"{name}.tflite")
    scale = SCALES[name]
    tg = texe.load_graph(path, mode=mode, boundary_store="f8",
                         boundary_scale=scale, **CPU)
    plain = texe.load_graph(path, mode=mode, **CPU)
    _, _, env = plain.lower(capture_env=True)(
        plain.init_state(2), input_audio=torch.from_numpy(_hop(name, 0)))
    cd = jnp.bfloat16 if mode == "bf16" else jnp.float32
    wrap = sorted(tg._boundary_wrap)
    assert wrap

    @jax.jit
    def jax_casts(vals):
        jenv = jexe._BoundaryEnv(tg._boundary_wrap, scale)
        for i, v in zip(wrap, vals):
            jenv[i] = v.astype(cd)
        return ([jenv[i] for i in wrap],
                [jenv[i].astype(cd) * jnp.asarray(1.0 / scale, cd)
                 for i in wrap])

    stored, loaded = jax_casts([jnp.asarray(env[i].float().numpy())
                                for i in wrap])
    tenv = texe._BoundaryEnv(tg._boundary_wrap, scale, tg.dtype,
                             texe._BoundaryEnv.scales(scale, "cpu"))
    for i, want, jback in zip(wrap, stored, loaded):
        tenv[i] = env[i]
        assert tenv[i].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(tenv[i].view(torch.uint8).numpy(),
                                      np.asarray(want).view(np.uint8))
        np.testing.assert_array_equal(tg.get(tenv, i).float().numpy(),
                                      np.asarray(jback, np.float32))
    x, jx = _both(FP8_VALUES / np.float32(scale), str(tg.dtype)[6:])
    jenv = jexe._BoundaryEnv(tg._boundary_wrap, scale)
    tenv[wrap[0]], jenv[wrap[0]] = x, jx
    np.testing.assert_array_equal(tenv[wrap[0]].view(torch.uint8).numpy(),
                                  np.asarray(jenv[wrap[0]]).view(np.uint8))


@pytest.mark.parametrize("mode", ["float", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_f8_boundaries_at_full_width_match_jax(name, mode):
    """boundary_store="f8" at the models' scales on the full fixture, 3
    hops at B=2, each from the JAX lowering's pre-hop state, both packages
    through `lower(capture_env=True)`: the same environment indices hold
    fp8 (the wrap set is the JAX lowering's), at least F8_BITS_AGREE of
    their bits equal; the port's output within F8_OUT_BAR × what fp8
    storage itself moves the JAX output on the hop (JAX f8 vs JAX plain);
    and the control: the port's f8 output at least F8_CONTROL × that far
    from the port's plain output, so a port that stores nothing in fp8
    fails."""
    path = os.path.join(FULL, f"{name}.tflite")
    scale = SCALES[name]
    jf8 = jexe.GraphLowering(jtfl.load(path), "serving_default", mode=mode,
                             boundary_store="f8",
                             boundary_scale=scale).lower(capture_env=True)
    jplain = jexe.load_graph(path, mode=mode)

    def f8_env(st, x):
        out, new_st, env = jf8(st, input_audio=x)
        return out, new_st, dict(env)  # a _BoundaryEnv is no pytree

    step = jax.jit(jax.vmap(f8_env))
    plain = jax.jit(jax.vmap(lambda st, x: jplain(st, input_audio=x)))
    js = {k: jnp.broadcast_to(v, (2,) + v.shape)
          for k, v in jf8.init_state().items()}
    tg = texe.load_graph(path, mode=mode, boundary_store="f8",
                         boundary_scale=scale, **CPU)
    tplain = texe.load_graph(path, mode=mode, **CPU)
    fn = tg.lower(capture_env=True)
    for seed in range(3):
        x = _hop(name, 9 + seed)
        ts = state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
        to, _, tenv = fn(ts, input_audio=torch.from_numpy(x))
        tpo, _ = tplain(ts, input_audio=torch.from_numpy(x))
        jpo, _ = plain(js, jnp.asarray(x[:, None]))
        jo, js, jenv = step(js, jnp.asarray(x[:, None]))
        fp8 = sorted(i for i, v in jenv.items()
                     if v.dtype == jnp.float8_e4m3fn)
        assert fp8 and fp8 == sorted(i for i, v in tenv.items()
                                     if v.dtype == torch.float8_e4m3fn)
        agree = sum(int((np.asarray(jenv[i]).view(np.uint8).ravel()
                         == tenv[i].view(torch.uint8).numpy().ravel()).sum())
                    for i in fp8)
        assert agree >= F8_BITS_AGREE[mode] * sum(tenv[i].numel()
                                                  for i in fp8)
        y, y_plain = (np.asarray(o["output_0"]).reshape(2, -1)
                      for o in (jo, jpo))
        t, t_plain = (o["output_0"].numpy().reshape(2, -1)
                      for o in (to, tpo))
        effect = np.abs(y - y_plain).max()
        assert np.abs(t - y).max() <= F8_OUT_BAR[mode] * effect
        assert np.abs(t - t_plain).max() >= F8_CONTROL * effect
