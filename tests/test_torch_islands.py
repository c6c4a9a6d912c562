"""The port on the islands fixture (tests/golden/synthetic_lyra_islands).

The shipped models hold int8 islands (QUANTIZE → int8 ops with int8
per-channel weights and int32 biases → DEQUANTIZE), and the Pallas kernel's
op loop takes more than the Lyra patterns: MUL and DIV, any CONCATENATION,
any STRIDED_SLICE.  The islands fixture has both (its generator,
tests/golden/generate_synthetic_lyra_islands.py, says where).  Here:

  * what the fixture holds: its op histogram, int8 islands with int8 conv
    weights in both cores, the extra unit's ops, the plain fixture's I/O
    signatures and state variables;
  * the port's executor and FusedStack (plain kernel versions on CPU
    tensors) vs the JAX executor and the JAX Pallas kernel (interpret
    mode), float32 (bar 1e-5 × max|ref|) and bf16 (bar 3e-2 × max|f32
    output|, each hop from the JAX state, as tests/test_torch_bf16.py),
    output every frame and state at the end, B=4 over FRAMES frames;
  * the launch plan: QUANTIZE/DEQUANTIZE are views, the launches are the
    convs plus the core kernels' calls, each launch's plain version gives
    the executor's bits;
  * the plain versions of the new fused operand (MUL/DIV by a per-channel
    constant) and of the core kernels (eltwise, gather) vs the JAX
    semantics of the same ops.
"""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu.ops.fused_stack import FusedStackKernel
from lyra_tpu.tflite.executor import load_graph as jax_load_graph
from lyra_tpu_torch.ops import conv_stack
from lyra_tpu_torch.ops.fused_stack import CoreLaunch, FusedLaunch, FusedStack
from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.tflite.executor import load_graph
from lyra_tpu_torch.utils.state import state_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ISLANDS = os.path.join(GOLDEN, "synthetic_lyra_islands")
SMALL = os.path.join(ISLANDS, "small")
B, FRAMES, REL_TOL, BF16_BAR = 4, 6, 1e-5, 3e-2
MODELS = {"soundstream_encoder": ((320,), 0.1), "lyragan": ((1, 64), 1.0)}
# The converter's op histogram of each model (both widths).
OPS = {
    "soundstream_encoder": {
        "ADD": 10, "ASSIGN_VARIABLE": 14, "CALL_ONCE": 1,
        "CONCATENATION": 16, "CONV_2D": 23, "DEPTHWISE_CONV_2D": 9,
        "DEQUANTIZE": 6, "DIV": 1, "LEAKY_RELU": 22, "MUL": 2,
        "QUANTIZE": 5, "READ_VARIABLE": 14, "RESHAPE": 2,
        "STRIDED_SLICE": 17, "VAR_HANDLE": 14},
    "lyragan": {
        "ADD": 12, "ASSIGN_VARIABLE": 18, "CALL_ONCE": 1,
        "CONCATENATION": 20, "CONV_2D": 21, "DEPTHWISE_CONV_2D": 9,
        "DEQUANTIZE": 12, "DIV": 1, "LEAKY_RELU": 26, "MUL": 2,
        "QUANTIZE": 10, "READ_VARIABLE": 18, "RESHAPE": 2, "SPLIT": 2,
        "STRIDED_SLICE": 28, "SUB": 1, "TRANSPOSE_CONV": 8,
        "VAR_HANDLE": 18},
}
# int8 conv ops (int8 weights, int32 bias) per model: CONV_2D,
# DEPTHWISE_CONV_2D, TRANSPOSE_CONV.
INT8_CONVS = {"soundstream_encoder": (5, 2, 0), "lyragan": (4, 2, 8)}
CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")
# Core kernel calls of one hop per model (the extra unit): a gather of two
# stride-2 time slices, MUL / ADD / DIV, a channel concatenation.
CORE_CALLS = [("gather", 1), ("eltwise", "mul"), ("eltwise", "add"),
              ("eltwise", "div"), ("gather", 2)]


def _inputs(name, seed=0):
    shape, scale = MODELS[name]
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, (FRAMES, B) + shape).astype(np.float32)


def _path(fixture, name, root=ISLANDS):
    return os.path.join(root, fixture, f"{name}.tflite")


def _state_vars(mdef):
    sg = mdef.subgraphs[0]
    handles = {op.outputs[0]: op.options["shared_name"] for op in sg.ops
               if op.name == "VAR_HANDLE"}
    return {handles[op.inputs[0]]: tuple(sg.tensors[op.outputs[0]].shape)
            for op in sg.ops if op.name == "READ_VARIABLE"}


def _int8_conv(sg, op):
    """int8 weights (per channel; the 1-channel output edge per tensor),
    and an int32 bias where there is one."""
    w = sg.tensors[op.inputs[1]]
    pos = 3 if op.name == "TRANSPOSE_CONV" else 2
    bias = op.inputs[pos] if len(op.inputs) > pos else -1
    return (w.dtype == np.int8 and w.quant is not None
            and (w.quant.per_channel or w.quant.scale.size == 1)
            and (bias < 0 or sg.tensors[bias].dtype == np.int32))


@pytest.mark.parametrize("fixture", ["small", "full"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_islands_fixture_holds_int8_islands_and_the_op_set(fixture, name):
    """Op histogram; int8 conv weights in the core; every island entered by
    a QUANTIZE to int8 and left by a DEQUANTIZE from int8, a state slice
    among its exits; the extra unit's MUL by a per-channel constant, DIV of
    two tensors, channel concatenation and plain slices; the plain
    fixture's signatures and state variables (13,808 / 12,912 floats at
    full width)."""
    mdef = tfl.load(_path(fixture, name))
    sg = mdef.subgraphs[0]
    assert Counter(op.name for op in sg.ops) == OPS[name]
    assert tuple(sum(op.name == kind and _int8_conv(sg, op) for op in sg.ops)
                 for kind in CONVS) == INT8_CONVS[name]
    producer = {o: op for op in sg.ops for o in op.outputs}
    consumers = {}
    for op in sg.ops:
        for t in op.inputs:
            consumers.setdefault(t, []).append(op)
    for op in sg.ops:
        if op.name == "QUANTIZE":
            assert sg.tensors[op.outputs[0]].dtype == np.int8
        if op.name == "DEQUANTIZE":
            assert sg.tensors[op.inputs[0]].dtype == np.int8
    assert any(producer[op.inputs[0]].name == "STRIDED_SLICE"
               and consumers[op.outputs[0]][0].name == "ASSIGN_VARIABLE"
               for op in sg.ops if op.name == "DEQUANTIZE")
    consts = {t.index for t in sg.tensors if t.data is not None}
    muls = [op for op in sg.ops if op.name == "MUL"]
    assert any(op.inputs[1] in consts and producer[op.inputs[0]].name ==
               "LEAKY_RELU" for op in muls)
    (div,) = [op for op in sg.ops if op.name == "DIV"]
    assert not set(div.inputs) & consts
    cats = [op for op in sg.ops if op.name == "CONCATENATION"
            and op.options["axis"] in (3, -1)]
    assert len(cats) == 1 and consumers[cats[0].outputs[0]][0].name == \
        "CONV_2D"
    slices = [op for op in sg.ops if op.name == "STRIDED_SLICE"
              and producer[op.inputs[0]].name in ("LEAKY_RELU", "MUL")]
    assert len(slices) == 3  # a channel range and two stride-2 time slices
    assert sorted(int(sg.tensors[op.inputs[3]].data[1]) for op in slices) \
        == [1, 2, 2]
    plain = tfl.load(_path(fixture, name, os.path.join(GOLDEN,
                                                       "synthetic_lyra")))
    assert set(mdef.signatures) == set(plain.signatures)
    for key, sig in plain.signatures.items():
        for side in ("inputs", "outputs"):
            ours = mdef.signatures[key][side]
            assert {n: sg.tensors[i].shape for n, i in ours.items()} == {
                n: plain.subgraphs[0].tensors[i].shape
                for n, i in sig[side].items()}
    assert _state_vars(mdef) == _state_vars(plain)
    if fixture == "full":
        assert sum(int(np.prod(s)) for s in _state_vars(mdef).values()) == \
            {"soundstream_encoder": 13808, "lyragan": 12912}[name]


@pytest.fixture(scope="module")
def jax_reference():
    """(name, mode) → per frame (the JAX executor's pre-hop state, its
    output, the Pallas kernel's output), and the executor's final state."""
    cache = {}

    def run(name, mode):
        if (name, mode) not in cache:
            path = _path("small", name)
            g = jax_load_graph(path, mode=mode)
            step = jax.jit(jax.vmap(lambda st, x: g(st, input_audio=x)))
            st = {k: jnp.broadcast_to(v, (B,) + v.shape)
                  for k, v in g.init_state().items()}
            pallas = FusedStackKernel(path, mode=mode, block_streams=B,
                                      interpret=True)
            ps = pallas.init_state(B)
            frames = []
            for x in _inputs(name):
                pre = jax.tree.map(np.asarray, st)
                o, st = step(st, jnp.asarray(x[:, None]))
                yk, ps = pallas(ps, jnp.asarray(x))
                frames.append((pre, *(np.asarray(v, np.float32).reshape(B, -1)
                                      for v in (o["output_0"], yk))))
            cache[(name, mode)] = frames, jax.tree.map(np.asarray, st)
        return cache[(name, mode)]

    return run


def _hop(model, st, x):
    if isinstance(model, FusedStack):
        y, st = model(st, x)
    else:
        o, st = model(st, input_audio=x)
        y = o["output_0"]
    return y.reshape(B, -1).float().numpy(), st


@pytest.mark.parametrize("backend", ["executor", "fused_stack"])
@pytest.mark.parametrize("mode", ["float", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_matches_jax_on_islands(jax_reference, name, mode, backend):
    """float: FRAMES frames with the port's own state, vs the JAX executor
    and the Pallas kernel every frame, state at the end.  bf16 (as
    tests/test_torch_bf16.py: the two packages round at other places, so
    state drifts apart): each hop from the JAX executor's pre-hop state vs
    its output, the state after the last hop vs its state; the FusedStack
    also with its own state vs the Pallas kernel with its own."""
    path = _path("small", name)
    model = (load_graph(path, mode=mode, device="cpu")
             if backend == "executor"
             else FusedStack(path, mode=mode, device="cpu"))
    frames, ref_state = jax_reference(name, mode)
    f32_frames, f32_state = jax_reference(name, "float")
    rel = REL_TOL if mode == "float" else BF16_BAR
    st = model.init_state(B)
    for t, (x, (pre, y_exec, y_pallas), (_, y32, _)) in enumerate(
            zip(_inputs(name), frames, f32_frames)):
        bar = rel * np.abs(y32).max()
        if mode == "bf16":
            y, new = _hop(model, state_from_numpy(pre, "cpu"),
                          torch.from_numpy(x))
            assert np.abs(y - y_exec).max() <= bar, (t, "executor")
            if backend == "executor":
                st = new
                continue
        y, st = _hop(model, st, torch.from_numpy(x))
        if mode == "float":
            assert np.abs(y - y_exec).max() <= bar, (t, "executor")
        assert np.abs(y - y_pallas).max() <= bar, (t, "pallas")
    if mode == "bf16":
        st = new
    assert set(st) == set(ref_state)
    for k, v in ref_state.items():
        assert tuple(st[k].shape) == v.shape, k
        tol = rel * max(np.abs(np.asarray(f32_state[k], np.float32)).max(),
                        1.0)
        assert np.abs(st[k].float().numpy() - np.asarray(v, np.float32)
                      ).max() <= tol, k


@pytest.mark.parametrize("fixture", ["small", "full"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_islands_plan_roles(fixture, name):
    """QUANTIZE and DEQUANTIZE are views; one FusedLaunch per conv op (31
    and 37, as on the plain fixture) and one CoreLaunch per op no conv
    absorbs (the extra unit's five); the MUL by a per-channel constant is
    absorbed after its conv's LEAKY_RELU, the channel slice is a split."""
    t = FusedStack(_path(fixture, name), device="cpu")
    names = {i: t.sg.ops[i].name for i in t._core}
    assert {r for i, r in t.roles.items()
            if names[i] in ("QUANTIZE", "DEQUANTIZE")} == {"view"}
    convs = [i for i in t._core if names[i] in CONVS]
    fused = [launch for launch in t.plan if isinstance(launch, FusedLaunch)]
    core = [launch for launch in t.plan if isinstance(launch, CoreLaunch)]
    assert [launch.op for launch in fused] == convs
    assert len(convs) == {"soundstream_encoder": 31, "lyragan": 37}[name]
    assert [(launch.kind, launch.arg) for launch in core] == CORE_CALLS
    assert len(t.plan) == len(convs) + len(CORE_CALLS)
    assert [launch.op for launch in t.plan] == sorted(
        launch.op for launch in t.plan)
    assert {i for i, r in t.roles.items() if r == "kernel"} == \
        {launch.op for launch in core}
    listed = {i for launch in t.plan for i in launch.absorbed}
    assert listed == {i for i, r in t.roles.items() if r == "absorbed"}
    (chan,) = [launch for launch in fused if launch.chan is not None]
    assert (chan.chan_op, chan.chan_pos, chan.leaky_out is not None,
            tuple(chan.chan.shape)) == ("mul", 2, True,
                                        (chan.out_shape[1],))
    (split,) = [launch for launch in fused if launch.split is not None
                and names[launch.op] == "CONV_2D"]
    assert split.split == (split.x_shape[1] // 2, split.x_shape[1] // 2)
    assert core[0].absorbed and all(
        names[i] == "STRIDED_SLICE" for i in core[0].absorbed)


def _as_btc(v):
    return v.reshape(v.shape[0], v.shape[1], v.shape[-1])


@pytest.mark.parametrize("mode", ["float", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_islands_launch_plain_is_bitwise_the_executor(name, mode):
    """Each launch's plain version, fed the tensors the op-by-op executor
    computed, gives the executor's output (and new state) bit for bit, at
    the third frame; the whole FusedStack is bitwise its `unfused` hop."""
    t = FusedStack(_path("small", name), mode=mode, device="cpu")
    g = t.graph
    st = us = g.init_state(B)
    for x in _inputs(name, 1)[:3]:
        x = torch.from_numpy(x)
        env = {t.input_idx: x.to(g.dtype)}
        new = dict(st)
        g.run_ops(range(len(t.sg.ops)), env, new)
        core = {k: _as_btc(v).contiguous() for k, v in env.items()
                if v.dim() >= 3}
        for launch in t.plan:
            if isinstance(launch, CoreLaunch):
                got = launch.plain(core)
                assert torch.equal(got, _as_btc(env[launch.out])), launch.op
                continue
            rows = launch.crop and slice(*launch.crop)
            res = None
            if launch.res is not None:
                res = core[launch.res]
                if res.shape[1] != launch.out_shape[0]:
                    res = res[:, rows]
            state = launch.state and _as_btc(st[launch.state][:, 0])
            got = launch.plain(core[launch.x], state, res)
            if launch.side is not None:
                got, side = got
                assert torch.equal(side, _as_btc(new[launch.side[0]][:, 0]))
            want = _as_btc(env[launch.out])
            if want.shape[1] != got.shape[1]:
                want = want[:, rows]
            assert torch.equal(got, want), launch.op
        y, st2 = t(st, x)
        u, us = t.unfused(us, x)
        assert torch.equal(y, u)
        assert all(torch.equal(st2[k], us[k]) for k in us)
        st = new


def _rand(rng, *shape):
    return rng.normal(0.0, 1.0, shape).astype(np.float32)


ELTWISE_CASES = [(op, layout, first) for op in ("add", "sub", "mul", "div")
                 for layout in ("full", "channel", "scalar")
                 for first in (False, True)]


@pytest.mark.parametrize("op,layout,const_first", ELTWISE_CASES)
def test_eltwise_plain_matches_jax(op, layout, const_first):
    """conv_stack.eltwise on CPU tensors vs the Pallas op loop's ADD/SUB/
    MUL/DIV (fused_stack.py:624-632): a tensor with a tensor, with a [C]
    weight or with one value, either operand first; a divisor kept away
    from 0."""
    rng = np.random.default_rng(5)
    a = _rand(rng, 3, 5, 8)
    b = {"full": _rand(rng, 3, 5, 8), "channel": _rand(rng, 8),
         "scalar": _rand(rng, 1)}[layout]
    if op == "div":
        a, b = a + np.sign(a) * 0.5, b + np.sign(b) * 0.5
    x, y = (b, a) if const_first and layout != "full" else (a, b)
    got = conv_stack.eltwise(torch.from_numpy(x), torch.from_numpy(y), op)
    jx = jnp.asarray(x if x.ndim == 3 else x.reshape(1, -1))
    jy = jnp.asarray(y if y.ndim == 3 else y.reshape(1, -1))
    want = {"add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply,
            "div": jnp.divide}[op](jx, jy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


GATHER_CASES = {
    # (parts as (T_p, C_p, row0, rstride, rows, col0, cstride, cols,
    #  shared constant), axis)
    "time_concat": ([(3, 8, 0, 1, 3, 0, 1, 8, False),
                     (5, 8, 0, 1, 5, 0, 1, 8, False)], 1),
    "channel_concat": ([(6, 8, 0, 1, 6, 0, 1, 8, False),
                        (6, 4, 0, 1, 6, 0, 1, 4, False)], 2),
    "time_stride_2": ([(8, 8, 1, 2, 4, 0, 1, 8, False)], 1),
    "channel_range": ([(6, 8, 0, 1, 6, 4, 1, 4, False)], 1),
    "channel_stride_2": ([(6, 8, 0, 1, 6, 1, 2, 4, False)], 1),
    "slices_concat": ([(8, 8, 0, 2, 4, 0, 1, 8, False),
                       (8, 8, 1, 2, 4, 0, 1, 8, False)], 1),
    "constant_part": ([(6, 8, 0, 1, 6, 0, 1, 8, False),
                       (6, 2, 0, 1, 6, 0, 1, 2, True)], 2),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_plain_matches_jax(case):
    """conv_stack.gather on CPU tensors vs the Pallas op loop's
    STRIDED_SLICE (its own _mapped_strided_slice) and CONCATENATION
    (jnp.concatenate, a constant part broadcast over the block): bitwise."""
    rng = np.random.default_rng(6)
    parts_spec, axis = GATHER_CASES[case]
    parts, jparts = [], []
    for t_p, c_p, r0, rs, nr, c0, cs, nc, shared in parts_spec:
        src = _rand(rng, t_p, c_p) if shared else _rand(rng, 3, t_p, c_p)
        parts.append(conv_stack.GatherPart(torch.from_numpy(src), r0, rs, nr,
                                           c0, cs, nc))
        graph = (1, t_p, 1, c_p)
        begin, end, strides = [0, r0, 0, c0], [1, r0 + rs * (nr - 1) + 1, 1,
                                               c0 + cs * (nc - 1) + 1], \
            [1, rs, 1, cs]
        full = jnp.broadcast_to(jnp.asarray(src), (3, t_p, c_p))
        jparts.append(FusedStackKernel._mapped_strided_slice(
            FusedStackKernel, full, np.array(begin), np.array(end),
            np.array(strides), {}, graph))
    got = conv_stack.gather(parts, axis, 3)
    want = jnp.concatenate(jparts, axis=axis)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chan_op", ["mul", "div"])
@pytest.mark.parametrize("pos", [0, 1, 2])
@pytest.mark.parametrize("per_channel", [True, False])
def test_fused_chan_plain_matches_jax(chan_op, pos, per_channel):
    """A conv launch with a MUL or DIV by a per-channel constant before the
    residual (pos 0), between it and the LEAKY_RELU (1) or after it (2),
    vs the same ops in the Pallas op loop's order in jnp."""
    rng = np.random.default_rng(7)
    x, w, bias = _rand(rng, 2, 6, 8), _rand(rng, 1, 8, 8), _rand(rng, 8)
    res = _rand(rng, 2, 6, 8)
    c = _rand(rng, 8 if per_channel else 1) + 2.0
    got = conv_stack.conv1d(
        *map(torch.from_numpy, (x, w, bias)), 1, res=torch.from_numpy(res),
        leaky_out=0.2, chan=torch.from_numpy(c), chan_op=chan_op,
        chan_pos=pos)
    y = jnp.einsum("btc,co->bto", jnp.asarray(x), jnp.asarray(w[0])) + bias

    def chan(v, p):
        if p != pos:
            return v
        return v * c if chan_op == "mul" else v / c

    y = chan(y, 0) + res
    y = chan(y, 1)
    y = jnp.maximum(y, 0.0) + 0.2 * jnp.minimum(y, 0.0)
    y = chan(y, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)


def test_core_kernels_run_plain_versions_on_cpu():
    """On CPU tensors eltwise and gather launch nothing; a launch plan of
    the islands fixture runs its CoreLaunches on CPU tensors too."""
    before = [k.launches for k in conv_stack.KERNELS]
    a = torch.ones(2, 3, 4)
    assert torch.equal(conv_stack.eltwise(a, torch.full((4,), 2.0), "div"),
                       a / 2)
    part = conv_stack.GatherPart(a, 0, 2, 2, 1, 1, 3)
    assert torch.equal(conv_stack.gather([part], 1, 2), a[:, 0:3:2, 1:4])
    assert [k.launches for k in conv_stack.KERNELS] == before
