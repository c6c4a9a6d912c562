"""The port's graph executor and fused conv stack vs the JAX package.

Both synthetic models (tests/golden/synthetic_lyra/small) run 50 streaming
frames with state carried between them, from the same numpy inputs,
through the JAX executor, the JAX Pallas megakernel (interpret mode), the
port's executor and the port's FusedStack (whose conv-stack kernels run
their plain versions on CPU tensors).  Bar: max abs error ≤ 1e-5 ×
max|ref| per frame (float32; the frameworks sum in different orders).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu import config as jax_config
from lyra_tpu.ops.fused_stack import FusedStackKernel
from lyra_tpu.tflite import model as jax_tfl
from lyra_tpu.tflite.executor import load_graph as jax_load_graph
from lyra_tpu_torch import config
from lyra_tpu_torch.ops import conv_stack
from lyra_tpu_torch.ops.fused_stack import FusedStack
from lyra_tpu_torch.tflite import executor
from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.tflite.executor import load_graph

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
B, FRAMES, REL_TOL = 4, 50, 1e-5
MODELS = {"soundstream_encoder": ((320,), 0.1), "lyragan": ((1, 64), 1.0)}


def _inputs(name, seed):
    shape, scale = MODELS[name]
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, (FRAMES, B) + shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_reference():
    """name → (executor outputs, pallas outputs, final executor state)."""
    out = {}
    for name in MODELS:
        path = os.path.join(SMALL, f"{name}.tflite")
        g = jax_load_graph(path)
        step = jax.jit(jax.vmap(lambda st, x: g(st, input_audio=x)))
        st = {k: jnp.broadcast_to(v, (B,) + v.shape)
              for k, v in g.init_state().items()}
        fused = FusedStackKernel(path, mode="float", block_streams=B,
                                 interpret=True)
        fs = fused.init_state(B)
        ys, ks = [], []
        for x in _inputs(name, 0):
            o, st = step(st, jnp.asarray(x[:, None]))
            ys.append(np.asarray(o["output_0"]).reshape(B, -1))
            yk, fs = fused(fs, jnp.asarray(x))
            ks.append(np.asarray(yk).reshape(B, -1))
        out[name] = (ys, ks, jax.tree.map(np.asarray, st))
    return out


def _run_port(model, name):
    st = model.init_state(B)
    ys = []
    for x in _inputs(name, 0):
        x = torch.from_numpy(x)
        if isinstance(model, FusedStack):
            y, st = model(st, x)
        else:
            o, st = model(st, input_audio=x)
            y = o["output_0"]
        ys.append(y.reshape(B, -1).numpy())
    return ys, st


def _assert_frames_close(got, ref):
    for t, (g, r) in enumerate(zip(got, ref)):
        err = np.abs(g - r).max()
        assert err <= REL_TOL * np.abs(r).max(), (t, err, np.abs(r).max())


@pytest.mark.parametrize("backend", ["executor", "fused_stack"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_matches_jax_over_50_frames(jax_reference, name, backend):
    path = os.path.join(SMALL, f"{name}.tflite")
    model = (load_graph(path, device="cpu") if backend == "executor"
             else FusedStack(path, device="cpu"))
    ys, st = _run_port(model, name)
    ref_exec, ref_pallas, ref_state = jax_reference[name]
    _assert_frames_close(ys, ref_exec)
    _assert_frames_close(ys, ref_pallas)
    # Same state keys and shapes as the JAX engine's tree, close values.
    assert set(st) == set(ref_state)
    for k, v in ref_state.items():
        assert tuple(st[k].shape) == v.shape, k
        np.testing.assert_allclose(st[k].numpy(), v,
                                   atol=REL_TOL * max(np.abs(v).max(), 1.0))


def test_fused_stack_partition_matches_jax():
    """The dataflow partition (prologue / core / epilogue, core state
    vars) is the JAX kernel's, every core conv is one launch of the plan,
    in graph order, and every other core op is absorbed or a view."""
    for name in MODELS:
        path = os.path.join(SMALL, f"{name}.tflite")
        j = FusedStackKernel(path, mode="float", interpret=True)
        t = FusedStack(path, device="cpu")
        assert t._prologue == j._prologue and t._epilogue == j._epilogue
        assert t._core == j._core
        assert t._core_state_names == j._core_state_names
        kinds = {t.sg.ops[i].name for i in t._core}
        assert {"CONV_2D", "DEPTHWISE_CONV_2D"} <= kinds
        convs = [i for i in t._core if t.sg.ops[i].name in
                 ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")]
        assert [launch.op for launch in t.plan] == convs
        assert sorted(t.roles) == sorted(t._core)
        assert [i for i, r in t.roles.items() if r == "conv"] == convs
        assert set(t.roles.values()) == {"conv", "absorbed", "view"}


@pytest.mark.parametrize("name", MODELS)
def test_fused_stack_edges_run_f32_whatever_the_process_allows(
        name, monkeypatch):
    """The cuDNN edges around the core (prologue and epilogue ops) run
    with deterministic algorithms and TF32 off even in a process that
    allows TF32 in cuDNN (PyTorch's default, and so every spawned serving
    host's), so the same inputs give the same bits in every process; the
    process's own setting is left as it was."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    t = FusedStack(os.path.join(SMALL, f"{name}.tflite"), device="cpu")
    seen = []
    run_ops = t.graph.run_ops

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.deterministic))
        return run_ops(*args, **kwargs)

    monkeypatch.setattr(t.graph, "run_ops", spy)
    shape, scale = MODELS[name]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, scale, (2, *shape)).astype(np.float32))
    t(t.init_state(2), x)
    assert seen and set(seen) == {(False, True)}
    assert torch.backends.cudnn.allow_tf32 is True


# Absorbed elementwise ops per graph: LEAKY_RELU, CONCATENATION, ADD, SUB.
ABSORBED = {"soundstream_encoder": {"LEAKY_RELU": 22, "CONCATENATION": 13,
                                    "ADD": 9},
            "lyragan": {"LEAKY_RELU": 26, "CONCATENATION": 17, "ADD": 10,
                        "SUB": 1}}


@pytest.mark.parametrize("fixture", ["small", "full"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_covers_every_core_op_once(fixture, name):
    """Each core op has one role: a conv launch, an op absorbed by a launch
    or a view (RESHAPE, SPLIT, READ_VARIABLE); the graph ops the launches
    list as absorbed are exactly the absorbed ones, and the elementwise
    ones among them are 44 in SoundStream and 54 in LyraGAN (the full
    fixture is only parsed here)."""
    t = FusedStack(os.path.join(os.path.dirname(SMALL), fixture,
                                f"{name}.tflite"), device="cpu")
    names = {i: t.sg.ops[i].name for i in t._core}
    listed = {i for launch in t.plan for i in launch.absorbed}
    assert listed == {i for i, r in t.roles.items() if r == "absorbed"}
    counts = {}
    for i, r in t.roles.items():
        if r == "absorbed" and names[i] in ABSORBED[name]:
            counts[names[i]] = counts.get(names[i], 0) + 1
    assert counts == ABSORBED[name]
    assert sum(counts.values()) == {"soundstream_encoder": 44,
                                    "lyragan": 54}[name]
    assert {names[i] for i, r in t.roles.items() if r == "view"} <= {
        "RESHAPE", "SPLIT", "READ_VARIABLE"}
    assert {names[i] for i, r in t.roles.items() if r == "absorbed"} <= {
        "LEAKY_RELU", "CONCATENATION", "ADD", "SUB", "STRIDED_SLICE",
        "ASSIGN_VARIABLE"}


def _as_btc(v):
    """A graph tensor [B, T, 1, C] (or [B, T, C]) as [B, T, C]."""
    return v.reshape(v.shape[0], v.shape[1], v.shape[-1])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_launch_plain_is_bitwise_the_executor(name):
    """Each fused launch's plain version, fed the tensors the op-by-op
    executor computed, gives the executor's output and new state bit for
    bit in float32, at the third frame (state carried)."""
    path = os.path.join(SMALL, f"{name}.tflite")
    t = FusedStack(path, device="cpu")
    g = t.graph
    st = g.init_state(B)
    for x in _inputs(name, 1)[:3]:
        env = {t.input_idx: torch.from_numpy(x)}
        new = dict(st)
        g.run_ops(range(len(t.sg.ops)), env, new)
        for launch in t.plan:
            rows = launch.crop and slice(*launch.crop)
            res = None
            if launch.res is not None:
                res = _as_btc(env[launch.res])
                if res.shape[1] != launch.out_shape[0]:  # its sibling's rows
                    res = res[:, rows]
            state = launch.state and _as_btc(st[launch.state][:, 0])
            got = launch.plain(_as_btc(env[launch.x]).contiguous(), state, res)
            if launch.side is not None:
                got, side = got
                assert torch.equal(side, _as_btc(new[launch.side[0]][:, 0]))
            want = _as_btc(env[launch.out])
            if want.shape[1] != got.shape[1]:
                want = want[:, rows]
            assert torch.equal(got, want), launch.op
        st = new


def test_conv_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the K1 wrappers are exactly the executor lowering and
    launch nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 2, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    before = [k.launches for k in conv_stack.KERNELS]
    y = conv_stack.conv1d(x, w, b, stride=2)  # groups = 4
    ref = torch.nn.functional.conv1d(
        x.transpose(1, 2), w.permute(2, 1, 0), b, stride=2, groups=4)
    torch.testing.assert_close(y, ref.transpose(1, 2), rtol=0, atol=1e-6)
    wd = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    yd = conv_stack.depthwise_conv1d(x, wd, b, dilation=3)
    assert yd.shape == (2, 12 - 6, 8)
    torch.testing.assert_close(
        yd[:, 0], x[:, 0] * wd[0] + x[:, 3] * wd[1] + x[:, 6] * wd[2] + b,
        rtol=1e-6, atol=1e-5)
    wt = torch.from_numpy(rng.normal(size=(4, 8, 5)).astype(np.float32))
    yt = conv_stack.transpose_conv1d(x, wt, None, stride=2, t_out=25)
    assert yt.shape == (2, 25, 5)
    # out[t] = Σ_k x[(t − k)/2] · W[k] over taps with (t − k) even.
    torch.testing.assert_close(yt[:, 5], x[:, 2] @ wt[1] + x[:, 1] @ wt[3],
                               rtol=1e-5, atol=1e-5)
    assert [k.launches for k in conv_stack.KERNELS] == before


@pytest.mark.parametrize("kwargs", [{"mode": "int8",
                                     "boundary_store": "f8"},
                                    {"mode": "fakequant",
                                     "boundary_store": "f8"},
                                    {"boundary_store": "int4"}])
def test_unported_modes_are_refused(kwargs):
    """fp8 boundaries only over float and bf16 (the quantized modes define
    their own boundary storage), and no other boundary format: the JAX
    lowering's ValueErrors (tests/test_torch_quant.py holds the modes
    themselves against it)."""
    mdef = tfl.load(os.path.join(SMALL, "lyragan.tflite"))
    with pytest.raises(ValueError, match="boundary_store"):
        executor.GraphFn(mdef, device="cpu", **kwargs)


def _assert_same_model(ours, ref):
    assert ours.signatures == ref.signatures
    assert ours.description == ref.description
    assert len(ours.subgraphs) == len(ref.subgraphs)
    for sg, rsg in zip(ours.subgraphs, ref.subgraphs):
        assert (sg.name, sg.inputs, sg.outputs) == \
            (rsg.name, rsg.inputs, rsg.outputs)
        assert [(op.name, op.inputs, op.outputs, op.options)
                for op in sg.ops] == \
            [(op.name, op.inputs, op.outputs, op.options) for op in rsg.ops]
        assert len(sg.tensors) == len(rsg.tensors)
        for t, r in zip(sg.tensors, rsg.tensors):
            assert (t.name, t.shape, t.dtype, t.is_variable) == \
                (r.name, r.shape, r.dtype, r.is_variable)
            assert (t.data is None) == (r.data is None), t.name
            if t.data is not None:
                assert t.data.dtype == r.data.dtype
                np.testing.assert_array_equal(t.data, r.data)
            assert (t.quant is None) == (r.quant is None), t.name
            if t.quant is not None:
                np.testing.assert_array_equal(t.quant.scale, r.quant.scale)
                np.testing.assert_array_equal(t.quant.zero_point,
                                              r.quant.zero_point)
                assert t.quant.quantized_dimension == \
                    r.quant.quantized_dimension


@pytest.mark.parametrize("fixture", ["small", "full"])
def test_copied_parser_and_config_match_jax_package(fixture):
    """The port's own TFLite parser (tflite/model.py, flatbuffer.py) reads
    every graph of both fixtures as the JAX package's does, and every
    public constant of its config copy equals the JAX package's (the
    default model directory is the environment variable alone in the port,
    without the JAX package's fallback path)."""
    root = os.path.join(os.path.dirname(SMALL), fixture)
    for name in ("soundstream_encoder", "lyragan", "quantizer"):
        path = os.path.join(root, f"{name}.tflite")
        _assert_same_model(tfl.load(path), jax_tfl.load(path))
    names = [n for n in vars(config) if n.isupper()
             and n != "DEFAULT_MODEL_PATH"]
    assert len(names) >= 15
    for n in names:
        assert getattr(config, n) == getattr(jax_config, n), n
    for rate in (8000, 16000, 44100, 48000):
        assert config.is_sample_rate_supported(rate) == \
            jax_config.is_sample_rate_supported(rate)
    for bits in (64, 120, 184, 7):
        assert config.bitrate(bits) == jax_config.bitrate(bits)
    for rate in (3200, 6000, 9200, 1234):
        assert config.bitrate_to_num_quantized_bits(rate) == \
            jax_config.bitrate_to_num_quantized_bits(rate)
        assert config.bitrate_to_packet_size(rate) == \
            jax_config.bitrate_to_packet_size(rate)
    for size in range(0, 30):
        assert config.packet_size_to_num_quantized_bits(size) == \
            jax_config.packet_size_to_num_quantized_bits(size)
    assert config.version_string() == jax_config.version_string()
    config.check_params_supported(16000, 1, root)


def _code(path: str, name: str | None = None) -> str:
    """The AST of a module without its docstring, with the package's name
    read as the JAX package's (or of its top-level function `name`)."""
    with open(path) as f:
        tree = ast.parse(f.read().replace("lyra_tpu_torch", "lyra_tpu"))
    body = tree.body
    if name is not None:
        body = [n for n in body
                if isinstance(n, ast.FunctionDef) and n.name == name]
    elif isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                      ast.Constant):
        body = body[1:]
    assert body, (path, name)
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("module,name", [
    ("utils/wav.py", None),
    ("tools/packet_loss.py", None),
    ("codec/preprocessor.py", None),
    ("dsp/utils.py", "convert_num_samples"),
    ("tools/jitter_buffer.py", None),
    ("tools/control_auth.py", None),
    ("tools/udp_ingest.py", None),
    ("tools/udp_egress.py", None),
    ("dsp/buffered_resampler.py", None),
    ("tools/fleet.py", None),
    ("tools/fleet_main.py", None),
    ("client.py", None),
    ("tools/probe_xnnpack_divergence.py", None),
])
def test_copied_modules_match_jax_package(module, name):
    """The framework-free modules the port copies are the JAX package's
    code statement for statement: only their docstrings and the package
    name in their imports differ (the transport tier's jitter buffer,
    control auth, ingest and egress, the buffered resampler, the fleet
    tier (tools/fleet.py, tools/fleet_main.py) and the caller client are
    whole copies; of dsp/utils.py only convert_num_samples is)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _code(os.path.join(repo, "lyra_tpu_torch", module), name) == \
        _code(os.path.join(repo, "lyra_tpu", module), name)


# -- LyraGAN's output edge (ops/fused_stack.py `_match_edge`, ops/out_edge.py)

GOLDEN = os.path.dirname(SMALL)
EDGE_FIXTURES = {
    "small": os.path.join(SMALL, "lyragan.tflite"),
    "full": os.path.join(GOLDEN, "full", "lyragan.tflite"),
    "islands-small": os.path.join(os.path.dirname(GOLDEN),
                                  "synthetic_lyra_islands", "small",
                                  "lyragan.tflite"),
    "islands-full": os.path.join(os.path.dirname(GOLDEN),
                                 "synthetic_lyra_islands", "full",
                                 "lyragan.tflite"),
}


@pytest.mark.parametrize("mode", ["float", "bf16"])
@pytest.mark.parametrize("fixture", sorted(EDGE_FIXTURES))
def test_output_edge_takes_lyragan_epilogue(fixture, mode):
    """Every fixture's LyraGAN epilogue (the islands fixture's with a
    DEQUANTIZE after the transpose conv) is one output-edge launch: the
    conv from the core's [80, C] to [368, 1], kernel 52, stride 4, and a
    state of 48 samples; the launch takes every epilogue op."""
    t = FusedStack(EDGE_FIXTURES[fixture], mode=mode, device="cpu")
    edge = t.edge
    assert edge is not None
    assert edge.absorbed == tuple(t._epilogue)
    assert t.sg.ops[edge.op].name == "TRANSPOSE_CONV"
    assert (edge.stride, edge.rows) == (4, 368)
    c = 8 if fixture.endswith("small") else 64
    assert tuple(edge.w.shape) == (52, c) and edge.w.dtype == t.graph.dtype
    assert edge.x in t._core_outputs
    assert t._state_shapes[edge.state] == (1, 48, 1, 1)
    from lyra_tpu_torch.ops import out_edge
    assert edge.kernel is out_edge.BY_DTYPE[t.graph.dtype]


def _doctor(t, how):
    """Change one thing of t's epilogue as a graph of another form would."""
    sg = t.sg
    conv = next(sg.ops[i] for i in t._epilogue
                if sg.ops[i].name == "TRANSPOSE_CONV")
    if how == "two_channels":  # a second output channel
        w = t._consts[conv.inputs[1]]
        t._consts[conv.inputs[1]] = np.concatenate([w, w], axis=0)
    elif how == "no_assign":  # the tail is not stored
        t._epilogue = [i for i in t._epilogue
                       if sg.ops[i].name != "ASSIGN_VARIABLE"]
    elif how == "no_bias":
        conv.inputs = conv.inputs[:3]
    elif how == "stride_2":  # no kernel instance for it
        conv.options = dict(conv.options, stride_h=2)
    elif how == "state_from_tail":  # the head adds the conv's own tail
        add = next(sg.ops[i] for i in t._epilogue if sg.ops[i].name == "ADD")
        tail = next(sg.ops[i] for i in t._epilogue
                    if sg.ops[i].name == "ASSIGN_VARIABLE").inputs[1]
        add.inputs = [add.inputs[0], tail]


@pytest.mark.parametrize("how", ["two_channels", "no_assign", "no_bias",
                                 "stride_2", "state_from_tail"])
def test_output_edge_refuses_other_epilogues(how):
    """An epilogue of another form is not taken: the executor keeps it."""
    t = FusedStack(EDGE_FIXTURES["small"], device="cpu")
    assert t._match_edge() is not None
    _doctor(t, how)
    assert t._match_edge() is None


@pytest.mark.parametrize("mode", ["float", "bf16"])
@pytest.mark.parametrize("fixture", ["small", "islands-small", "full"])
def test_output_edge_plain_is_bitwise_the_executor_epilogue(fixture, mode):
    """On CPU tensors the output edge runs its plain version, which gives
    the bits of the executor's op-by-op epilogue: output and every state
    leaf over 10 hops with state carried; and `unfused` runs the same."""
    t = FusedStack(EDGE_FIXTURES[fixture], mode=mode, device="cpu")
    ref = FusedStack(EDGE_FIXTURES[fixture], mode=mode, device="cpu")
    ref.edge = None  # the executor's epilogue
    st = rs = us = t.init_state(B)
    for x in _inputs("lyragan", 5)[:10]:
        x = torch.from_numpy(x)
        y, st = t(st, x)
        r, rs = ref(rs, x)
        u, us = t.unfused(us, x)
        assert y.dtype == torch.float32 and y.shape == (B, 320)
        assert torch.equal(y, r) and torch.equal(y, u)
        for k in rs:
            assert torch.equal(st[k], rs[k]) and torch.equal(us[k], rs[k]), k
