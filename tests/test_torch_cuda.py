"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

These need an NVIDIA GPU with `nvcc` (the kernels are built from
lyra_tpu_torch/ops/csrc/ on first use) and skip elsewhere.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py configures jax, which that machine
lacks.)

chip_smoke.py runs the same comparisons at the full fixture's widths.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.dsp.resampler import Resampler
from lyra_tpu_torch.models.streaming import mask_tree
from lyra_tpu_torch.ops import conv_stack, rvq_kernel
from lyra_tpu_torch.ops.fused_stack import FusedStack
from lyra_tpu_torch.tflite.executor import load_graph
from lyra_tpu_torch.utils import capture

pytestmark = pytest.mark.cuda

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
GOLDENS = os.path.join(os.path.dirname(__file__), "golden",
                       "resampler_goldens.npz")
BF16_BAR = 2.0 ** -7  # two bf16 roundings: the kernel's and cuDNN's

# Every distinct conv1d and transpose-conv call of one hop of the full-width
# fixture (FusedStack(...).plan on tests/golden/synthetic_lyra/
# full; tests/test_torch_conv_gemm.py checks these lists against it).
# conv1d: (T_in, C_in, K, I_f, O, stride), SoundStream then LyraGAN.
FULL_CONV1D = [
    (40, 64, 1, 64, 64, 1), (40, 64, 1, 16, 64, 1), (45, 64, 10, 64, 128, 5),
    (8, 128, 1, 128, 128, 1), (8, 128, 1, 32, 128, 1),
    (10, 128, 4, 128, 256, 2), (4, 256, 1, 256, 256, 1),
    (4, 256, 1, 64, 256, 1), (6, 256, 4, 256, 512, 2),
    (4, 512, 4, 512, 64, 2),
    (3, 64, 3, 64, 256, 1), (1, 256, 1, 256, 256, 1), (1, 256, 1, 64, 256, 1),
    (4, 128, 3, 128, 128, 1), (2, 128, 1, 128, 128, 1),
    (2, 128, 1, 32, 128, 1), (4, 64, 1, 64, 64, 1), (4, 64, 1, 16, 64, 1),
    (84, 64, 5, 64, 64, 1),
]
# transpose conv: (T_in, I, K, O, stride, t_out), all LyraGAN.
FULL_TCONV = [(2, 128, 4, 128, 2, 6), (3, 64, 4, 64, 2, 8),
              (5, 64, 4, 64, 2, 12), (9, 64, 10, 64, 5, 50),
              (41, 64, 4, 64, 2, 84)]
# Shapes the 16-byte path does not take, or that leave ragged tiles.
RAGGED_CONV1D = [
    (40, 8, 1, 2, 8, 1),  # the small fixture's I_f = 2, O/groups = 2
    (23, 64, 4, 16, 48, 1),  # O/groups = 12
    (23, 64, 4, 64, 48, 2),
    (9, 3, 3, 3, 5, 1),  # K·I_f = 9 < 16, odd widths
    (37, 24, 2, 24, 40, 1),  # M = 3·36 rows, a multiple of no tile
    (45, 8, 10, 8, 16, 5),  # s = 5, K = 10
]
RAGGED_TCONV = [
    (9, 16, 10, 24, 5, 50), (9, 16, 10, 24, 5, 43),  # s = 5, K = 10; cropped
    (7, 16, 5, 24, 2, 17), (7, 16, 5, 24, 2, 12),  # s ∤ K; cropped
    (9, 16, 52, 24, 4, 70),  # K = 52, s = 4, cropped
    (3, 6, 4, 10, 2, 7),  # I and O not multiples of 8
    (4, 8, 1, 8, 2, 7),  # K < s: phase 1 has no taps (bias only)
]
# depthwise: (T_in, C, dilation), K = 3 taps, SoundStream then LyraGAN.
FULL_DEPTHWISE = [
    (42, 64, 1), (46, 64, 3), (58, 64, 9),
    (10, 128, 1), (14, 128, 3), (26, 128, 9),
    (6, 256, 1), (10, 256, 3), (22, 256, 9),
    (3, 256, 1), (7, 256, 3), (19, 256, 9),
    (4, 128, 1), (8, 128, 3), (20, 128, 9),
    (6, 64, 1), (10, 64, 3), (22, 64, 9),
]
# (T_in, C, dilation, K): C that no 16-byte vector divides (or only in
# f32), T_out = 1 at d = 9, and K ≠ 3 (taps taken at run time).
RAGGED_DEPTHWISE = [
    (13, 6, 1, 3), (29, 12, 3, 3), (40, 20, 2, 3), (22, 36, 9, 3),
    (19, 64, 9, 3), (19, 6, 9, 3), (12, 16, 2, 2), (30, 32, 3, 5),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (5, 1), (1, 4)])
def test_conv1d_kernel_matches_plain(cuda, stride, groups):
    rng = np.random.default_rng(stride * 10 + groups)
    x = _t(rng.normal(size=(5, 23, 64)), cuda)
    w = _t(rng.normal(size=(4, 64 // groups, 48)), cuda)
    b = _t(rng.normal(size=(48,)), cuda)
    n = conv_stack.CONV1D.launches
    y = conv_stack.conv1d(x, w, b, stride)
    assert conv_stack.CONV1D.launches == n + 1
    ref = conv_stack.conv1d_plain(x, w, b, stride)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_depthwise_kernel_matches_plain(cuda, dilation):
    rng = np.random.default_rng(dilation)
    x = _t(rng.normal(size=(5, 2 * dilation + 7, 32)), cuda)
    w = _t(rng.normal(size=(3, 32)), cuda)
    b = _t(rng.normal(size=(32,)), cuda)
    y = conv_stack.depthwise_conv1d(x, w, b, dilation)
    torch.testing.assert_close(
        y, conv_stack.depthwise_conv1d_plain(x, w, b, dilation),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,k,t_out", [(2, 4, 8), (5, 10, 45), (4, 52, 100)])
def test_transpose_conv_kernel_matches_plain(cuda, stride, k, t_out):
    rng = np.random.default_rng(k)
    x = _t(rng.normal(size=(3, 9, 16)), cuda)
    w = _t(rng.normal(size=(k, 16, 24)), cuda)
    b = _t(rng.normal(size=(24,)), cuda)
    t_out = min(t_out, (9 - 1) * stride + k)
    y = conv_stack.transpose_conv1d(x, w, b, stride, t_out)
    torch.testing.assert_close(
        y, conv_stack.transpose_conv1d_plain(x, w, b, stride, t_out),
        rtol=1e-5, atol=1e-4)


def _rvq_operands(dev, batch, seed=0):
    rng = np.random.default_rng(seed)
    cb = _t(rng.normal(0, 0.5, (46, 16, 64)), dev)
    c2 = (cb * cb).sum(-1).contiguous()
    return _t(rng.normal(size=(batch, 64)), dev), cb, c2


def _assert_rvq_near_ties(got, ref, feats, cb, c2):
    """At most 0.1 % of rows differ, and each first differs at a near-tie
    of the plain search's scores (1e-5 relative, in float64)."""
    rows = torch.nonzero((got != ref).any(dim=1)).flatten().tolist()
    assert len(rows) <= got.shape[0] // 1000, len(rows)
    for r in rows:
        s = int(torch.nonzero(got[r] != ref[r])[0].item())
        resid = feats[r].double() - cb[torch.arange(s, device=cb.device),
                                       ref[r, :s].long()] \
            .double().sum(0)
        top = torch.sort(c2[s].double() - 2.0 * cb[s].double() @ resid) \
            .values[:2]
        assert (top[1] - top[0]).item() < 1e-5 * max(abs(top[0].item()), 1.0)


@pytest.mark.parametrize("batch", [1, 3, 777, 1024, 4096, 70000])
def test_rvq_kernel_matches_plain(cuda, batch):
    feats, cb, c2 = _rvq_operands(cuda, batch)
    n = rvq_kernel.RVQ.launches
    got = rvq_kernel.rvq_encode(feats, cb, c2, 46)
    assert rvq_kernel.RVQ.launches == n + 1
    assert got.shape == (batch, 46) and got.dtype == torch.int32
    _assert_rvq_near_ties(got, rvq_kernel.rvq_encode_plain(feats, cb, c2, 46),
                          feats, cb, c2)


def test_rvq_kernel_exact_ties_pick_the_lowest_k(cuda):
    """Duplicated codewords give exactly equal scores (the dot's order
    depends on no lane), so the argmin must return the first copy."""
    feats, cb, c2 = _rvq_operands(cuda, 4096, seed=1)
    first = torch.tensor([[k % 8 for k in range(16)],  # even stages
                          [min(k, 15 - k) for k in range(16)]], device=cuda)
    first = first[torch.arange(46, device=cuda) % 2]  # [46, 16]
    cb = cb[torch.arange(46, device=cuda)[:, None], first].contiguous()
    c2 = (cb * cb).sum(-1).contiguous()
    got = rvq_kernel.rvq_encode(feats, cb, c2, 46)
    assert int(got.max().item()) <= 7
    # The plain search's pick, mapped to the first copy of its codeword.
    ref = rvq_kernel.rvq_encode_plain(feats, cb, c2, 46).long()
    ref = first[torch.arange(46, device=cuda), ref].to(torch.int32)
    _assert_rvq_near_ties(got, ref, feats, cb, c2)


def test_rvq_kernel_is_deterministic_and_stage_prefixes_agree(cuda):
    feats, cb, c2 = _rvq_operands(cuda, 4096, seed=2)
    full = rvq_kernel.rvq_encode(feats, cb, c2, 46)
    assert torch.equal(rvq_kernel.rvq_encode(feats, cb, c2, 46), full)
    for stages in (1, 16, 30):
        assert torch.equal(rvq_kernel.rvq_encode(feats, cb, c2, stages),
                           full[:, :stages]), stages


def test_rvq_launch_counter_and_alignment(cuda):
    feats, cb, c2 = _rvq_operands(cuda, 8)
    n = rvq_kernel.RVQ.launches
    rvq_kernel.rvq_encode(feats, cb, c2, 46)
    rvq_kernel.rvq_encode(feats, cb, c2, 3)
    rvq_kernel.rvq_encode(feats.cpu(), cb.cpu(), c2.cpu(), 46)  # plain
    assert rvq_kernel.RVQ.launches == n + 2
    buf = torch.empty(cb.numel() + 1, device=cuda)
    off = buf[1:].view(cb.shape)  # contiguous, 4 bytes off 16
    off.copy_(cb)
    with pytest.raises(ValueError, match="16-byte"):
        rvq_kernel.rvq_encode(feats, off, c2, 46)
    assert rvq_kernel.RVQ.launches == n + 2


def test_launcher_rvq_plan_matches_planner(cuda):
    lib = rvq_kernel._lib()
    out = (ctypes.c_int * 3)()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for batch in (1, 3, 777, 1024, 4096, 16384, 70000):
        for stages in (1, 16, 46):
            for n_sm in (sms, 132, 7):
                lib.lyra_rvq_plan(batch, stages, n_sm, out)
                assert tuple(out) == rvq_kernel.rvq_plan(batch, stages, n_sm)


@pytest.mark.parametrize("name,shape", [("soundstream_encoder", (320,)),
                                        ("lyragan", (1, 64))])
def test_fused_stack_matches_executor_on_card(cuda, name, shape):
    path = os.path.join(SMALL, f"{name}.tflite")
    fused, graph = FusedStack(path, device=cuda), load_graph(path, device=cuda)
    fs, gs = fused.init_state(8), graph.init_state(8)
    rng = np.random.default_rng(1)
    for _ in range(20):
        x = _t(rng.normal(0, 0.1, (8,) + shape), cuda)
        y, fs = fused(fs, x)
        o, gs = graph(gs, input_audio=x)
        r = o["output_0"]
        assert (y - r).abs().max().item() <= 1e-5 * r.abs().max().item()


FULL = os.path.join(os.path.dirname(SMALL), "full")


def _fused_operands(launch, batch, dev, dtype, rng):
    """Random x, state and residual of one fused launch's shapes."""
    t_x, c_x = launch.x_shape
    x = _t(rng.normal(size=(batch, t_x, c_x)), dev).to(dtype)
    state = res = None
    if launch.state is not None:
        t_s = launch.in_shape[0] - t_x
        state = _t(rng.normal(size=(batch, t_s, c_x)), dev).to(dtype)
    if launch.res is not None:
        res = _t(rng.normal(size=(batch,) + launch.out_shape), dev).to(dtype)
    return x, state, res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fixture", ["small", "full"])
@pytest.mark.parametrize("name", ["soundstream_encoder", "lyragan"])
def test_fused_launches_match_plain(cuda, name, fixture, dtype):
    """Every fused launch of a hop (each pattern: residual unit, strided
    conv with state, SPLIT + transpose convs with ADD/SUB and crop, single
    cropped transpose conv, LEAKY on load) vs its plain version: f32
    within 1e-5, bf16 within 2^-7 of max|plain|; the new state rows (a
    copy) bit for bit; one count per launch."""
    path = os.path.join(FULL if fixture == "full" else SMALL, f"{name}.tflite")
    fused = FusedStack(path, mode="float" if dtype == torch.float32
                       else "bf16", device=cuda)
    rng = np.random.default_rng(7)
    for batch in (3, 64):
        for launch in fused.plan:
            x, state, res = _fused_operands(launch, batch, cuda, dtype, rng)
            n = launch.kernel.launches
            got, ref = launch(x, state, res), launch.plain(x, state, res)
            assert launch.kernel.launches == n + 1
            if launch.side is not None:
                (got, side), (ref, side_ref) = got, ref
                assert torch.equal(side, side_ref), launch.op
            assert got.shape == ref.shape, launch.op
            bar = 1e-5 if dtype == torch.float32 else BF16_BAR
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= bar * ref.float().abs().max().item(), (launch.op,
                                                                 err)


@pytest.mark.parametrize("name,shape", [("soundstream_encoder", (320,)),
                                        ("lyragan", (1, 64))])
def test_fused_stack_f32_is_bitwise_unfused(cuda, name, shape):
    """In f32 the fused stack gives the bits of the unfused kernel path
    (the same kernels without fused operands, every other op a torch op),
    output and state, over 10 frames with state carried."""
    fused = FusedStack(os.path.join(FULL, f"{name}.tflite"), device=cuda)
    fs = us = fused.init_state(8)
    rng = np.random.default_rng(3)
    for _ in range(10):
        x = _t(rng.normal(0, 0.1, (8,) + shape), cuda)
        y, fs = fused(fs, x)
        u, us = fused.unfused(us, x)
        assert torch.equal(y, u)
        for k in us:
            assert torch.equal(fs[k], us[k]), k


def test_engines_tick_on_card(cuda):
    enc = EncoderEngine(16000, SMALL, device=cuda)
    dec = DecoderEngine(16000, SMALL, device=cuda)
    es, ds = enc.init_state(16), dec.init_state(16)
    audio = _t(np.random.default_rng(2).normal(0, 3000, (16, 320)), cuda)
    idx, _, es = enc.step(es, audio, 46)
    out, _, ds = dec.step(ds, idx, torch.ones(16, dtype=torch.bool,
                                              device=cuda))
    assert out.device.type == "cuda" and bool(torch.isfinite(out).all())


def _bf16(a, dev):
    return _t(a, dev).to(torch.bfloat16)


def _close_bf16(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= BF16_BAR * ref.float().abs().max().item(), err


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (5, 1), (1, 4)])
def test_conv1d_bf16_kernel_matches_plain(cuda, stride, groups):
    rng = np.random.default_rng(stride * 10 + groups)
    x = _bf16(rng.normal(size=(5, 23, 64)), cuda)
    w = _bf16(rng.normal(size=(4, 64 // groups, 48)), cuda)
    b = _bf16(rng.normal(size=(48,)), cuda)
    n, n32 = conv_stack.CONV1D_BF16.launches, conv_stack.CONV1D.launches
    y = conv_stack.conv1d(x, w, b, stride)
    assert conv_stack.CONV1D_BF16.launches == n + 1
    assert conv_stack.CONV1D.launches == n32
    _close_bf16(y, conv_stack.conv1d_plain(x, w, b, stride))


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_depthwise_bf16_kernel_matches_plain(cuda, dilation):
    rng = np.random.default_rng(dilation)
    x = _bf16(rng.normal(size=(5, 2 * dilation + 7, 32)), cuda)
    w = _bf16(rng.normal(size=(3, 32)), cuda)
    b = _bf16(rng.normal(size=(32,)), cuda)
    n = conv_stack.DEPTHWISE_BF16.launches
    y = conv_stack.depthwise_conv1d(x, w, b, dilation)
    assert conv_stack.DEPTHWISE_BF16.launches == n + 1
    _close_bf16(y, conv_stack.depthwise_conv1d_plain(x, w, b, dilation))


@pytest.mark.parametrize("stride,k,t_out", [(2, 4, 8), (5, 10, 45), (4, 52, 100)])
def test_transpose_conv_bf16_kernel_matches_plain(cuda, stride, k, t_out):
    rng = np.random.default_rng(k)
    x = _bf16(rng.normal(size=(3, 9, 16)), cuda)
    w = _bf16(rng.normal(size=(k, 16, 24)), cuda)
    b = _bf16(rng.normal(size=(24,)), cuda)
    t_out = min(t_out, (9 - 1) * stride + k)
    n = conv_stack.TCONV_BF16.launches
    y = conv_stack.transpose_conv1d(x, w, b, stride, t_out)
    assert conv_stack.TCONV_BF16.launches == n + 1
    _close_bf16(y, conv_stack.transpose_conv1d_plain(x, w, b, stride, t_out))


def test_conv_wrappers_refuse_mixed_or_other_dtypes(cuda):
    x = torch.zeros((2, 8, 16), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((3, 16, 8), device=cuda)
    with pytest.raises(ValueError):
        conv_stack.conv1d(x, w, None, 1)  # bf16 activations, f32 weights
    with pytest.raises(ValueError):
        conv_stack.conv1d(x.half(), w.half(), None, 1)
    with pytest.raises(ValueError):
        conv_stack.depthwise_conv1d(x, torch.zeros((3, 16), device=cuda),
                                    None, 1)


def test_resampler_on_card_matches_goldens(cuda):
    data = np.load(GOLDENS)
    for key in sorted({k[3:] for k in data.files if k.startswith("in_")}):
        rates = tuple(int(v) for v in key.split("_"))
        r = Resampler(*rates, device=cuda)
        x, want = data[f"in_{key}"], data[f"out_{key}"]
        block = rates[0] // 50
        state, got = r.init_state(x.shape[0]), []
        for i in range(x.shape[1] // block):
            y, state = r.resample(state, _t(x[:, i * block:(i + 1) * block], cuda))
            got.append(y.cpu().numpy())
        assert np.abs(np.concatenate(got, axis=1) - want).max() <= 0.05, key


@pytest.mark.parametrize("name,shape", [("soundstream_encoder", (320,)),
                                        ("lyragan", (1, 64))])
def test_fused_stack_bf16_matches_executor_bf16_on_card(cuda, name, shape):
    path = os.path.join(SMALL, f"{name}.tflite")
    fused = FusedStack(path, mode="bf16", device=cuda)
    graph = load_graph(path, mode="bf16", device=cuda)
    fs, gs = fused.init_state(8), graph.init_state(8)
    rng = np.random.default_rng(1)
    for _ in range(20):
        x = _t(rng.normal(0, 0.1, (8,) + shape), cuda)
        y, fs = fused(fs, x)
        o, gs = graph(gs, input_audio=x)
        r = o["output_0"]
        assert (y - r).abs().max().item() <= 3e-2 * r.abs().max().item()


def test_bf16_engines_tick_at_48k_on_card(cuda):
    enc = EncoderEngine(48000, SMALL, mode="bf16", device=cuda)
    dec = DecoderEngine(48000, SMALL, mode="bf16", device=cuda)
    es, ds = enc.init_state(16), dec.init_state(16)
    audio = _t(np.random.default_rng(2).normal(0, 3000, (16, 960)), cuda)
    before = [k.launches for k in conv_stack.KERNELS_BF16]
    idx, _, es = enc.step(es, audio, 46)
    out, _, ds = dec.step(ds, idx, torch.ones(16, dtype=torch.bool,
                                              device=cuda))
    assert out.shape == (16, 960) and bool(torch.isfinite(out).all())
    after = [k.launches for k in conv_stack.KERNELS_BF16]
    assert all(a > b for a, b in zip(after, before))


def _conv_operands(rng, batch, t_in, c_in, k, i_f, o, dev,
                   dtype=torch.bfloat16):
    x = _t(rng.normal(size=(batch, t_in, c_in)), dev).to(dtype)
    w = _t(rng.normal(0.0, (k * i_f) ** -0.5, (k, i_f, o)), dev).to(dtype)
    return x, w, _t(rng.normal(size=(o,)), dev).to(dtype)


def _close_f32(got, ref):
    """One f32 kernel call: within 1e-5 × max|plain| (both sum in f32, in
    different orders)."""
    assert got.dtype == ref.dtype == torch.float32
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("shape", FULL_CONV1D + RAGGED_CONV1D)
def test_conv1d_f32_gemm_matches_plain(cuda, shape, batch):
    t_in, c_in, k, i_f, o, stride = shape
    x, w, b = _conv_operands(np.random.default_rng(t_in * k + o), batch,
                             t_in, c_in, k, i_f, o, cuda, torch.float32)
    n = conv_stack.CONV1D.launches
    _close_f32(conv_stack.conv1d(x, w, b, stride),
               conv_stack.conv1d_plain(x, w, b, stride))
    assert conv_stack.CONV1D.launches == n + 1


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("shape", FULL_TCONV + RAGGED_TCONV)
def test_transpose_conv_f32_gemm_matches_plain(cuda, shape, batch):
    t_in, i, k, o, stride, t_out = shape
    x, w, b = _conv_operands(np.random.default_rng(t_in * k + o), batch,
                             t_in, i, k, i, o, cuda, torch.float32)
    n = conv_stack.TCONV.launches
    _close_f32(conv_stack.transpose_conv1d(x, w, b, stride, t_out),
               conv_stack.transpose_conv1d_plain(x, w, b, stride, t_out))
    assert conv_stack.TCONV.launches == n + 1


def test_f32_gemm_kernels_are_deterministic(cuda):
    rng = np.random.default_rng(9)
    for shape in ((84, 64, 5, 64, 64, 1), (6, 256, 4, 256, 512, 2),
                  (40, 8, 1, 2, 8, 1)):
        t_in, c_in, k, i_f, o, stride = shape
        x, w, b = _conv_operands(rng, 1024, t_in, c_in, k, i_f, o, cuda,
                                 torch.float32)
        assert torch.equal(conv_stack.conv1d(x, w, b, stride),
                           conv_stack.conv1d(x, w, b, stride)), shape
    for shape in ((9, 64, 10, 64, 5, 50), (3, 6, 4, 10, 2, 7)):
        t_in, i, k, o, stride, t_out = shape
        x, w, b = _conv_operands(rng, 1024, t_in, i, k, i, o, cuda,
                                 torch.float32)
        assert torch.equal(conv_stack.transpose_conv1d(x, w, b, stride, t_out),
                           conv_stack.transpose_conv1d(x, w, b, stride, t_out))


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("shape", FULL_CONV1D + RAGGED_CONV1D)
def test_conv1d_bf16_gemm_matches_plain(cuda, shape, batch):
    t_in, c_in, k, i_f, o, stride = shape
    x, w, b = _conv_operands(np.random.default_rng(t_in * k + o), batch,
                             t_in, c_in, k, i_f, o, cuda)
    _close_bf16(conv_stack.conv1d(x, w, b, stride),
                conv_stack.conv1d_plain(x, w, b, stride))


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("shape", FULL_TCONV + RAGGED_TCONV)
def test_transpose_conv_bf16_gemm_matches_plain(cuda, shape, batch):
    t_in, i, k, o, stride, t_out = shape
    x, w, b = _conv_operands(np.random.default_rng(t_in * k + o), batch,
                             t_in, i, k, i, o, cuda)
    _close_bf16(conv_stack.transpose_conv1d(x, w, b, stride, t_out),
                conv_stack.transpose_conv1d_plain(x, w, b, stride, t_out))


def test_bf16_gemm_kernels_are_deterministic(cuda):
    rng = np.random.default_rng(7)
    x, w, b = _conv_operands(rng, 1024, 84, 64, 5, 64, 64, cuda)
    assert torch.equal(conv_stack.conv1d(x, w, b, 1),
                       conv_stack.conv1d(x, w, b, 1))
    x, w, b = _conv_operands(rng, 1024, 9, 64, 10, 64, 64, cuda)
    assert torch.equal(conv_stack.transpose_conv1d(x, w, b, 5, 50),
                       conv_stack.transpose_conv1d(x, w, b, 5, 50))


def test_bf16_gemm_launch_counters(cuda):
    x, w, b = _conv_operands(np.random.default_rng(8), 4, 8, 32, 3, 32, 16,
                             cuda)
    counters = (conv_stack.CONV1D_BF16, conv_stack.TCONV_BF16,
                *conv_stack.KERNELS_F32)
    before = [k.launches for k in counters]
    conv_stack.conv1d(x, w, b, 1)
    assert [k.launches for k in counters] == [before[0] + 1, *before[1:]]
    conv_stack.transpose_conv1d(x, w, b, 2, 17)  # w [K, I, O] = [3, 32, 16]
    assert [k.launches for k in counters] == [before[0] + 1, before[1] + 1,
                                              *before[2:]]


def test_launcher_tile_matches_planner(cuda):
    lib = conv_stack._lib()
    for batch, dtype in ((1, torch.float32), (64, torch.float32),
                         (1024, torch.float32), (1, torch.bfloat16),
                         (64, torch.bfloat16), (1024, torch.bfloat16)):
        plans = [conv_stack.conv1d_plan((batch, t_in, c_in), (k, i_f, o), s,
                                        dtype=dtype)
                 for t_in, c_in, k, i_f, o, s in FULL_CONV1D + RAGGED_CONV1D]
        plans += [conv_stack.transpose_conv1d_plan((batch, t_in, i), (k, i, o),
                                                   s, t_out, dtype=dtype)
                  for t_in, i, k, o, s, t_out in FULL_TCONV + RAGGED_TCONV]
        for plan in plans:
            assert lib.lyra_conv_gemm_tile(*plan.dims) == plan.tile, plan


def _dw_operands(shape, batch, dev, dtype):
    t_in, c, dilation, k = (*shape, 3)[:4]
    rng = np.random.default_rng(t_in * 100 + c + dilation)
    x = _t(rng.normal(size=(batch, t_in, c)), dev).to(dtype)
    w = _t(rng.normal(0.0, 3 ** -0.5, (k, c)), dev).to(dtype)
    return x, w, _t(rng.normal(size=(c,)), dev).to(dtype), dilation


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("shape", FULL_DEPTHWISE + RAGGED_DEPTHWISE)
def test_depthwise_f32_matches_plain(cuda, shape, batch):
    x, w, b, d = _dw_operands(shape, batch, cuda, torch.float32)
    n = conv_stack.DEPTHWISE.launches
    _close_f32(conv_stack.depthwise_conv1d(x, w, b, d),
               conv_stack.depthwise_conv1d_plain(x, w, b, d))
    assert conv_stack.DEPTHWISE.launches == n + 1


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("shape", FULL_DEPTHWISE + RAGGED_DEPTHWISE)
def test_depthwise_bf16_matches_plain(cuda, shape, batch):
    x, w, b, d = _dw_operands(shape, batch, cuda, torch.bfloat16)
    n = conv_stack.DEPTHWISE_BF16.launches
    _close_bf16(conv_stack.depthwise_conv1d(x, w, b, d),
                conv_stack.depthwise_conv1d_plain(x, w, b, d))
    assert conv_stack.DEPTHWISE_BF16.launches == n + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_scalar_path_on_misaligned_x(cuda, dtype):
    """x a contiguous view whose storage offset is not 16-byte aligned:
    the launcher takes one channel per thread."""
    x, w, b, d = _dw_operands((46, 64, 3), 64, cuda, dtype)
    buf = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    got = conv_stack.depthwise_conv1d(xm, w, b, d)
    assert torch.equal(got, conv_stack.depthwise_conv1d(x, w, b, d))
    ref = conv_stack.depthwise_conv1d_plain(x, w, b, d)
    (_close_f32 if dtype == torch.float32 else _close_bf16)(got, ref)


def test_depthwise_kernels_are_deterministic(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FULL_DEPTHWISE:
            x, w, b, d = _dw_operands(shape, 1024, cuda, dtype)
            assert torch.equal(conv_stack.depthwise_conv1d(x, w, b, d),
                               conv_stack.depthwise_conv1d(x, w, b, d)), shape


def test_depthwise_launch_counters(cuda):
    x, w, b, d = _dw_operands((14, 16, 3), 4, cuda, torch.bfloat16)
    counters = conv_stack.KERNELS
    before = [k.launches for k in counters]
    conv_stack.depthwise_conv1d(x, w, b, d)
    conv_stack.depthwise_conv1d(x.float(), w.float(), b.float(), d)
    want = [n + (k in (conv_stack.DEPTHWISE, conv_stack.DEPTHWISE_BF16))
            for k, n in zip(counters, before)]
    assert [k.launches for k in counters] == want


def test_launcher_depthwise_plan_matches_planner(cuda):
    """The plan the launcher takes for given operands, aligned or with x a
    view off 16 bytes, is conv_stack.depthwise_plan's."""
    lib = conv_stack._lib()
    out = (ctypes.c_int * 7)()
    for batch in (1, 3, 64, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            for shape in FULL_DEPTHWISE + RAGGED_DEPTHWISE:
                t_in, c, d, k = (*shape, 3)[:4]
                x, w, b, _ = _dw_operands(shape, batch, cuda, dtype)
                t_out = t_in - (k - 1) * d
                o = torch.empty((batch, t_out, c), device=cuda, dtype=dtype)
                for aligned in (True, False):
                    xp = x.data_ptr() + (0 if aligned else x.element_size())
                    plan = conv_stack.depthwise_plan(
                        (batch, t_in, c), k, d, dtype=dtype, aligned=aligned)
                    lib.lyra_depthwise_plan(x.element_size(), batch, t_out,
                                            c, k, d, xp, w.data_ptr(),
                                            b.data_ptr(), o.data_ptr(), out)
                    assert tuple(out) == (plan.elems, plan.runs, *plan.block,
                                          *plan.grid), (shape, batch, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_batch_past_the_grid_limit(cuda, dtype):
    """More streams than grid z holds (65535) go in further launches of
    one wrapper call, which the counter counts once."""
    x, w, b, d = _dw_operands((5, 8, 1), 70000, cuda, dtype)
    n = conv_stack.BY_DTYPE[dtype][1].launches
    got = conv_stack.depthwise_conv1d(x, w, b, d)
    assert conv_stack.BY_DTYPE[dtype][1].launches == n + 1
    ref = conv_stack.depthwise_conv1d_plain(x, w, b, d)
    (_close_f32 if dtype == torch.float32 else _close_bf16)(got, ref)


# -- the compiled tick: CUDA-graph capture (utils/capture.py) ----------------


def _tick_inputs(rate, ticks, batch, seed=3):
    rng = np.random.default_rng(seed)
    hop = rate // 50
    audio = np.clip(rng.normal(0, 3000, (ticks, batch, hop)), -32768,
                    32767).astype(np.float32)
    received = rng.random((ticks, batch)) < 0.85
    received[8:14, ::3] = False  # concealment, the fade and comfort noise
    return audio, received


def _assert_trees_equal(a, b):
    for (pa, x), (pb, y) in zip(capture.leaves(a), capture.leaves(b)):
        assert pa == pb and x.dtype == y.dtype
        assert torch.equal(x, y), pa


@pytest.mark.parametrize("mode,rate", [("float", 16000), ("float", 48000),
                                       ("bf16", 16000), ("bf16", 48000)])
def test_captured_step_is_bitwise_eager(cuda, mode, rate):
    """20 ticks of both engines' captured `step` equal eager `_step_impl`
    bit for bit, with a `reset_rows` at tick 10 (one replay, equal to the
    eager `mask_tree`, its input tree left as it was)."""
    b, nq = 8, 30
    enc = EncoderEngine(rate, SMALL, mode=mode, device=cuda)
    dec = DecoderEngine(rate, SMALL, mode=mode, device=cuda)
    audio, received = _tick_inputs(rate, 20, b)
    es_c = es_e = enc.init_state(b)
    ds_c = ds_e = dec.init_state(b, seed=4)
    mask = np.zeros(b, bool)
    mask[[1, 6]] = True
    for t in range(20):
        if t == 10:
            es_in, ds_in = es_c, ds_c
            kept = [v.clone() for _, v in capture.leaves(es_in)
                    + capture.leaves(ds_in)]
            es_c = enc.reset_rows(es_c, mask)
            ds_c = dec.reset_rows(ds_c, mask, seed=4)
            assert es_c is not es_in and ds_c is not ds_in  # the other tree
            for (_, v), k in zip(capture.leaves(es_in)
                                 + capture.leaves(ds_in), kept):
                assert torch.equal(v, k)
            m = torch.tensor(mask, device=cuda)
            es_e = mask_tree(m, enc.init_state(b), es_e)
            ds_e = mask_tree(m, dec.init_state(b, seed=4), ds_e)
            _assert_trees_equal(es_c, es_e)
            _assert_trees_equal(ds_c, ds_e)
        x = torch.tensor(audio[t], device=cuda)
        nq_t = torch.full((b,), nq, dtype=torch.int32, device=cuda)
        idx_c, noise_c, es_c = enc.step(es_c, audio[t], nq)
        idx_e, noise_e, es_e = enc._step_impl(es_e, x, nq_t)
        assert torch.equal(idx_c, idx_e) and torch.equal(noise_c, noise_e), t
        r = torch.tensor(received[t], device=cuda)
        out_c, cn_c, ds_c = dec.step(ds_c, idx_e.cpu().numpy(), received[t])
        out_e, cn_e, ds_e = dec._step_impl(ds_e, idx_e, r)
        assert torch.equal(out_c, out_e) and torch.equal(cn_c, cn_e), t
        _assert_trees_equal(es_c, es_e)
        _assert_trees_equal(ds_c, ds_e)


def test_captured_step_never_writes_its_input_and_keeps_two_trees(cuda):
    """A tree fed in is never written; a tree returned stays valid through
    one more replay and is reused by the second (the ping-pong pair)."""
    enc = EncoderEngine(16000, SMALL, device=cuda)
    audio, _ = _tick_inputs(16000, 4, 4)
    s0 = enc.init_state(4)
    s0_copy = {k: v.clone() for k, v in capture.leaves(s0)}
    _, _, r1 = enc.step(s0, audio[0], 16)
    _, _, r1_ref = enc._step_impl(s0, torch.tensor(audio[0], device=cuda),
                                  torch.full((4,), 16, dtype=torch.int32,
                                             device=cuda))
    for p, v in capture.leaves(s0):
        assert torch.equal(v, s0_copy[p]), p
    r1_copy = {k: v.clone() for k, v in capture.leaves(r1)}
    _, _, r2 = enc.step(r1, audio[1], 16)
    assert r2 is not r1
    for p, v in capture.leaves(r1):
        assert torch.equal(v, r1_copy[p]), p  # valid through one replay
    _assert_trees_equal(r1, r1_ref)
    _, _, r3 = enc.step(r2, audio[2], 16)
    assert r3 is r1  # the second replay reuses it
    _, _, r4 = enc.step(s0, audio[0], 16)  # a foreign tree again
    for p, v in capture.leaves(s0):
        assert torch.equal(v, s0_copy[p]), p
    _assert_trees_equal(r4, r1_ref)


def test_capture_errors_raise_and_never_run_eagerly(cuda, monkeypatch):
    """A launch error inside the capture raises (again on the next call:
    nothing falls back to eager), and so does a failed replay."""
    from lyra_tpu_torch.ops import cuda_build

    dec = DecoderEngine(16000, SMALL, device=cuda)
    ds = dec.init_state(4)
    idx = np.zeros((4, 46), np.int32)
    rec = np.ones(4, bool)
    check = cuda_build.check

    def fail_in_capture(err, kernel):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"injected launch error in {kernel}")
        check(err, kernel)

    monkeypatch.setattr(cuda_build, "check", fail_in_capture)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected launch error"):
            dec.step(ds, idx, rec)
    monkeypatch.setattr(cuda_build, "check", check)
    out, _, ds2 = dec.step(ds, idx, rec)
    ref, _, _ = dec._step_impl(ds, torch.tensor(idx, device=cuda),
                               torch.tensor(rec, device=cuda))
    assert torch.equal(out, ref)

    def fail_replay(self):
        raise RuntimeError("injected replay error")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", fail_replay)
    with pytest.raises(RuntimeError, match="injected replay error"):
        dec.step(ds2, idx, rec)


def test_servers_on_card_match_eager_servers(cuda):
    """The servers' captured wire programs (uniform, mixed, async) equal
    the same servers on eager engines bit for bit."""
    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    def pair(graphs):
        enc = EncoderEngine(16000, SMALL, device=cuda)
        dec = DecoderEngine(16000, SMALL, emit_dtype="int16", device=cuda)
        if not graphs:
            enc.graphs = dec.graphs = None
        e, d = EncoderServer(8, engine=enc, bitrate=6000), DecoderServer(
            8, engine=dec)
        for srv in (e, d):
            srv.add_streams(range(7))
        e.set_bitrate(3, 9200)
        return e, d

    audio, received = _tick_inputs(16000, 12, 8)
    pcm = audio.astype(np.int16)
    runs = []
    for graphs in (True, False):
        enc, dec = pair(graphs)
        outs = []
        for t in range(12):
            if t == 6:
                for srv in (enc, dec):
                    srv.remove_stream(2)
                    srv.add_stream(9)
            wire, sizes = enc.tick_wire(pcm[t])
            if t % 2:
                a = dec.tick_wire(wire, received[t] & (sizes > 0), sizes)
            else:
                a = dec.tick_wire(wire[:, :15], received[t] & (sizes == 15))
            outs.append((wire, sizes, a, dec._last_comfort.copy()))
        a_async = [dec.tick_wire_async(w, received[t] & (s > 0), s)
                   for t, (w, s, _, _) in enumerate(outs)]
        a_async.append(dec.flush_async())
        outs.append(a_async)
        runs.append(outs)
    for t in range(12):
        for got, want in zip(runs[0][t], runs[1][t]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(runs[0][12][t + 1], runs[1][12][t + 1])


def test_servers_sharing_an_engine_keep_their_own_state(cuda):
    """Two live server pairs on one pair of engines, ticking in turn on
    different audio, each equal bit for bit to a pair on eager engines of
    its own: a server's graphs and state trees are its own."""
    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer

    def engines(graphs):
        enc = EncoderEngine(16000, SMALL, device=cuda)
        dec = DecoderEngine(16000, SMALL, emit_dtype="int16", device=cuda)
        if not graphs:
            enc.graphs = dec.graphs = None
        return enc, dec

    def pair(enc, dec, seed):
        e, d = (EncoderServer(8, engine=enc, bitrate=6000),
                DecoderServer(8, engine=dec, seed=seed))
        for srv in (e, d):
            srv.add_streams(range(8))
        return e, d

    audio, received = _tick_inputs(16000, 10, 8)
    pcm = [audio.astype(np.int16), (audio[:, ::-1] * 0.5).astype(np.int16)]
    shared = engines(True)
    pairs = [(pair(*shared, i), pair(*engines(False), i)) for i in (0, 1)]
    for t in range(10):
        for i, (on_shared, alone) in enumerate(pairs):
            if t == 5:  # admission on one server of the shared engines
                for srv in (*on_shared, *alone):
                    srv.remove_stream(3)
                    srv.add_stream(20 + i)
            got = []
            for enc, dec in (on_shared, alone):
                wire, sizes = enc.tick_wire(pcm[i][t])
                got.append((wire, sizes, dec.tick_wire(
                    wire, received[t] & (sizes > 0), sizes)))
            for a, b in zip(*got):
                np.testing.assert_array_equal(a, b, err_msg=f"pair {i} t {t}")
