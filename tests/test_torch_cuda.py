"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

These need an NVIDIA GPU with `nvcc` (the kernels are built from
lyra_tpu_torch/ops/csrc/ on first use) and skip elsewhere.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py configures jax, which that machine
lacks.)

chip_smoke.py runs the same comparisons at the full fixture's widths.
"""

import os

import numpy as np
import pytest
import torch

from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.dsp.resampler import Resampler
from lyra_tpu_torch.ops import conv_stack, rvq_kernel
from lyra_tpu_torch.ops.fused_stack import FusedStack
from lyra_tpu_torch.tflite.executor import load_graph

pytestmark = pytest.mark.cuda

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
GOLDENS = os.path.join(os.path.dirname(__file__), "golden",
                       "resampler_goldens.npz")
BF16_BAR = 2.0 ** -7  # two bf16 roundings: the kernel's and cuDNN's

# Every distinct conv1d and transpose-conv call of one hop of the full-width
# fixture (FusedStack(...).conv_launches() on tests/golden/synthetic_lyra/
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


def test_rvq_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    cb = _t(rng.normal(0, 0.5, (46, 16, 64)), cuda)
    c2 = (cb * cb).sum(-1).contiguous()
    feats = _t(rng.normal(size=(777, 64)), cuda)
    n = rvq_kernel.RVQ.launches
    got = rvq_kernel.rvq_encode(feats, cb, c2, 46)
    assert rvq_kernel.RVQ.launches == n + 1
    ref = rvq_kernel.rvq_encode_plain(feats, cb, c2, 46)
    assert (got != ref).any(dim=1).float().mean().item() <= 0.001
    assert torch.equal(rvq_kernel.rvq_encode(feats, cb, c2, 16),
                       got[:, :16])


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


def _conv_operands(rng, batch, t_in, c_in, k, i_f, o, dev):
    x = _bf16(rng.normal(size=(batch, t_in, c_in)), dev)
    w = _bf16(rng.normal(0.0, (k * i_f) ** -0.5, (k, i_f, o)), dev)
    return x, w, _bf16(rng.normal(size=(o,)), dev)


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
    for batch in (1, 64, 1024):
        plans = [conv_stack.conv1d_plan((batch, t_in, c_in), (k, i_f, o), s)
                 for t_in, c_in, k, i_f, o, s in FULL_CONV1D + RAGGED_CONV1D]
        plans += [conv_stack.transpose_conv1d_plan((batch, t_in, i), (k, i, o),
                                                   s, t_out)
                  for t_in, i, k, o, s, t_out in FULL_TCONV + RAGGED_TCONV]
        for plan in plans:
            assert lib.lyra_conv_gemm_tile(*plan.dims) == plan.tile, plan
