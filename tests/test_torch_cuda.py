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
