"""The index maps of the bf16 implicit-GEMM conv kernels, on the CPU.

conv1d_fwd_bf16 and transpose_conv1d_fwd_bf16 (ops/csrc/conv_stack.cu) run
only on the card; what they compute rests on two maps that numpy can check
here:

  (a) the transpose conv as `stride` per-phase GEMMs: output phase p owns
      the rows t = j·s + p < t_out, its q_p = ceil((K − p)/s) taps are
      weight rows p + a·s and read input row j − a (zero outside
      [0, T_in)).  Written out below, it equals the port's plain version
      and the JAX package's TRANSPOSE_CONV lowering
      (lyra_tpu/tflite/executor.py `_transpose_conv`) on the same inputs;
  (b) the launchers' tile plan (conv_stack.conv1d_plan /
      transpose_conv1d_plan; tests/test_torch_cuda.py holds the launchers
      to it on the card): its blocks cover every output element of every
      conv call of both fixtures exactly once, at B ∈ {1, 64, 1024}, within
      Hopper's shared memory, and the scalar-load path is taken exactly
      for the shapes the 16-byte path cannot take.
"""

import functools
import os

import numpy as np
import pytest
import torch

from lyra_tpu.tflite.executor import _transpose_conv as jax_transpose_conv
from lyra_tpu_torch.ops import conv_stack
from lyra_tpu_torch.ops.fused_stack import FusedStack
from test_torch_cuda import FULL_CONV1D, FULL_TCONV

FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra")
MODELS = ("soundstream_encoder", "lyragan")
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper


def phase_gemm_transpose_conv(x, w, bias, stride, t_out):
    """x [B, T_in, I], w [K, I, O], bias [O] → [B, t_out, O] as the kernel
    computes it: one GEMM per output phase, A[(b, j), (a, i)] = x[b, j −
    a, i], W[(a, i), o] = w[p + a·stride, i, o]."""
    b, t_in, i = x.shape
    k, _, o = w.shape
    out = np.zeros((b, t_out, o))
    for p in range(stride):
        rows = -(-(t_out - p) // stride) if t_out > p else 0
        taps = -(-(k - p) // stride) if k > p else 0
        a_mat = np.zeros((b, rows, taps, i))
        for j in range(rows):
            for a in range(taps):
                if 0 <= j - a < t_in:
                    a_mat[:, j, a] = x[:, j - a]
        w_mat = w[p::stride][:taps].reshape(taps * i, o)
        out[:, p::stride] = (a_mat.reshape(b * rows, taps * i)
                             @ w_mat).reshape(b, rows, o)
    return out + bias


@pytest.mark.parametrize("k", [4, 5, 10, 52])
@pytest.mark.parametrize("stride", [2, 4, 5])
def test_per_phase_transpose_conv_matches_plain_and_jax(stride, k):
    rng = np.random.default_rng(stride * 100 + k)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(k, 6, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    full = (7 - 1) * stride + k
    # The JAX lowering: NHWC input, TFLite weight [O, K, 1, I], all rows.
    jax_full = np.asarray(jax_transpose_conv(
        x[:, :, None, :], np.transpose(w, (2, 0, 1))[:, :, None, :], bias,
        {"padding": "VALID", "stride_h": stride, "stride_w": 1},
        (2, full, 1, 5)))[:, :, 0, :]
    assert jax_full.shape == (2, full, 5)
    for t_out in (full, full - stride - 1, (7 - 1) * stride + 1):
        got = phase_gemm_transpose_conv(x.astype(np.float64), w, bias,
                                        stride, t_out)
        plain = conv_stack.transpose_conv1d_plain(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            stride, t_out).numpy()
        scale = np.abs(got).max()
        np.testing.assert_allclose(plain, got, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(jax_full[:, :t_out], got, rtol=0,
                                   atol=1e-5 * scale)


@functools.lru_cache(maxsize=None)
def _gemm_calls(fixture):
    """(kind, x [T_in, C_in], w shape, extra) of every conv1d and transpose
    conv call of one hop of both graphs of `fixture`."""
    calls = []
    for model in MODELS:
        fused = FusedStack(os.path.join(FIXTURES, fixture, f"{model}.tflite"))
        for launch in fused.conv_launches():
            kind = {conv_stack.conv1d_plain: "conv1d",
                    conv_stack.transpose_conv1d_plain: "tconv"}.get(launch.plain)
            if kind:
                calls.append((kind, launch.in_shape, tuple(launch.w.shape),
                              launch.extra))
    return calls


def test_full_fixture_shape_lists_match_the_fixture():
    conv1d, tconv = [], []
    for kind, (t_in, c_in), (k, i, o), extra in _gemm_calls("full"):
        if kind == "conv1d":
            conv1d.append((t_in, c_in, k, i, o, *extra))
        else:
            tconv.append((t_in, i, k, o, *extra))
    assert list(dict.fromkeys(conv1d)) == FULL_CONV1D
    assert list(dict.fromkeys(tconv)) == FULL_TCONV


def _coverage(kind, batch, t_in, c_in, w_shape, extra, plan):
    """How often the plan's blocks write each output element, walking the
    grid as the kernel's epilogue does."""
    k, i_f, o = w_shape
    bm, bn = plan.block
    _, n_cols, layers = plan.dims
    if kind == "conv1d":
        t_out = (t_in - k) // extra[0] + 1
    else:
        stride, t_out = extra
    hits = np.zeros((batch, t_out, o), np.int32)
    for z in range(layers):
        if kind == "conv1d":  # z = group; rows (b, t); columns z·N + n
            rows, cols0 = batch * t_out, z * n_cols
        else:  # z = output phase; rows (b, j) for t = j·stride + z
            n_j = -(-(t_out - z) // stride) if t_out > z else 0
            rows, cols0 = batch * n_j, 0
        for bx in range(plan.grid[0]):
            m = np.arange(bx * bm, (bx + 1) * bm)
            m = m[m < rows]
            if kind == "conv1d":
                b_idx, t_idx = np.divmod(m, t_out)
            else:
                b_idx, j_idx = np.divmod(m, n_j)
                t_idx = j_idx * stride + z
            for by in range(plan.grid[1]):
                n = np.arange(by * bn, (by + 1) * bn)
                n = cols0 + n[n < n_cols]
                np.add.at(hits, (b_idx[:, None], t_idx[:, None], n[None, :]),
                          1)
    return hits


@pytest.mark.parametrize("batch", [1, 64, 1024])
@pytest.mark.parametrize("fixture", ["small", "full"])
def test_gemm_plan_covers_every_output_once(fixture, batch):
    for kind, (t_in, c_in), w_shape, extra in _gemm_calls(fixture):
        k, i_f, o = w_shape
        x_shape = (batch, t_in, c_in)
        if kind == "conv1d":
            plan = conv_stack.conv1d_plan(x_shape, w_shape, *extra)
            ragged = i_f % 8 or (o // (c_in // i_f)) % 8
        else:
            plan = conv_stack.transpose_conv1d_plan(x_shape, w_shape, *extra)
            ragged = i_f % 8 or o % 8
        assert plan.smem_bytes <= SMEM_LIMIT
        assert plan.vec == (not ragged), (kind, t_in, c_in, w_shape)
        bm, bn = plan.block
        assert plan.block == conv_stack.GEMM_TILES[plan.tile]
        assert plan.grid[0] * bm >= plan.dims[0] > (plan.grid[0] - 1) * bm
        assert plan.grid[1] * bn >= plan.dims[1] > (plan.grid[1] - 1) * bn
        hits = _coverage(kind, batch, t_in, c_in, w_shape, extra, plan)
        assert (hits == 1).all(), (kind, t_in, c_in, w_shape, extra, plan)


def test_gemm_tile_rule():
    # The widest candidate that reaches the block target, else the last.
    assert conv_stack.gemm_tile(81920, 64, 1) == 0  # 640 blocks of 128×64
    assert conv_stack.gemm_tile(8192, 128, 1) == 1  # 128×64: only 128
    assert conv_stack.gemm_tile(1024, 256, 1) == 3  # 32×32 is the last
    assert conv_stack.gemm_tile(8192, 32, 4) == 2
    assert conv_stack.gemm_tile(2048, 32, 4) == 3  # 64×32: only 128
    assert conv_stack.gemm_tile(64, 2, 4) == 4
    small = conv_stack.conv1d_plan((1, 40, 8), (1, 2, 8), 1)  # I_f = 2
    assert not small.vec and small.block == (64, 16)
