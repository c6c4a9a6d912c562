"""The index maps of the conv-stack kernels, on the CPU.

conv1d_fwd / transpose_conv1d_fwd (f32, FFMA micro-tiles), their _bf16
versions (tensor cores) and depthwise_conv1d_fwd(_bf16) in
ops/csrc/conv_stack.cu run only on the card; what they compute rests on
maps that numpy can check here:

  (a) the transpose conv as `stride` per-phase GEMMs: output phase p owns
      the rows t = j·s + p < t_out, its q_p = ceil((K − p)/s) taps are
      weight rows p + a·s and read input row j − a (zero outside
      [0, T_in)).  Written out below, it equals the port's plain version
      and the JAX package's TRANSPOSE_CONV lowering
      (lyra_tpu/tflite/executor.py `_transpose_conv`) on the same inputs;
  (a') the fused launches' maps (ops/fused_stack.py plans them): A's row u
      is state row u (u < T_s) or x row u − T_s, read from channel c_off
      (a SPLIT), and a cropped transpose conv's phase z owns the kept rows
      u = j·s + z, i.e. the result's rows crop0 + u, of tap phase
      (crop0 + z) mod s.  Written out for every GEMM launch of both
      fixtures, they equal the plain composition (torch.cat, the plain
      conv, the slice);
  (b) the launchers' tile plan (conv_stack.conv1d_plan /
      transpose_conv1d_plan; tests/test_torch_cuda.py holds the launchers
      to it on the card), in both element types: its blocks cover every
      output element of every conv call of both fixtures exactly once, at
      B ∈ {1, 64, 1024}, within 48 KB of static shared memory, and the
      scalar-load path is taken exactly for the shapes the 16-byte path
      (8 bf16 or 4 floats) cannot take;
  (c) the depthwise launchers' thread map (conv_stack.depthwise_plan; held
      to the launchers on the card the same way): a thread owns one phase
      p < min(d, T_out) and one vector of V channels (16 bytes, or 1
      channel) and computes the run of outputs t = p + (r·J + j)·d < T_out,
      j < J, of its grid layer r, sliding a window of K rows by one row per
      output.  Walking its threads as the kernel does, for every depthwise
      call of both fixtures at B ∈ {1, 3, 64} in both element types' plans
      and for ragged shapes, checks that every output is written exactly
      once, that a run loads each of its rows once, all inside [0, T_in),
      and that the result equals the port's plain version and the JAX
      package's DEPTHWISE_CONV_2D lowering (lyra_tpu/tflite/executor.py
      `_depthwise_conv2d`) on the same inputs.
These walks check numpy copies of the kernels' index maps; the kernels
themselves are held to the plain versions, and through them to JAX, only
on the card (tests/test_torch_cuda.py).
"""

import functools
import os

import numpy as np
import pytest
import torch

from lyra_tpu.tflite.executor import _depthwise_conv2d as jax_depthwise
from lyra_tpu.tflite.executor import _transpose_conv as jax_transpose_conv
from lyra_tpu_torch.ops import conv_stack
from lyra_tpu_torch.ops.fused_stack import FusedStack
from test_torch_cuda import (FULL_CONV1D, FULL_DEPTHWISE, FULL_TCONV,
                             RAGGED_DEPTHWISE)

FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra")
MODELS = ("soundstream_encoder", "lyragan")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
REL_TOL = 1e-5


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
def _launches(fixture):
    return [launch for model in MODELS for launch in FusedStack(
        os.path.join(FIXTURES, fixture, f"{model}.tflite"),
        device="cpu").plan]


@functools.lru_cache(maxsize=None)
def _gemm_calls(fixture):
    """(kind, x [T_in, C_in], w shape, extra, crop) of every conv1d and
    transpose conv launch of one hop of both graphs of `fixture` (T_in with
    the state rows, C_in the conv's channels)."""
    return [(launch.kind, launch.in_shape, tuple(launch.w.shape),
             launch.extra, launch.crop)
            for launch in _launches(fixture)
            if launch.kind in ("conv1d", "tconv")]


def fused_gemm(launch, x, state):
    """The launch's conv (bias, no output ops) as its kernel maps it, in
    float64: A's row u from state (u < T_s) or x, from channel c_off; a
    transpose conv per phase z of the kept rows u = j·s + z, the result's
    row crop0 + u = (j0 + j)·s + p with p = (crop0 + z) mod s."""
    b = x.shape[0]
    t_s = 0 if state is None else state.shape[1]
    c_off = launch.split[0] if launch.split else 0
    w = launch.w.double().numpy()
    bias = launch.bias.double().numpy()
    k, i_f, o = w.shape
    t_in = launch.in_shape[0]

    def rows(u):  # [B, I] of input row u (zeros outside), from c_off
        if not 0 <= u < t_in:
            return np.zeros((b, x.shape[2]))
        return state[:, u] if u < t_s else x[:, u - t_s]

    if launch.kind == "conv1d":
        (stride,) = launch.extra
        groups = launch.in_shape[1] // i_f
        n = o // groups
        t_out = (t_in - k) // stride + 1
        out = np.zeros((b, t_out, o))
        for t in range(t_out):
            for g in range(groups):
                a_row = np.concatenate(
                    [rows(t * stride + kk)[:, c_off + g * i_f:
                                           c_off + (g + 1) * i_f]
                     for kk in range(k)], axis=1)
                out[:, t, g * n:(g + 1) * n] = (
                    a_row @ w[:, :, g * n:(g + 1) * n].reshape(k * i_f, n)
                    + bias[g * n:(g + 1) * n])
        return out
    stride, t_out = launch.extra
    crop0, end = launch.crop or (0, t_out)
    kept = end - crop0
    out = np.full((b, kept, o), np.nan)
    for z in range(stride):
        p, j0 = (crop0 + z) % stride, (crop0 + z) // stride
        taps = -(-(k - p) // stride) if k > p else 0
        for j in range(-(-(kept - z) // stride) if kept > z else 0):
            a_row = [rows(j0 + j - a)[:, c_off:c_off + i_f]
                     for a in range(taps)]
            acc = np.zeros((b, o)) + bias
            for a in range(taps):
                acc += a_row[a] @ w[p + a * stride]
            out[:, j * stride + z] = acc
    return out


@pytest.mark.parametrize("fixture", ["small", "full"])
def test_fused_gemm_maps_match_plain(fixture):
    """(a'): every GEMM launch's two-pointer rows, channel offset and
    cropped phases, walked in numpy, equal the plain composition of its
    CONCATENATION, SPLIT, conv and STRIDED_SLICE on the same inputs."""
    rng = np.random.default_rng(5)
    for launch in _launches(fixture):
        if launch.kind == "depthwise":
            continue
        t_x, c_x = launch.x_shape
        x = rng.normal(size=(2, t_x, c_x))
        state = None
        if launch.state is not None:
            t_s = launch.in_shape[0] - t_x
            state = rng.normal(size=(2, t_s, c_x))
        got = fused_gemm(launch, x, state)
        ref = conv_stack.fused_plain(
            conv_stack.PLAIN[launch.kind], torch.from_numpy(x).float(),
            launch.w, launch.bias, launch.extra, conv_stack.Fusion(
                state=None if state is None else torch.from_numpy(
                    state).float(), split=launch.split, crop=launch.crop))
        assert got.shape == ref.shape, launch.op
        np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=REL_TOL *
                                   np.abs(got).max(), err_msg=str(launch.op))


def test_full_fixture_shape_lists_match_the_fixture():
    conv1d, tconv = [], []
    for kind, (t_in, c_in), (k, i, o), extra, _ in _gemm_calls("full"):
        if kind == "conv1d":
            conv1d.append((t_in, c_in, k, i, o, *extra))
        else:
            tconv.append((t_in, i, k, o, *extra))
    assert list(dict.fromkeys(conv1d)) == FULL_CONV1D
    assert list(dict.fromkeys(tconv)) == FULL_TCONV


@functools.lru_cache(maxsize=None)
def _covered_once(kind, batch, t_in, w_shape, extra, crop, dims, block, grid):
    """Whether a plan's blocks write each output element exactly once,
    walking the grid as the kernel's epilogue does (cached: both element
    types share the tile rule); a cropped transpose conv writes its kept
    rows u = j·stride + z."""
    k, i_f, o = w_shape
    bm, bn = block
    _, n_cols, layers = dims
    if kind == "conv1d":
        t_out = (t_in - k) // extra[0] + 1
    else:
        stride, t_out = extra
        if crop is not None:
            t_out = crop[1] - crop[0]
    hits = np.zeros((batch, t_out, o), np.int32)
    for z in range(layers):
        if kind == "conv1d":  # z = group; rows (b, t); columns z·N + n
            rows, cols0 = batch * t_out, z * n_cols
        else:  # z = output phase; rows (b, j) for t = j·stride + z
            n_j = -(-(t_out - z) // stride) if t_out > z else 0
            rows, cols0 = batch * n_j, 0
        for bx in range(grid[0]):
            m = np.arange(bx * bm, (bx + 1) * bm)
            m = m[m < rows]
            if kind == "conv1d":
                b_idx, t_idx = np.divmod(m, t_out)
            else:
                b_idx, j_idx = np.divmod(m, n_j)
                t_idx = j_idx * stride + z
            for by in range(grid[1]):
                n = np.arange(by * bn, (by + 1) * bn)
                n = cols0 + n[n < n_cols]
                np.add.at(hits, (b_idx[:, None], t_idx[:, None], n[None, :]),
                          1)
    return bool((hits == 1).all())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [1, 64, 1024])
@pytest.mark.parametrize("fixture", ["small", "full"])
def test_gemm_plan_covers_every_output_once(fixture, batch, dtype):
    chunk = 16 // DTYPES[dtype].itemsize  # 8 bf16 or 4 floats
    for kind, (t_in, c_in), w_shape, extra, crop in _gemm_calls(fixture):
        k, i_f, o = w_shape
        x_shape = (batch, t_in, c_in)
        if kind == "conv1d":
            plan = conv_stack.conv1d_plan(x_shape, w_shape, *extra,
                                          dtype=DTYPES[dtype])
            ragged = i_f % chunk or (o // (c_in // i_f)) % chunk
        else:
            plan = conv_stack.transpose_conv1d_plan(x_shape, w_shape, *extra,
                                                    dtype=DTYPES[dtype],
                                                    crop=crop)
            ragged = i_f % chunk or o % chunk
        assert plan.vec == (not ragged), (kind, t_in, c_in, w_shape)
        bm, bn = plan.block
        assert plan.block == conv_stack.GEMM_TILES[plan.tile]
        assert plan.grid[0] * bm >= plan.dims[0] > (plan.grid[0] - 1) * bm
        assert plan.grid[1] * bn >= plan.dims[1] > (plan.grid[1] - 1) * bn
        assert _covered_once(kind, batch, t_in, w_shape, extra, crop,
                             plan.dims, plan.block, plan.grid), (
            kind, t_in, c_in, w_shape, extra, crop, plan)


def test_gemm_tile_rule():
    # The widest candidate that reaches the block target, else the last.
    assert conv_stack.gemm_tile(81920, 64, 1) == 0  # 640 blocks of 128×64
    assert conv_stack.gemm_tile(8192, 128, 1) == 1  # 128×64: only 128
    assert conv_stack.gemm_tile(1024, 256, 1) == 3  # 32×32 is the last
    assert conv_stack.gemm_tile(8192, 32, 4) == 2
    assert conv_stack.gemm_tile(2048, 32, 4) == 3  # 64×32: only 128
    assert conv_stack.gemm_tile(64, 2, 4) == 4
    for dtype in DTYPES.values():
        small = conv_stack.conv1d_plan((1, 40, 8), (1, 2, 8), 1,  # I_f = 2
                                       dtype=dtype)
        assert not small.vec and small.block == (64, 16)


def test_f32_vector_path_shapes():
    """f32 moves 4 floats per 16-byte chunk, so shapes with I_f or
    O/groups a multiple of 4 but not of 8 take the vector path in f32 and
    the scalar fill in bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    x, w = (64, 23, 64), (4, 16, 48)  # groups 4, O/groups = 12, I_f = 16
    assert conv_stack.conv1d_plan(x, w, 1, dtype=f32).vec
    assert not conv_stack.conv1d_plan(x, w, 1, dtype=bf16).vec
    x, w = (64, 9, 12), (4, 12, 20)  # I = 12, O = 20
    assert conv_stack.transpose_conv1d_plan(x, w, 2, 19, dtype=f32).vec
    assert not conv_stack.transpose_conv1d_plan(x, w, 2, 19, dtype=bf16).vec
    for x, w in (((64, 9, 6), (4, 6, 8)), ((64, 9, 8), (4, 8, 6))):
        assert not conv_stack.transpose_conv1d_plan(x, w, 2, 19,
                                                    dtype=f32).vec
    plan = conv_stack.conv1d_plan((1024, 84, 64), (5, 64, 64), 1, dtype=f32)
    assert plan.block == (128, 64)
    # LyraGAN's T_out = 1 convs at B=1024: 32×32 tiles fill the card.
    plan = conv_stack.conv1d_plan((1024, 1, 256), (1, 256, 256), 1, dtype=f32)
    assert plan.block == (32, 32) and plan.grid == (32, 8, 1)


# -- (c) the depthwise kernels' thread map ----------------------------------

@functools.lru_cache(maxsize=None)
def _depthwise_calls(fixture):
    """(T_in, C, dilation, K) of every depthwise call of one hop of both
    graphs of `fixture`, in graph order."""
    return [(*launch.in_shape, *launch.extra, launch.w.shape[0])
            for launch in _launches(fixture) if launch.kind == "depthwise"]


def test_full_fixture_depthwise_list_matches_the_fixture():
    calls = _depthwise_calls("full")
    assert all(k == 3 for *_, k in calls)
    assert [c[:3] for c in calls] == FULL_DEPTHWISE


def walk_plan(x, w, bias, dilation, plan):
    """out [B, T_out, C] as the kernel's threads compute it under `plan`:
    a thread loads the first K − 1 rows of its run into a window, then one
    row more per output, and takes the output's K taps from the window.
    Checks that every output is written exactly once and that a run of n
    outputs loads n + K − 1 distinct rows, all inside [0, T_in).  All
    streams share one thread layout (grid z = stream)."""
    b, t_in, c = x.shape
    k = w.shape[0]
    t_out = t_in - (k - 1) * dilation
    v, j_run = plan.elems, plan.runs
    nv = c // v
    bx, by = plan.block
    assert bx * by <= conv_stack.DW_THREADS and plan.grid[2] == b
    f = np.arange(plan.grid[0] * bx)  # threads along x: lanes
    f = f[f < plan.phases * nv]
    assert len(f) == plan.phases * nv  # every (phase, vector) has a thread
    p, cv = np.divmod(f, nv)
    ch = cv[:, None] * v + np.arange(v)  # [threads, V]
    out = np.zeros((b, t_out, c), np.float32)
    hits = np.zeros((t_out, c), np.int32)
    for r in range(plan.grid[1] * by):  # threads along y: runs
        t0 = p + r * j_run * dilation
        n = sum((t0 + j * dilation < t_out).astype(int) for j in range(j_run))
        live = n > 0  # t0 < T_out
        tl, nl, chl = t0[live], n[live], ch[live]
        rows = []  # per load: the row each thread loaded, −1 where none

        def load(m, mask):
            row = np.where(mask, tl + m * dilation, -1)
            rows.append(row)
            return x[:, np.maximum(row, 0)[:, None], chl]  # [B, threads, V]

        win = [load(m, nl > 0) for m in range(k - 1)]
        for j in range(j_run):
            ok = j < nl
            win.append(load(j + k - 1, ok))
            acc = np.broadcast_to(bias[chl], win[0].shape).copy()
            for kk in range(k):  # ascending taps, as the kernel's fmaf chain
                acc += win[j + kk] * w[kk, chl]
            t = tl[ok] + j * dilation
            out[:, t[:, None], chl[ok]] = acc[:, ok]
            np.add.at(hits, (t[:, None], chl[ok]), 1)
        rows = np.sort(np.stack(rows, 1), 1)  # [threads, J + K − 1]
        assert ((rows >= 0).sum(1) == nl + k - 1).all()
        assert (rows < t_in).all()
        assert not ((rows[:, 1:] == rows[:, :-1]) & (rows[:, 1:] >= 0)).any()
    assert (hits == 1).all(), "an output written other than once"
    return out


@functools.lru_cache(maxsize=None)
def _operands(b, t_in, c, dilation, k):
    rng = np.random.default_rng(t_in * 1000 + c * 10 + dilation + 7 * k + b)
    x = rng.normal(size=(b, t_in, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    return x, w, bias


@functools.lru_cache(maxsize=None)
def _references(b, t_in, c, dilation, k):
    """(plain, JAX) outputs on the seeded operands of one call."""
    x, w, bias = _operands(b, t_in, c, dilation, k)
    plain = conv_stack.depthwise_conv1d_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        dilation).numpy()
    # The JAX lowering: NHWC input, TFLite weight [1, K, 1, C].
    jx = np.asarray(jax_depthwise(
        x[:, :, None, :], w[None, :, None, :], bias,
        {"padding": "VALID", "stride_h": 1, "stride_w": 1,
         "dilation_h": dilation, "dilation_w": 1}))[:, :, 0, :]
    return plain, jx


def _check_call(b, t_in, c, dilation, k, dtype, aligned=True):
    x, w, bias = _operands(b, t_in, c, dilation, k)
    plan = conv_stack.depthwise_plan(x.shape, k, dilation, dtype=dtype,
                                     aligned=aligned)
    chunk = 16 // dtype.itemsize  # 8 bf16 or 4 floats
    assert plan.vec == (aligned and c % chunk == 0)
    assert plan.elems == (chunk if plan.vec else 1)
    assert plan.runs == (conv_stack.DW_RUN if k == conv_stack.DW_TAPS else 1)
    got = walk_plan(x, w, bias, dilation, plan)
    plain, jx = _references(b, t_in, c, dilation, k)
    assert got.shape == plain.shape == jx.shape
    tol = REL_TOL * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
    np.testing.assert_allclose(got, jx, rtol=0, atol=tol)
    return plan


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("fixture", ["small", "full"])
def test_depthwise_plan_walk_matches_plain_and_jax(fixture, batch, dtype):
    for t_in, c, dilation, k in _depthwise_calls(fixture):
        _check_call(batch, t_in, c, dilation, k, DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", RAGGED_DEPTHWISE)
def test_depthwise_plan_walk_ragged(shape, dtype):
    t_in, c, dilation, k = shape
    for batch in (1, 3):
        _check_call(batch, t_in, c, dilation, k, DTYPES[dtype])
    # A misaligned operand: the same shape, one channel per thread.
    _check_call(3, t_in, c, dilation, k, DTYPES[dtype], aligned=False)


def test_depthwise_plan_rule():
    f32, bf16 = torch.float32, torch.bfloat16
    # SoundStream stage 0 at d = 1 at B=1024: 16 float4 or 8 bf16 vectors
    # per row, 40 outputs in 20 runs of 2; a block holds 256 threads or all
    # of a stream's runs.
    plan = conv_stack.depthwise_plan((1024, 42, 64), 3, 1, dtype=f32)
    assert (plan.elems, plan.phases, plan.runs) == (4, 1, 2)
    assert plan.block == (16, 16) and plan.grid == (1, 2, 1024)
    plan = conv_stack.depthwise_plan((1024, 42, 64), 3, 1, dtype=bf16)
    assert (plan.elems, plan.block, plan.grid) == (8, (8, 20), (1, 1, 1024))
    # A pointer off 16 bytes: one channel per thread, the same runs.
    plan = conv_stack.depthwise_plan((1024, 42, 64), 3, 1, dtype=f32,
                                     aligned=False)
    assert (plan.vec, plan.elems, plan.runs) == (False, 1, 2)
    assert plan.block == (64, 4) and plan.grid == (1, 5, 1024)
    # d = 9, T_out = 40: 9 phases of 5 or 4 outputs, so 3 runs of 2.
    plan = conv_stack.depthwise_plan((1024, 58, 64), 3, 9, dtype=f32)
    assert (plan.phases, plan.runs) == (9, 2)
    assert plan.block == (144, 1) and plan.grid == (1, 3, 1024)
    # LyraGAN's T_out = 1 at d = 9: one phase, a run of one output.
    plan = conv_stack.depthwise_plan((1024, 19, 256), 3, 9, dtype=f32)
    assert (plan.phases, plan.block, plan.grid) == (1, (64, 1), (1, 1, 1024))
    # J does not depend on the batch.
    for shape, d in (((3, 58, 64), 9), ((64, 42, 64), 1), ((1, 22, 256), 9)):
        assert conv_stack.depthwise_plan(shape, 3, d, dtype=f32).runs == 2
    # More than 256 lanes split along x: T_out = 8 < d, 8 phases of 64.
    plan = conv_stack.depthwise_plan((8, 26, 256), 3, 9, dtype=f32)
    assert (plan.phases, plan.block, plan.grid) == (8, (256, 1), (2, 1, 8))
    # K ≠ 3 takes its taps at run time, one output per thread.
    plan = conv_stack.depthwise_plan((1024, 50, 64), 5, 2, dtype=f32)
    assert plan.runs == 1 and plan.block == (32, 8)
    assert plan.grid == (1, 3, 1024)


def test_depthwise_vector_path_shapes():
    """f32 moves 4 floats per 16 bytes, so C a multiple of 4 but not of 8
    takes the vector path in f32 and one channel per thread in bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert conv_stack.depthwise_plan((4, 10, 12), 3, 1, dtype=f32).vec
    assert not conv_stack.depthwise_plan((4, 10, 12), 3, 1, dtype=bf16).vec
    for c in (6, 20, 36):
        assert not conv_stack.depthwise_plan((4, 10, c), 3, 1,
                                             dtype=bf16).vec
    for c in (8, 16, 32, 64, 128, 256):  # every width of both fixtures
        for dtype in (f32, bf16):
            assert conv_stack.depthwise_plan((4, 10, c), 3, 1,
                                             dtype=dtype).vec
