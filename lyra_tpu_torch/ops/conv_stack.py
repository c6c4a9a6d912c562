"""Conv-stack kernel K1: wrappers for the three conv kinds of the core.

Replaces the conv lowerings of the Pallas megakernel
`lyra_tpu/ops/fused_stack.py::FusedStackKernel` (`_conv`, `_depthwise`,
`_tconv`, launched by the `pl.pallas_call` at fused_stack.py:488).  The
CUDA sources are ops/csrc/conv_stack.cu; see there for what bounds them on
the card.

All three take channels-last activations `[B, T, C]` (the graph's
`[1, T, 1, C]` with the stream batch in place of 1 and W dropped) and
weights pre-laid out for the kernels:

    conv1d(x, w[K, I_f, O], bias[O], stride)        CONV_2D, grouped
    depthwise_conv1d(x, w[K, C], bias[C], dilation)  DEPTHWISE_CONV_2D
    transpose_conv1d(x, w[K, I, O], bias[O], stride, t_out)  TRANSPOSE_CONV

Each comes in float32 and bfloat16, chosen by the operands' dtype, which
must be one of the two and the same for all of them.  The bf16 kernels
accumulate in float32 and round once on store (the Pallas kernel's bf16
mode); the bf16 conv1d and transpose conv run as tensor-core implicit
GEMMs whose tile the launcher picks per call (`gemm_tile`, `conv1d_plan`,
`transpose_conv1d_plan` below describe that choice).  A CUDA tensor
launches the kernel of its dtype (and counts the launch); a CPU tensor runs
the plain version, which is the executor's torch lowering
(tflite/executor.py) in the input's dtype.  Anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from lyra_tpu_torch.ops import cuda_build
from lyra_tpu_torch.tflite import executor

_SOURCE = "lyra_tpu_torch/ops/csrc/conv_stack.cu"
_REPLACES = "lyra_tpu/ops/fused_stack.py:488"
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def _counters(suffix: str):
    return tuple(cuda_build.KernelCounter(f"{name}{suffix}", _SOURCE, _REPLACES)
                 for name in ("conv1d_fwd", "depthwise_conv1d_fwd",
                              "transpose_conv1d_fwd"))


CONV1D, DEPTHWISE, TCONV = _counters("")
CONV1D_BF16, DEPTHWISE_BF16, TCONV_BF16 = _counters("_bf16")
KERNELS_F32 = (CONV1D, DEPTHWISE, TCONV)
KERNELS_BF16 = (CONV1D_BF16, DEPTHWISE_BF16, TCONV_BF16)
KERNELS = KERNELS_F32 + KERNELS_BF16
# dtype → (conv1d, depthwise, transpose conv) counters
BY_DTYPE = {torch.float32: KERNELS_F32, torch.bfloat16: KERNELS_BF16}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("conv_stack.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in _SUFFIX.values():
        conv = getattr(lib, f"lyra_conv1d_fwd{suffix}")
        dw = getattr(lib, f"lyra_depthwise_conv1d_fwd{suffix}")
        tc = getattr(lib, f"lyra_transpose_conv1d_fwd{suffix}")
        conv.argtypes = [p, p, p, p] + [i] * 9 + [p]
        dw.argtypes = [p, p, p, p] + [i] * 6 + [p]
        tc.argtypes = [p, p, p, p] + [i] * 7 + [p]
        for fn in (conv, dw, tc):
            fn.restype = ctypes.c_int
    lib.lyra_conv_gemm_tile.argtypes = [i, i, i]
    lib.lyra_conv_gemm_tile.restype = ctypes.c_int
    return lib


def _on_cuda(x: torch.Tensor, *operands: Optional[torch.Tensor]) -> bool:
    """True → launch the kernel; False → plain version (CPU tensors)."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise NotImplementedError(f"no conv-stack kernel for {x.device}")
    if x.dtype not in BY_DTYPE:
        raise ValueError(f"conv-stack kernels take float32 or bfloat16, got "
                         f"{x.dtype}")
    for t in (x, *operands):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"conv-stack kernels take operands of one dtype on one "
                f"device: {x.dtype} on {x.device}, got {t.dtype} on "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("conv-stack kernels take contiguous tensors")
    return True


def _launch(which: int, x: torch.Tensor, *args) -> None:
    """Launch kernel `which` (0 conv1d, 1 depthwise, 2 transpose conv) of
    x's dtype with `args`, check the launch and count it."""
    counter = BY_DTYPE[x.dtype][which]
    err = getattr(_lib(), f"lyra_{counter.name}")(
        *args, cuda_build.stream_handle(x.device))
    cuda_build.check(err, counter.name)
    counter.launches += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# -- tile plan of the bf16 implicit GEMMs --------------------------------------
# The launchers in conv_stack.cu choose the tile themselves
# (lyra_conv_gemm_tile); this is the same rule in Python, for the tests
# (tests/test_torch_cuda.py holds the two equal on the card).

GEMM_TILES = ((128, 64), (64, 64), (64, 32), (32, 32), (64, 16))  # (BM, BN)
GEMM_BK, GEMM_STAGES, GEMM_PAD = 32, 3, 8
GEMM_TARGET_BLOCKS = 132  # one wave: a block per SM of an H100 SXM


class GemmPlan(NamedTuple):
    dims: Tuple[int, int, int]  # GEMM rows, columns, groups or phases
    tile: int  # index into GEMM_TILES
    block: Tuple[int, int]  # (BM, BN) outputs per block
    grid: Tuple[int, int, int]  # (row tiles, column tiles, groups or phases)
    smem_bytes: int
    # 16-byte cp.async loads and stores, else scalar fills of the same
    # tiles; the launcher also needs x, w and out 16-byte aligned for it.
    vec: bool


def gemm_tile(m: int, n: int, z: int) -> int:
    """Index into GEMM_TILES for a GEMM of m rows, n columns and z groups
    or phases: of the candidates for its width (n > 32, > 16, ≤ 16), the
    widest that still puts GEMM_TARGET_BLOCKS blocks on the card, else the
    narrowest."""
    cands = (0, 1, 3) if n > 32 else (2, 3) if n > 16 else (4,)
    for c in cands:
        bm, bn = GEMM_TILES[c]
        if -(-m // bm) * -(-n // bn) * z >= GEMM_TARGET_BLOCKS:
            return c
    return cands[-1]


def _plan(m: int, n: int, z: int, vec: bool) -> GemmPlan:
    tile = gemm_tile(m, n, z)
    bm, bn = GEMM_TILES[tile]
    smem = GEMM_STAGES * (bm * (GEMM_BK + GEMM_PAD)
                          + GEMM_BK * (bn + GEMM_PAD)) * 2
    return GemmPlan((m, n, z), tile, (bm, bn), (-(-m // bm), -(-n // bn), z),
                    smem, vec)


def conv1d_plan(x_shape, w_shape, stride: int) -> GemmPlan:
    """conv1d_fwd_bf16 on x [B, T_in, C_in], w [K, I_f, O]: rows (b, t),
    columns O / groups, one grid layer per group."""
    b, t_in, c_in = x_shape
    k, i_f, o = w_shape
    groups = c_in // i_f
    t_out = (t_in - k) // stride + 1
    n = o // groups
    return _plan(b * t_out, n, groups, i_f % 8 == 0 and n % 8 == 0)


def transpose_conv1d_plan(x_shape, w_shape, stride: int,
                          t_out: int) -> GemmPlan:
    """transpose_conv1d_fwd_bf16 on x [B, T_in, I], w [K, I, O]: one grid
    layer per output phase p < stride, rows (b, j) for t = j·stride + p
    (phase 0 has the most), columns O."""
    b, i, o = x_shape[0], x_shape[2], w_shape[2]
    return _plan(b * -(-t_out // stride), o, stride,
                 i % 8 == 0 and o % 8 == 0)


# -- plain versions (the executor's lowering on [B, T, 1, C], in x's dtype) --

def conv1d_plain(x, w, bias, stride: int) -> torch.Tensor:
    groups = x.shape[-1] // w.shape[1]
    w_t = w.permute(2, 1, 0).unsqueeze(-1)  # [O, I_f, K, 1]
    return executor.conv2d(x.unsqueeze(2), w_t, bias, (stride, 1), (1, 1),
                           groups).squeeze(2)


def depthwise_conv1d_plain(x, w, bias, dilation: int) -> torch.Tensor:
    w_t = w.t().unsqueeze(1).unsqueeze(-1)  # [C, 1, K, 1]
    return executor.depthwise_conv2d(x.unsqueeze(2), w_t, bias, (1, 1),
                                     (dilation, 1)).squeeze(2)


def transpose_conv1d_plain(x, w, bias, stride: int, t_out: int) -> torch.Tensor:
    w_t = w.permute(1, 2, 0).unsqueeze(-1)  # [I, O, K, 1]
    return executor.transpose_conv(x.unsqueeze(2), w_t, bias, (stride, 1),
                                   (t_out, 1)).squeeze(2)


# -- wrappers -------------------------------------------------------------------

def conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int) -> torch.Tensor:
    """CONV_2D over time: x [B, T_in, C_in], w [K, I_f, O] → [B, T_out, O]
    with groups = C_in / I_f and T_out = (T_in − K) // stride + 1."""
    if not _on_cuda(x, w, bias):
        return conv1d_plain(x, w, bias, stride)
    b, t_in, c_in = x.shape
    k, i_f, o = w.shape
    groups = c_in // i_f
    if c_in % i_f or o % groups or t_in < k:
        raise ValueError(f"conv1d shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    t_out = (t_in - k) // stride + 1
    out = torch.empty((b, t_out, o), device=x.device, dtype=x.dtype)
    _launch(0, x, _ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, t_in, c_in,
            t_out, o, k, i_f, stride, groups)
    return out


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], dilation: int) -> torch.Tensor:
    """DEPTHWISE_CONV_2D over time: x [B, T_in, C], w [K, C] →
    [B, T_in − (K − 1)·dilation, C]."""
    if not _on_cuda(x, w, bias):
        return depthwise_conv1d_plain(x, w, bias, dilation)
    b, t_in, c = x.shape
    k = w.shape[0]
    t_out = t_in - (k - 1) * dilation
    if w.shape[1] != c or t_out < 1:
        raise ValueError(
            f"depthwise shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    out = torch.empty((b, t_out, c), device=x.device, dtype=x.dtype)
    _launch(1, x, _ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, t_in, c, t_out,
            k, dilation)
    return out


def transpose_conv1d(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int,
                     t_out: int) -> torch.Tensor:
    """TRANSPOSE_CONV over time: x [B, T_in, I], w [K, I, O] → [B, t_out, O],
    t_out ≤ (T_in − 1)·stride + K."""
    if not _on_cuda(x, w, bias):
        return transpose_conv1d_plain(x, w, bias, stride, t_out)
    b, t_in, i = x.shape
    k, _, o = w.shape
    if w.shape[1] != i or t_out > (t_in - 1) * stride + k:
        raise ValueError(
            f"transpose conv shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"t_out {t_out}")
    out = torch.empty((b, t_out, o), device=x.device, dtype=x.dtype)
    _launch(2, x, _ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, t_in, i, t_out,
            o, k, stride)
    return out
