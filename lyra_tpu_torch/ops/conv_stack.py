"""Conv-stack kernel K1: wrappers for the three conv kinds of the core.

Replaces the Pallas megakernel `lyra_tpu/ops/fused_stack.py::
FusedStackKernel` (its conv lowerings `_conv`, `_depthwise`, `_tconv` and
the elementwise and data-movement ops between them, launched by the
`pl.pallas_call` at fused_stack.py:488).  The CUDA sources are
ops/csrc/conv_stack.cu; see there for what bounds them on the card.

All three take channels-last activations `[B, T, C]` (the graph's
`[1, T, 1, C]` with the stream batch in place of 1 and W dropped) and
weights pre-laid out for the kernels:

    conv1d(x, w[K, I_f, O], bias[O], stride)        CONV_2D, grouped
    depthwise_conv1d(x, w[K, C], bias[C], dilation)  DEPTHWISE_CONV_2D
    transpose_conv1d(x, w[K, I, O], bias[O], stride, t_out)  TRANSPOSE_CONV

and, as keyword arguments (`Fusion`), the graph ops a launch absorbs: the
state rows its input follows (CONCATENATION of a READ_VARIABLE), the
channels it reads (SPLIT, or a STRIDED_SLICE of a channel range), a
LEAKY_RELU on x's rows as they are loaded, a residual ADD/SUB, a MUL or DIV
by a per-channel constant and a LEAKY_RELU on its output, the rows a
transpose conv keeps (STRIDED_SLICE), and the new state it writes beside
its output (STRIDED_SLICE → ASSIGN_VARIABLE of the concatenation).  A call
given `side` returns `(out, new_state)`; without any of them the kernels
are the plain convs.  ops/fused_stack.py plans which ops each launch
absorbs.

The core's ops that no conv launch absorbs run as two kernels of their own
(ops/csrc/core_ops.cu): `eltwise` (ADD/SUB/MUL/DIV of two tensors, or of a
tensor and a constant per channel or one constant) and `gather` (a
CONCATENATION along time or channels of strided windows of tensors or
constants: a concatenation, a STRIDED_SLICE, or both in one launch).

Each comes in float32 and bfloat16, chosen by the operands' dtype, which
must be one of the two and the same for all of them.  The bf16 kernels
accumulate in float32 and round once on store, after the fused ops (the
Pallas kernel's bf16 mode).  In float32 a fused launch gives the bits of
its plain composition: each fused op applies to the finished sum in the
graph's order.  conv1d and the transpose conv run as implicit GEMMs in
both dtypes — on the tensor cores in bf16, as register-tiled FFMA in f32 —
whose tile the launcher picks per call (`gemm_tile`, `conv1d_plan`,
`transpose_conv1d_plan` below describe that choice); the depthwise conv
gives each thread 16 bytes of channels and a run of outputs, also chosen
per call (`depthwise_plan`).  A CUDA tensor launches the kernel of its
dtype (and counts the launch); a CPU tensor runs the plain version, the
graph's torch ops in the graph's order (`fused_plain` over the executor's
conv lowering, tflite/executor.py) in the input's dtype.  Anything else
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from lyra_tpu_torch.ops import cuda_build
from lyra_tpu_torch.tflite import executor

_SOURCE = "lyra_tpu_torch/ops/csrc/conv_stack.cu"
_CORE_SOURCE = "lyra_tpu_torch/ops/csrc/core_ops.cu"
_REPLACES = "lyra_tpu/ops/fused_stack.py:488"
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def _counters(suffix: str):
    return tuple(cuda_build.KernelCounter(f"{name}{suffix}", _SOURCE, _REPLACES)
                 for name in ("conv1d_fwd", "depthwise_conv1d_fwd",
                              "transpose_conv1d_fwd"))


def _core_counters(suffix: str):
    return tuple(cuda_build.KernelCounter(f"{name}{suffix}", _CORE_SOURCE,
                                          _REPLACES)
                 for name in ("core_eltwise", "core_gather"))


CONV1D, DEPTHWISE, TCONV = _counters("")
CONV1D_BF16, DEPTHWISE_BF16, TCONV_BF16 = _counters("_bf16")
ELTWISE, GATHER = _core_counters("")
ELTWISE_BF16, GATHER_BF16 = _core_counters("_bf16")
CORE_F32 = (ELTWISE, GATHER)
CORE_BF16 = (ELTWISE_BF16, GATHER_BF16)
KERNELS_F32 = (CONV1D, DEPTHWISE, TCONV)
KERNELS_BF16 = (CONV1D_BF16, DEPTHWISE_BF16, TCONV_BF16)
KERNELS = KERNELS_F32 + KERNELS_BF16 + CORE_F32 + CORE_BF16
# dtype → (conv1d, depthwise, transpose conv) counters
BY_DTYPE = {torch.float32: KERNELS_F32, torch.bfloat16: KERNELS_BF16}
# dtype → (eltwise, gather) counters
CORE_BY_DTYPE = {torch.float32: CORE_F32, torch.bfloat16: CORE_BF16}


class _FusedOps(ctypes.Structure):
    """conv_stack.cu's `struct FusedOps`, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("state", "res", "side")]
                + [(n, ctypes.c_int) for n in (
                    "T_s", "ld", "c_off", "res_mode", "crop0", "side_begin",
                    "side_rows", "leaky_in", "leaky_res", "leaky_out")]
                + [(n, ctypes.c_float)
                   for n in ("alpha_in", "alpha_res", "alpha_out")]
                + [("chan", ctypes.c_void_p)]
                + [(n, ctypes.c_int)
                   for n in ("chan_mode", "chan_pos", "chan_stride")])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("conv_stack.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.POINTER(_FusedOps)
    for suffix in _SUFFIX.values():
        conv = getattr(lib, f"lyra_conv1d_fwd{suffix}")
        dw = getattr(lib, f"lyra_depthwise_conv1d_fwd{suffix}")
        tc = getattr(lib, f"lyra_transpose_conv1d_fwd{suffix}")
        conv.argtypes = [p, p, p, p] + [i] * 9 + [f, p]
        dw.argtypes = [p, p, p, p] + [i] * 6 + [f, p]
        tc.argtypes = [p, p, p, p] + [i] * 7 + [f, p]
        for fn in (conv, dw, tc):
            fn.restype = ctypes.c_int
    lib.lyra_conv_gemm_tile.argtypes = [i, i, i]
    lib.lyra_conv_gemm_tile.restype = ctypes.c_int
    lib.lyra_depthwise_plan.argtypes = [i] * 6 + [p] * 4 + [ctypes.POINTER(i)]
    lib.lyra_depthwise_plan.restype = None
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
    x's dtype with `args`, check the launch and count it: one count per
    call, also where the depthwise launcher splits more than 65535 streams
    over several grids."""
    counter = BY_DTYPE[x.dtype][which]
    err = getattr(_lib(), f"lyra_{counter.name}")(
        *args, cuda_build.stream_handle(x.device))
    cuda_build.check(err, counter.name)
    counter.launches += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# -- fused operands ---------------------------------------------------------------

RES_OPS = {"add": 1, "sub": 2, "rsub": 3}  # out + res, out − res, res − out
CHAN_OPS = {"mul": 1, "div": 2}  # out · chan, out / chan


class Fusion(NamedTuple):
    """The graph ops one conv launch absorbs, around its input x [B, T_x,
    C_x] and its output.  The conv reads cat(state, leaky_in(x)) along time,
    channels split[0] .. split[0] + split[1] of it; its finished output
    passes the residual op, then leaky_out, with `chan_op` by `chan` (one
    value per output channel, or one value) before them (chan_pos 0),
    between them (1) or after them (2); a transpose conv keeps rows
    crop[0] .. crop[1] of its result (then `res` has the kept rows); `side`
    = (begin, rows) also returns rows begin .. begin + rows of the
    concatenation, all C_x channels (the new state)."""
    state: Optional[torch.Tensor] = None  # [B, T_s, C_x]
    split: Optional[Tuple[int, int]] = None  # (first channel, channels)
    leaky_in: Optional[float] = None  # alpha
    res: Optional[torch.Tensor] = None  # in the output's layout
    res_op: str = "add"  # a key of RES_OPS
    res_leaky: Optional[float] = None  # alpha, on res as it is loaded
    leaky_out: Optional[float] = None  # alpha
    crop: Optional[Tuple[int, int]] = None  # transpose conv only
    side: Optional[Tuple[int, int]] = None  # (begin, rows)
    chan: Optional[torch.Tensor] = None  # [O] or [1]
    chan_op: str = "mul"  # a key of CHAN_OPS
    chan_pos: int = 0

    def any(self) -> bool:
        return any(v is not None for k, v in self._asdict().items()
                   if k not in ("res_op", "chan_op", "chan_pos"))


def fused_plain(conv_plain: Callable, x, w, bias, extra, f: Fusion):
    """The plain version of a fused launch: the graph's torch ops in the
    graph's order (LEAKY_RELU, CONCATENATION, SPLIT, the conv, ADD/SUB,
    STRIDED_SLICE, LEAKY_RELU, and MUL/DIV where chan_pos puts it; the crop
    commutes with the elementwise ops) in x's dtype.  → out, or (out, new
    state) with `side`."""
    if f.leaky_in is not None:
        x = executor.leaky_relu(x, f.leaky_in)
    cat = x if f.state is None else torch.cat([f.state, x], dim=1)
    conv_in = cat
    if f.split is not None:
        conv_in = cat[..., f.split[0]:f.split[0] + f.split[1]]
    y = conv_plain(conv_in, w, bias, *extra)
    if f.crop is not None:
        y = y[:, f.crop[0]:f.crop[1]]

    def chan(y, pos):
        if f.chan is None or f.chan_pos != pos:
            return y
        return y * f.chan if f.chan_op == "mul" else y / f.chan

    y = chan(y, 0)
    if f.res is not None:
        r = f.res
        if f.res_leaky is not None:
            r = executor.leaky_relu(r, f.res_leaky)
        y = (y + r if f.res_op == "add" else y - r if f.res_op == "sub"
             else r - y)
    y = chan(y, 1)
    if f.leaky_out is not None:
        y = executor.leaky_relu(y, f.leaky_out)
    y = chan(y, 2)
    if f.side is None:
        return y
    begin, rows = f.side
    return y, cat[:, begin:begin + rows].contiguous()


def _fused_ops(x: torch.Tensor, f: Fusion, t_in: int, out: torch.Tensor):
    """→ (the launcher's FusedOps or None, the new-state tensor or None),
    after checking f's shapes against x [B, T_x, C_x], the conv's input
    rows t_in (state rows included) and its output."""
    if not f.any():
        return None, None
    b, t_x, c_x = x.shape
    ops = _FusedOps(ld=c_x)
    if f.state is not None:
        if f.state.shape[0] != b or f.state.shape[2] != c_x:
            raise ValueError(f"state {tuple(f.state.shape)} for x "
                             f"{tuple(x.shape)}")
        ops.state, ops.T_s = f.state.data_ptr(), f.state.shape[1]
    if f.split is not None:
        ops.c_off = f.split[0]
    if f.res is not None:
        if f.res.shape != out.shape:
            raise ValueError(f"residual {tuple(f.res.shape)} for output "
                             f"{tuple(out.shape)}")
        ops.res, ops.res_mode = f.res.data_ptr(), RES_OPS[f.res_op]
    if f.crop is not None:
        ops.crop0 = f.crop[0]
    if f.chan is not None:
        if f.chan.numel() not in (1, out.shape[2]) or f.chan_pos not in (0, 1, 2):
            raise ValueError(f"chan {tuple(f.chan.shape)} at {f.chan_pos} for "
                             f"output {tuple(out.shape)}")
        ops.chan, ops.chan_mode = f.chan.data_ptr(), CHAN_OPS[f.chan_op]
        ops.chan_pos = f.chan_pos
        ops.chan_stride = int(f.chan.numel() > 1)
    side = None
    if f.side is not None:
        begin, rows = f.side
        if begin < 0 or rows < 1 or begin + rows > t_in:
            raise ValueError(f"side rows {f.side} of {t_in}")
        side = torch.empty((b, rows, c_x), device=x.device, dtype=x.dtype)
        ops.side, ops.side_begin, ops.side_rows = side.data_ptr(), begin, rows
    for name in ("in", "res", "out"):
        alpha = getattr(f, "res_leaky" if name == "res" else f"leaky_{name}")
        if alpha is not None:
            setattr(ops, f"leaky_{name}", 1)
            setattr(ops, f"alpha_{name}", alpha)
    return ops, side


def _conv_input(x: torch.Tensor, f: Fusion) -> Tuple[int, int]:
    """(rows, channels) of the conv's input: state rows + x's, and the
    split's channels or all of x's."""
    t_s = 0 if f.state is None else f.state.shape[1]
    c = x.shape[2] if f.split is None else f.split[1]
    if f.split is not None and (f.split[0] < 0 or sum(f.split) > x.shape[2]):
        raise ValueError(f"split {f.split} of {x.shape[2]} channels")
    return t_s + x.shape[1], c


def _result(out, side):
    return out if side is None else (out, side)


# -- tile plan of the implicit GEMMs -------------------------------------------
# The launchers in conv_stack.cu choose the tile themselves
# (lyra_conv_gemm_tile, one rule for both element types); this is the same
# rule in Python, for the tests (tests/test_torch_cuda.py holds the two
# equal on the card).

GEMM_TILES = ((128, 64), (64, 64), (64, 32), (32, 32), (64, 16))  # (BM, BN)
GEMM_TARGET_BLOCKS = 132  # one wave: a block per SM of an H100 SXM


class GemmPlan(NamedTuple):
    dims: Tuple[int, int, int]  # GEMM rows, columns, groups or phases
    tile: int  # index into GEMM_TILES
    block: Tuple[int, int]  # (BM, BN) outputs per block
    grid: Tuple[int, int, int]  # (row tiles, column tiles, groups or phases)
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


def _chunk(dtype: torch.dtype) -> int:
    """Elements of `dtype` in one 16-byte chunk (8 bf16 or 4 floats)."""
    return 16 // dtype.itemsize


def _plan(m: int, n: int, z: int, vec: bool) -> GemmPlan:
    tile = gemm_tile(m, n, z)
    bm, bn = GEMM_TILES[tile]
    return GemmPlan((m, n, z), tile, (bm, bn), (-(-m // bm), -(-n // bn), z),
                    vec)


def conv1d_plan(x_shape, w_shape, stride: int, *,
                dtype: torch.dtype) -> GemmPlan:
    """conv1d_fwd (f32) or conv1d_fwd_bf16 on x [B, T_in, C_in],
    w [K, I_f, O]: rows (b, t), columns O / groups, one grid layer per
    group."""
    b, t_in, c_in = x_shape
    k, i_f, o = w_shape
    groups = c_in // i_f
    t_out = (t_in - k) // stride + 1
    n = o // groups
    ch = _chunk(dtype)
    return _plan(b * t_out, n, groups, i_f % ch == 0 and n % ch == 0)


def transpose_conv1d_plan(x_shape, w_shape, stride: int, t_out: int, *,
                          dtype: torch.dtype, crop=None) -> GemmPlan:
    """transpose_conv1d_fwd (f32) or transpose_conv1d_fwd_bf16 on
    x [B, T_in, I], w [K, I, O]: one grid layer per output phase
    p < stride, rows (b, j) for the kept row u = j·stride + p (phase 0 has
    the most; without a crop u = t), columns O."""
    b, i, o = x_shape[0], x_shape[2], w_shape[2]
    kept = t_out if crop is None else crop[1] - crop[0]
    ch = _chunk(dtype)
    return _plan(b * -(-kept // stride), o, stride,
                 i % ch == 0 and o % ch == 0)


# -- launch plan of the depthwise kernels ---------------------------------------
# The launchers choose it themselves (lyra_depthwise_plan reports their
# choice for given operands); this is the same rule in Python, for the tests
# (tests/test_torch_cuda.py holds the two equal on the card).

DW_THREADS = 256  # most threads per block
DW_TAPS = 3  # the taps of every Lyra depthwise conv
DW_RUN = 2  # J for k = DW_TAPS; other k run J = 1


class DepthwisePlan(NamedTuple):
    # 16-byte loads and stores of `elems` channels per thread (8 bf16 or 4
    # floats), else one channel per thread.
    vec: bool
    elems: int
    phases: int  # min(dilation, T_out): output t belongs to phase t mod d
    runs: int  # J: outputs t = p + (r·J + j)·d, j < J, of thread (·, r)
    block: Tuple[int, int]  # (lanes, runs): lane = (phase, channel vector)
    grid: Tuple[int, int, int]  # (lane blocks, run blocks, B)


def depthwise_plan(x_shape, k: int, dilation: int, *, dtype: torch.dtype,
                   aligned: bool = True) -> DepthwisePlan:
    """depthwise_conv1d_fwd (f32) or depthwise_conv1d_fwd_bf16 on
    x [B, T_in, C] with k taps; `aligned`: x, w, bias and out all start on
    16 bytes, which the vector path needs beside C.  A block takes up to
    DW_THREADS lanes (phase, channel vector) along x and fills the rest of
    DW_THREADS with runs along y."""
    b, t_in, c = x_shape
    t_out = t_in - (k - 1) * dilation
    vec = aligned and c % _chunk(dtype) == 0
    elems = _chunk(dtype) if vec else 1
    j = DW_RUN if k == DW_TAPS else 1
    phases = min(dilation, t_out)
    lanes = phases * (c // elems)
    per_phase = -(-t_out // dilation)  # outputs of phase 0
    n_runs = -(-per_phase // j)
    bx = min(lanes, DW_THREADS)
    by = min(DW_THREADS // bx, n_runs)
    return DepthwisePlan(vec, elems, phases, j, (bx, by),
                         (-(-lanes // bx), -(-n_runs // by), b))


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


PLAIN = {"conv1d": conv1d_plain, "depthwise": depthwise_conv1d_plain,
         "tconv": transpose_conv1d_plain}


# -- wrappers -------------------------------------------------------------------

def conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, **fused):
    """CONV_2D over time: x [B, T_in, C_in], w [K, I_f, O] → [B, T_out, O]
    with groups = C_in / I_f and T_out = (T_in − K) // stride + 1, with
    the ops of `fused` (Fusion's fields; T_in, C_in are the input's after
    them)."""
    f = Fusion(**fused)
    if not _on_cuda(x, w, bias, f.state, f.res, f.chan):
        return fused_plain(conv1d_plain, x, w, bias, (stride,), f)
    b = x.shape[0]
    t_in, c_in = _conv_input(x, f)
    k, i_f, o = w.shape
    groups = c_in // i_f
    if c_in % i_f or o % groups or t_in < k or f.crop is not None:
        raise ValueError(f"conv1d shapes x {tuple(x.shape)} w {tuple(w.shape)}"
                         f" {f.crop and 'crop'}")
    t_out = (t_in - k) // stride + 1
    out = torch.empty((b, t_out, o), device=x.device, dtype=x.dtype)
    ops, side = _fused_ops(x, f, t_in, out)
    _launch(0, x, _ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, t_in, c_in,
            t_out, o, k, i_f, stride, groups, ops)
    return _result(out, side)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], dilation: int, **fused):
    """DEPTHWISE_CONV_2D over time: x [B, T_in, C], w [K, C] →
    [B, T_in − (K − 1)·dilation, C], with the ops of `fused` (no split or
    crop; T_in counts the state rows)."""
    f = Fusion(**fused)
    if not _on_cuda(x, w, bias, f.state, f.res, f.chan):
        return fused_plain(depthwise_conv1d_plain, x, w, bias, (dilation,), f)
    b, _, c = x.shape
    t_in = _conv_input(x, f)[0]
    k = w.shape[0]
    t_out = t_in - (k - 1) * dilation
    if w.shape[1] != c or t_out < 1 or f.split or f.crop:
        raise ValueError(
            f"depthwise shapes x {tuple(x.shape)} w {tuple(w.shape)}, split "
            f"{f.split}, crop {f.crop}")
    out = torch.empty((b, t_out, c), device=x.device, dtype=x.dtype)
    ops, side = _fused_ops(x, f, t_in, out)
    _launch(1, x, _ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, t_in, c, t_out,
            k, dilation, ops)
    return _result(out, side)


def transpose_conv1d(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int,
                     t_out: int, **fused):
    """TRANSPOSE_CONV over time: x [B, T_in, I], w [K, I, O] → [B, t_out, O],
    t_out ≤ (T_in − 1)·stride + K, with the ops of `fused` (a crop keeps
    rows crop[0] .. crop[1] ≤ t_out of that)."""
    f = Fusion(**fused)
    if not _on_cuda(x, w, bias, f.state, f.res, f.chan):
        return fused_plain(transpose_conv1d_plain, x, w, bias,
                           (stride, t_out), f)
    b = x.shape[0]
    t_in, i = _conv_input(x, f)
    k, _, o = w.shape
    begin, end = f.crop if f.crop is not None else (0, t_out)
    if (w.shape[1] != i or t_out > (t_in - 1) * stride + k
            or not 0 <= begin < end <= t_out):
        raise ValueError(
            f"transpose conv shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"t_out {t_out} crop {f.crop}")
    out = torch.empty((b, end - begin, o), device=x.device, dtype=x.dtype)
    ops, side = _fused_ops(x, f, t_in, out)
    _launch(2, x, _ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, t_in, i,
            end - begin, o, k, stride, ops)
    return _result(out, side)


# -- the core's own kernels (ops/csrc/core_ops.cu) -----------------------------

ELTWISE_OPS = {"add": 1, "sub": 2, "mul": 3, "div": 4}
_FULL, _PER_CHANNEL, _SCALAR = 0, 1, 2  # operand layouts of core_eltwise


class _GatherPart(ctypes.Structure):
    """core_ops.cu's `struct GatherPart`, field for field."""
    _fields_ = ([("src", ctypes.c_void_p), ("b_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in (
                    "ld", "row0", "rstride", "col0", "cstride", "extent")])


GATHER_MAX_PARTS = 8  # core_ops.cu's kMaxParts


@functools.lru_cache(maxsize=None)
def _core_lib() -> ctypes.CDLL:
    lib = cuda_build.load("core_ops.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in _SUFFIX.values():
        elt = getattr(lib, f"lyra_core_eltwise{suffix}")
        elt.argtypes = [p, p, p, ctypes.c_longlong] + [i] * 4 + [p]
        gat = getattr(lib, f"lyra_core_gather{suffix}")
        gat.argtypes = [ctypes.POINTER(_GatherPart)] + [i] * 2 + [p] \
            + [i] * 3 + [p]
        elt.restype = gat.restype = ctypes.c_int
    return lib


def _core_launch(which: int, x: torch.Tensor, *args) -> None:
    """Launch core kernel `which` (0 eltwise, 1 gather) of x's dtype, check
    the launch and count it."""
    counter = CORE_BY_DTYPE[x.dtype][which]
    err = getattr(_core_lib(), f"lyra_{counter.name}")(
        *args, cuda_build.stream_handle(x.device))
    cuda_build.check(err, counter.name)
    counter.launches += 1


def eltwise_plain(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """ADD/SUB/MUL/DIV as the graph's torch ops, broadcasting a constant."""
    return {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}[op](a, b)


def _layout(t: torch.Tensor, shape, c: int) -> int:
    if tuple(t.shape) == tuple(shape):
        return _FULL
    if t.numel() == 1:
        return _SCALAR
    if t.numel() == c and t.shape[-1] == c:
        return _PER_CHANNEL
    raise ValueError(f"eltwise operand {tuple(t.shape)} for {tuple(shape)}")


def eltwise(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """`a op b` (op a key of ELTWISE_OPS) over [B, T, C]: each operand a
    tensor of that shape, a constant per channel (C values) or one
    constant; at least one a tensor.  The kernel core_eltwise on CUDA
    tensors; the plain version (torch's op) on CPU tensors."""
    full = a if a.dim() == 3 else b
    if not _on_cuda(full, a, b):
        return eltwise_plain(a, b, op)
    shape, c = full.shape, full.shape[-1]
    la, lb = _layout(a, shape, c), _layout(b, shape, c)
    out = torch.empty_like(full)
    _core_launch(0, full, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 out.numel(), c, la, lb, ELTWISE_OPS[op])
    return out


class GatherPart(NamedTuple):
    """One part of a gather: rows row0 + t·rstride (t < rows) and channels
    col0 + c·cstride (c < cols) of `src` — a tensor [B, T_p, C_p] or a
    constant [T_p, C_p], the same for every stream."""
    src: torch.Tensor
    row0: int
    rstride: int  # ≥ 1, as cstride
    rows: int
    col0: int
    cstride: int
    cols: int

    def window(self) -> torch.Tensor:
        """The part as [B or 1, rows, cols] (a view)."""
        src = self.src if self.src.dim() == 3 else self.src.unsqueeze(0)
        return src[:, self.row0:self.row0 + (self.rows - 1) * self.rstride + 1:
                   self.rstride,
                   self.col0:self.col0 + (self.cols - 1) * self.cstride + 1:
                   self.cstride]


def gather_plain(parts: Sequence[GatherPart], axis: int,
                 batch: int) -> torch.Tensor:
    """The parts' windows concatenated along `axis` (1 time, 2 channels),
    the graph's STRIDED_SLICE and CONCATENATION as torch ops."""
    wins = [p.window() for p in parts]
    wins = [w.expand(batch, -1, -1) if w.shape[0] != batch else w
            for w in wins]
    return wins[0].contiguous() if len(wins) == 1 else torch.cat(wins, axis)


def gather(parts: Sequence[GatherPart], axis: int, batch: int) -> torch.Tensor:
    """The concatenation along `axis` (1 time, 2 channels) of the parts'
    windows, [batch, T, C]: the kernel core_gather on CUDA tensors, the
    plain version on CPU tensors."""
    if not 1 <= len(parts) <= GATHER_MAX_PARTS or axis not in (1, 2):
        raise ValueError(f"gather of {len(parts)} parts along axis {axis}")
    first = parts[0].src
    if not _on_cuda(first, *(p.src for p in parts)):
        return gather_plain(parts, axis, batch)
    rows = [p.rows for p in parts]
    cols = [p.cols for p in parts]
    if axis == 1:
        t, c = sum(rows), cols[0]
        ok = all(n == c for n in cols)
    else:
        t, c = rows[0], sum(cols)
        ok = all(n == t for n in rows)
    structs = (_GatherPart * len(parts))()
    for s, p in zip(structs, parts):
        shared = p.src.dim() == 2
        t_p, c_p = p.src.shape[-2:]
        last_r = p.row0 + (p.rows - 1) * p.rstride
        last_c = p.col0 + (p.cols - 1) * p.cstride
        ok = ok and (shared or p.src.shape[0] == batch) and min(
            p.rstride, p.cstride, p.rows, p.cols) >= 1 and all(
            0 <= v < n for v, n in ((p.row0, t_p), (last_r, t_p),
                                    (p.col0, c_p), (last_c, c_p)))
        s.src, s.b_stride = p.src.data_ptr(), 0 if shared else t_p * c_p
        s.ld, s.row0, s.rstride = c_p, p.row0, p.rstride
        s.col0, s.cstride = p.col0, p.cstride
        s.extent = p.rows if axis == 1 else p.cols
    if not ok:
        raise ValueError(f"gather parts {[tuple(p[1:]) for p in parts]} "
                         f"along axis {axis}")
    out = torch.empty((batch, t, c), device=first.device, dtype=first.dtype)
    _core_launch(1, first, structs, len(parts), axis, out.data_ptr(), batch,
                 t, c)
    return out
