"""Lower a parsed TFLite graph to a batched PyTorch function with explicit state.

Port of the float and bf16 modes of lyra_tpu/tflite/executor.py.  The JAX
lowering builds a single-stream function and lifts it over streams with
`vmap`; here the lowering is batch-native: every graph tensor's leading
batch dim of 1 carries B streams instead, so one call advances B streams by
one hop.

    outputs, new_state = graph(state, **inputs)

State leaves keep the JAX engine's keys and shapes, `[B, *graph_shape]`
(e.g. `[B, 1, 48, 1, 1]` for a `[1, 48, 1, 1]` variable), so state trees
move between the two packages unchanged (utils/state.py).

The conv lowerings here (`conv2d`, `depthwise_conv2d`, `transpose_conv`) are
the plain version of the conv-stack kernels (ops/conv_stack.py): those
kernels' CPU path calls them.

`mode="bf16"` does what the JAX `GraphLowering` does in that mode: float
dequantization, then float constants, initial state and float inputs cast
to bfloat16, every torch op in bfloat16, and float32 outputs.

The quantized modes are those of the JAX lowering:

  * ``fakequant`` — float compute, with every int8-typed op output and
    QUANTIZE snapped to its tensor's int8 grid (`_fq`);
  * ``int8`` — TFLite's integer-kernel arithmetic for the int8 islands:
    int8 tensors stay int8, convs accumulate exactly (`_int8_conv_acc`:
    float64 convs of integers, exact on every device), and requantization
    is the interpreter's fixed-point pipeline per kernel (`_mbqm` in int64,
    with the rounding `_INT8_ROUNDING` names per op kind).  Quantized
    constants stay raw; the graph's DEQUANTIZE ops mark float consumers.

`boundary_store="f8"` stores every large float intermediate as fp8 e4m3
(`_BoundaryEnv`), cast with XLA's semantics (`_to_e4m3`).  Every
per-channel multiplier, shift, bias and scale these modes need becomes a
tensor on the graph's device when the graph is built, so a step does no
host work and can be captured.  This lowering alone serves these
configurations (and int8 state storage, models/streaming.py), so on the
card their convs run on cuDNN's deterministic algorithms without TF32, as
FusedStack's edges do (`GraphFn.pinned`).
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.utils.device import resolve

State = Dict[str, torch.Tensor]


def dequantize_const(t: tfl.TensorDef) -> np.ndarray:
    """Constant int8/int32 tensor → float32 with per-channel scales applied."""
    data = t.data
    q = t.quant
    if q is None or data is None or data.dtype.kind == "f":
        return data
    scale = q.scale.astype(np.float32)
    zp = q.zero_point.astype(np.float32) if q.zero_point.size else np.zeros_like(scale)
    if q.per_channel:
        shape = [1] * data.ndim
        shape[q.quantized_dimension] = scale.size
        scale = scale.reshape(shape)
        zp = zp.reshape(shape)
    return (data.astype(np.float32) - zp) * scale


def fold_consts(sg: tfl.SubGraphDef) -> Dict[int, np.ndarray]:
    """Constant tensors of `sg`, int8-quantized ones dequantized to f32."""
    consts: Dict[int, np.ndarray] = {}
    for t in sg.tensors:
        if t.data is None:
            continue
        if t.dtype in (np.int8, np.uint8) or (
                t.dtype == np.int32 and t.quant is not None
                and t.quant.scale.size):
            consts[t.index] = dequantize_const(t)
        else:
            consts[t.index] = t.data
    return consts


def run_init_subgraphs(mdef: tfl.ModelDef,
                       sg: tfl.SubGraphDef) -> Dict[str, np.ndarray]:
    """Interpret CALL_ONCE init subgraphs (VAR_HANDLE/ASSIGN of constants)."""
    state: Dict[str, np.ndarray] = {}
    for op in sg.ops:
        if op.name != "CALL_ONCE":
            continue
        init_sg = mdef.subgraphs[op.options["init_subgraph_index"]]
        handles: Dict[int, str] = {}
        for iop in init_sg.ops:
            if iop.name == "VAR_HANDLE":
                handles[iop.outputs[0]] = iop.options["shared_name"]
            elif iop.name == "ASSIGN_VARIABLE":
                name = handles[iop.inputs[0]]
                val = init_sg.tensors[iop.inputs[1]].data
                if val is None:
                    raise ValueError(f"non-constant init for variable {name}")
                state[name] = np.array(val)
            else:
                raise NotImplementedError(f"init subgraph op {iop.name}")
    return state


_ACT_FNS = {
    None: lambda x: x,
    "RELU": torch.relu,
    "RELU6": lambda x: torch.clamp(x, 0.0, 6.0),
    "RELU_N1_TO_1": lambda x: torch.clamp(x, -1.0, 1.0),
    "TANH": torch.tanh,
}


def _check_valid(opts) -> None:
    if opts["padding"] != "VALID":
        raise NotImplementedError(
            f"{opts['padding']} padding (only VALID appears in Lyra graphs)")


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: Tuple[int, int], dilation: Tuple[int, int],
           groups: int) -> torch.Tensor:
    """NHWC VALID conv; `w` in torch layout [O, I/groups, KH, KW]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                 dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], stride: Tuple[int, int],
                     dilation: Tuple[int, int]) -> torch.Tensor:
    """NHWC VALID depthwise conv; `w` in torch layout [O, 1, KH, KW]."""
    return conv2d(x, w, b, stride, dilation, groups=x.shape[-1])


def transpose_conv(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], stride: Tuple[int, int],
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """TFLite TRANSPOSE_CONV (VALID) on NHWC; `w` in torch layout
    [I, O, KH, KW].  out[t] = Σ_k x[(t − k)/s] · W[k] over taps with
    (t − k) % s == 0: the full (T − 1)·s + K rows, cut to `out_hw`."""
    full_h = (x.shape[1] - 1) * stride[0] + w.shape[2]
    full_w = (x.shape[2] - 1) * stride[1] + w.shape[3]
    if out_hw[0] > full_h or out_hw[1] > full_w:
        raise NotImplementedError(
            f"TRANSPOSE_CONV output {tuple(out_hw)} exceeds the VALID "
            f"result ({full_h}, {full_w})")
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride)
    return y[:, :, :out_hw[0], :out_hw[1]].permute(0, 2, 3, 1)


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha)


def strided_slice(x: torch.Tensor, begin, end, strides, opts,
                  x_shape: Sequence[int]) -> torch.Tensor:
    """TF strided-slice (static operands) on a batch-native tensor: axis 0
    carries B streams where the graph has 1, so it must select all of it."""
    begin = [int(v) for v in begin]
    end = [int(v) for v in end]
    strides = [int(v) for v in strides]
    bm, em = opts.get("begin_mask", 0), opts.get("end_mask", 0)
    sm = opts.get("shrink_axis_mask", 0)
    if opts.get("ellipsis_mask", 0) or opts.get("new_axis_mask", 0):
        raise NotImplementedError("ellipsis/new-axis masks not used by Lyra graphs")
    if sm & 1 or not (bm & 1 or begin[0] in (0, -1)) or strides[0] != 1:
        raise NotImplementedError("strided slice over the batch axis")
    slices = [slice(None)]
    shrink = []
    for i in range(1, len(begin)):
        if sm & (1 << i):
            b = begin[i] + (x_shape[i] if begin[i] < 0 else 0)
            slices.append(slice(b, b + 1, 1))
            shrink.append(i)
            continue
        b = None if bm & (1 << i) else begin[i]
        e = None if em & (1 << i) else end[i]
        if strides[i] < 1:
            raise NotImplementedError("negative-stride slices")
        slices.append(slice(b, e, strides[i]))
    out = x[tuple(slices)]
    if shrink:
        out = out.reshape([s for j, s in enumerate(out.shape)
                           if j not in shrink])
    return out


def _fq(x: torch.Tensor, scale: torch.Tensor, zp: float) -> torch.Tensor:
    """Fake-quantize `x` onto an int8 grid (clamp + round half to even);
    `scale` a 0-dim tensor on x's device (a true division)."""
    qv = torch.clamp(torch.round(x / scale + zp), -128.0, 127.0)
    return (qv - zp) * scale


def _fq_params(t: tfl.TensorDef) -> Optional[Tuple[float, float]]:
    """(scale, zp) of `_fq` onto tensor `t`, None where `_fq` is the
    identity (no quantization, or not int8)."""
    q = t.quant
    if q is None or t.dtype != np.int8:
        return None
    return (float(q.scale[0]),
            float(q.zero_point[0]) if q.zero_point.size else 0.0)


# ---- exact TFLite integer-kernel arithmetic (mode="int8") -------------------
#
# TFLite expresses every real-valued rescale `acc * m` (m = s_in*s_w/s_out,
# 0 < m) as a fixed-point multiplier q = round(frexp-mantissa * 2^31) plus a
# base-2 exponent; how that product is rounded back to int32 differs per
# kernel (single rounding, or one of two legacy pipelines).  The helpers
# below are the JAX package's (lyra_tpu/tflite/executor.py) in torch int64
# ops, which wrap like XLA's; qmult and shift are Python ints or int64
# tensors on the accumulator's device.

# Which MultiplyByQuantizedMultiplier rounding each interpreter kernel uses
# (the JAX package's table, probed by tools/probe_int8_rounding.py).
# Elementwise int8 kernels use TFLITE_SINGLE_ROUNDING; depthwise and
# transpose convs ruy's RoundingRightShift (half up); CONV_2D picks by
# filter depth (`_conv_rounding`).
_INT8_ROUNDING = {
    "DEPTHWISE_CONV_2D": "ruy",
    "TRANSPOSE_CONV": "ruy",
    "LEAKY_RELU": "single",
    "ADD": "single",
    "QUANTIZE": "single",
}


def _conv_rounding(filter_in_channels: int) -> str:
    return "ruy" if filter_in_channels >= 256 else "double"


def _quantize_multiplier(m: float) -> Tuple[int, int]:
    """Real multiplier → (int32 fixed-point multiplier, base-2 shift)."""
    if m == 0.0:
        return 0, 0
    mant, shift = math.frexp(m)
    q = int(math.floor(mant * (1 << 31) + 0.5))  # TfLiteRound: half away
    if q == (1 << 31):
        q //= 2
        shift += 1
    if shift < -31:  # underflow: TFLite flushes to zero
        return 0, 0
    if shift > 30:  # saturate (single-rounding limit)
        return (1 << 31) - 1, 30
    assert q <= (1 << 31) - 1, f"multiplier {m} out of range"
    return q, shift


def _pow2(k):
    """2^k for a Python int or an int64 tensor of exponents."""
    if isinstance(k, torch.Tensor):
        return torch.bitwise_left_shift(torch.ones_like(k), k)
    return 1 << k


def _mbqm(acc: torch.Tensor, qmult, shift,
          rounding: str = "single") -> torch.Tensor:
    """MultiplyByQuantizedMultiplier: int32 acc × fixed-point multiplier,
    → int32.  qmult/shift: Python ints or int64 tensors broadcastable
    against `acc` (per channel on its last axis).

    * ``single`` — TFLITE_SINGLE_ROUNDING: (acc·qmult + 2^(30−shift)) >>
      (31 − shift), clamped to int32.
    * ``double`` — gemmlowp: SaturatingRoundingDoublingHighMul (division
      by 2^31 truncated toward zero after an asymmetric nudge), then
      RoundingDivideByPOT (half away from zero).
    * ``ruy`` — the same high mul, then ruy's RoundingRightShift (half up).
    """
    acc = acc.to(torch.int64)
    if rounding == "single":
        total_shift = 31 - shift
        result = (acc * qmult + _pow2(total_shift - 1)) >> total_shift
        return torch.clamp(result, -(1 << 31), (1 << 31) - 1).to(torch.int32)
    assert rounding in ("double", "ruy"), rounding
    if isinstance(shift, torch.Tensor):
        left, right = shift.clamp(min=0), (-shift).clamp(min=0)
    else:
        left, right = max(shift, 0), max(-shift, 0)
    ab = (acc << left) * qmult  # wraps in int64, as XLA's
    nudge = torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    # gemmlowp divides by 2^31 with C truncation toward zero (the
    # asymmetric nudge matches); an arithmetic shift would floor.
    x = torch.div(ab + nudge, 1 << 31, rounding_mode="trunc")
    mask = _pow2(right) - 1
    rem = x & mask
    thresh = mask >> 1
    if rounding == "double":
        thresh = thresh + (x < 0).to(torch.int64)
    return ((x >> right) + (rem > thresh).to(torch.int64)).to(torch.int32)


def _tensor_qparams(t: tfl.TensorDef) -> Tuple[float, int]:
    q = t.quant
    scale = float(q.scale[0])
    zp = int(q.zero_point[0]) if q.zero_point.size else 0
    return scale, zp


def _per_channel_requant_params(t_in, t_w, t_out, out_channels: int):
    """(qmult[C], shift[C]) int32 arrays for s_in*s_w[c]/s_out."""
    s_in, _ = _tensor_qparams(t_in)
    s_out, _ = _tensor_qparams(t_out)
    w_scales = t_w.quant.scale.astype(np.float64)
    if w_scales.size == 1:
        w_scales = np.full(out_channels, w_scales[0])
    qm = np.empty(out_channels, np.int32)
    sh = np.empty(out_channels, np.int32)
    for c in range(out_channels):
        qm[c], sh[c] = _quantize_multiplier(float(s_in) * w_scales[c] / s_out)
    return qm, sh


def _int8_quantize(x: torch.Tensor, scale: torch.Tensor,
                   zp: int) -> torch.Tensor:
    """f32 → int8 (TfLiteRound = half away from zero, then clamp); `scale`
    a 0-dim float32 tensor on x's device."""
    v = x.to(torch.float32) / scale
    v = torch.sign(v) * torch.floor(torch.abs(v) + 0.5)  # round half away
    return torch.clamp(v + zp, -128, 127).to(torch.int8)


def _requantize_params(t_in, t_out) -> Tuple[int, int, int, int]:
    """(zp_in, zp_out, qmult, shift) of an int8 → int8 QUANTIZE."""
    s_in, zp_in = _tensor_qparams(t_in)
    s_out, zp_out = _tensor_qparams(t_out)
    return (zp_in, zp_out, *_quantize_multiplier(s_in / s_out))


def _int8_requantize(x: torch.Tensor, zp_in: int, zp_out: int, qm: int,
                     sh: int) -> torch.Tensor:
    """int8 → int8 rescale (QUANTIZE op with int8 input)."""
    v = _mbqm(x.to(torch.int32) - zp_in, qm, sh,
              _INT8_ROUNDING["QUANTIZE"]) + zp_out
    return torch.clamp(v, -128, 127).to(torch.int8)


def _int8_dequantize(x: torch.Tensor, scale: torch.Tensor,
                     zp: int) -> torch.Tensor:
    return (x.to(torch.float32) - zp) * scale


def _int8_no_fused_activation(op) -> None:
    """The int8 kernels implement activation=NONE only (all the Lyra
    graphs'); a fused RELU* would need the interpreter's quantized clamp
    range, so it is refused when the graph is built."""
    act = op.options.get("activation")
    if act is not None:
        raise NotImplementedError(
            f"int8 {op.name} with fused activation {act!r} is not supported")


def _int8_conv_out(acc: torch.Tensor, bias: Optional[torch.Tensor],
                   qm, sh, zp_out: int, kind: str,
                   filter_in_channels: int) -> torch.Tensor:
    """Shared conv epilogue: +bias, per-channel requant, +zp_out, clamp.
    `acc` int64 [..., C]; bias, qm, sh int64 [C] tensors (or ints)."""
    if bias is not None:
        acc = acc + bias
    rounding = _INT8_ROUNDING.get(kind)
    if rounding is None:  # CONV_2D: ruy microkernel choice by filter depth
        rounding = _conv_rounding(filter_in_channels)
    out = _mbqm(acc, qm, sh, rounding) + zp_out
    return torch.clamp(out, -128, 127).to(torch.int8)


def _leaky_params(alpha: float, t_in, t_out) -> tuple:
    """(zp_in, zp_out, (qmult, shift) of x ≥ 0, (qmult, shift) of x < 0)."""
    s_in, zp_in = _tensor_qparams(t_in)
    s_out, zp_out = _tensor_qparams(t_out)
    return (zp_in, zp_out, _quantize_multiplier(s_in / s_out),
            _quantize_multiplier(s_in * alpha / s_out))


def _int8_leaky_relu(x: torch.Tensor, zp_in: int, zp_out: int, pos,
                     neg) -> torch.Tensor:
    v = x.to(torch.int32) - zp_in
    rounding = _INT8_ROUNDING["LEAKY_RELU"]
    out = torch.where(v >= 0, _mbqm(v, *pos, rounding),
                      _mbqm(v, *neg, rounding)) + zp_out
    return torch.clamp(out, -128, 127).to(torch.int8)


_ADD_LEFT_SHIFT = 20


def _add_params(t_a, t_b, t_out) -> tuple:
    """TFLite quantized ADD's (zp_a, zp_b, zp_out, (qm, sh) of a, of b, of
    the sum): both inputs rescaled into a 2^20 headroom domain relative to
    twice the larger input scale."""
    s_a, zp_a = _tensor_qparams(t_a)
    s_b, zp_b = _tensor_qparams(t_b)
    s_out, zp_out = _tensor_qparams(t_out)
    twice_max = 2.0 * max(s_a, s_b)
    return (zp_a, zp_b, zp_out, _quantize_multiplier(s_a / twice_max),
            _quantize_multiplier(s_b / twice_max),
            _quantize_multiplier(
                twice_max / ((1 << _ADD_LEFT_SHIFT) * s_out)))


def _int8_add(a: torch.Tensor, b: torch.Tensor, zp_a: int, zp_b: int,
              zp_out: int, qa, qb, qo) -> torch.Tensor:
    rounding = _INT8_ROUNDING["ADD"]
    va = (a.to(torch.int32) - zp_a) << _ADD_LEFT_SHIFT
    vb = (b.to(torch.int32) - zp_b) << _ADD_LEFT_SHIFT
    s = _mbqm(va, *qa, rounding) + _mbqm(vb, *qb, rounding)
    out = _mbqm(s, *qo, rounding) + zp_out
    return torch.clamp(out, -128, 127).to(torch.int8)


# The integer accumulations run as float64 convs of the zero-point-shifted
# integers: PyTorch has no integer conv on the card.  Every product is an
# integer of magnitude ≤ 255·128 and a sum has at most C_in·K·K' of them,
# so every partial sum is an integer below 255·128·C_in·K·K' — at most
# ~1.1e8 in the Lyra graphs (C_in·K = 64·52 in LyraGAN's output transpose
# conv), ≪ 2^53 — and float64 holds it exactly whatever the order of the
# sum.  (float32 would not: 255·127·1536 > 2^24.)

def _int8_conv_acc(x: torch.Tensor, w: torch.Tensor, zp_in: int,
                   stride: Tuple[int, int], dilation: Tuple[int, int],
                   groups: int) -> torch.Tensor:
    """Integer CONV_2D / DEPTHWISE_CONV_2D accumulation, NHWC:
    (x − zp_in) ⊛ w, → int64.  `w` the integer weights as float64 in
    torch layout.  Out-of-range taps contribute zero in the TFLite kernel,
    which is zero padding of the zp-shifted input (Lyra's convs are
    VALID)."""
    x64 = (x.to(torch.int32) - zp_in).to(torch.float64)
    y = F.conv2d(x64.permute(0, 3, 1, 2), w, None, stride=stride,
                 dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1).to(torch.int64)


def _int8_transpose_conv_acc(x: torch.Tensor, w: torch.Tensor, zp_in: int,
                             stride: Tuple[int, int]) -> torch.Tensor:
    """Integer TRANSPOSE_CONV accumulation (the full VALID correlation,
    (T − 1)·s + K rows), NHWC → int64; `w` float64 [I, O, KH, KW]."""
    x64 = (x.to(torch.int32) - zp_in).to(torch.float64)
    y = F.conv_transpose2d(x64.permute(0, 3, 1, 2), w, None, stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int64)


# ---- fp8 layer-boundary storage (boundary_store="f8") -----------------------

# Float intermediates below this element count stay in the compute dtype
# (the JAX package's threshold: the convert pair would cost more than the
# bytes it saves).
_BOUNDARY_MIN_ELEMS = 1024
# XLA's f32/bf16 → float8_e4m3fn convert rounds to nearest even and gives
# NaN where the result would exceed e4m3's largest finite value, 448 (the
# format has no infinity); torch's convert saturates to ±448 instead.
# Ties at 464 round to 448 (even), so NaN is exactly |x| > 464, ±inf and
# NaN — with the sign of x, as XLA's.
_E4M3_LAST = 464.0
_E4M3_NAN_BITS = (0x7F, 0xFF)  # positive, negative


def _to_e4m3(v: torch.Tensor, sign: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """`v` (float32 or bfloat16) → float8_e4m3fn with the JAX package's
    (XLA's) semantics, bit for bit.  A NaN result takes the sign of `sign`
    (default `v`): `_BoundaryEnv` passes the value before its pre-scale,
    because XLA's multiply keeps a NaN's sign and torch's does not always
    (a vectorized bf16 multiply on the CPU, any on the card)."""
    bits = v.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(torch.signbit(v if sign is None else sign),
                      _E4M3_NAN_BITS[1], _E4M3_NAN_BITS[0])
    out = ~(torch.abs(v) <= _E4M3_LAST)
    return torch.where(out, nan.to(torch.uint8), bits).view(
        torch.float8_e4m3fn)


class _BoundaryEnv(dict):
    """Tensor environment that stores large float intermediates as fp8
    (the JAX package's class): a float value stored at a wrapped index is
    pre-scaled by the power-of-two `scale` in its own dtype and cast to
    e4m3; `load` casts back to the compute dtype and undoes the scale."""

    def __init__(self, wrap: frozenset, scale: float, dtype: torch.dtype,
                 scales: Dict[torch.dtype, Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self._wrap = wrap
        self._scale = scale
        self._dtype = dtype
        self._scales = scales  # dtype → (scale, 1 / scale), 0-dim tensors

    @staticmethod
    def scales(scale: float, device) -> Dict[torch.dtype, tuple]:
        """`scale` and its inverse as 0-dim tensors of each float dtype on
        `device`, made once per graph (a step copies nothing from the
        host)."""
        return {d: (torch.tensor(scale, dtype=d, device=device),
                    torch.tensor(1.0 / scale, dtype=d, device=device))
                for d in (torch.float32, torch.bfloat16)}

    def __setitem__(self, i, v):
        if (i in self._wrap and v.is_floating_point()
                and v.dtype != torch.float8_e4m3fn):
            x = v
            if self._scale != 1.0:
                v = v * self._scales[v.dtype][0]
            v = _to_e4m3(v, sign=x)
        super().__setitem__(i, v)

    def load(self, v: torch.Tensor) -> torch.Tensor:
        v = v.to(self._dtype)
        if self._scale != 1.0:
            v = v * self._scales[self._dtype][1]
        return v


def _batch_axis_ok(axis: int, ndim: int) -> int:
    axis = axis + ndim if axis < 0 else axis
    if axis == 0:
        raise NotImplementedError("op along the batch axis")
    return axis


MODES = {"float": torch.float32, "bf16": torch.bfloat16,
         "fakequant": torch.float32, "int8": torch.float32}
# The modes only the plain lowering runs (the JAX package's xla lowering):
# no kernel of the port computes them.
QUANT_MODES = ("fakequant", "int8")


def compute_dtype(mode: str) -> torch.dtype:
    """The float dtype a graph computes in under `mode`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {sorted(MODES)}")
    return MODES[mode]


def check_boundary(mode: str, boundary_store, boundary_scale: float) -> None:
    """The JAX lowering's checks of the fp8 boundary arguments."""
    if boundary_store not in (None, "f8"):
        raise ValueError(
            f"unsupported boundary_store {boundary_store!r} (None or 'f8')")
    if boundary_store is not None and mode not in ("float", "bf16"):
        # fakequant/int8 already define their own boundary storage;
        # stacking fp8 on top would silently change their oracles.
        raise ValueError("boundary_store requires mode 'float'/'bf16'")
    if boundary_scale <= 0 or (boundary_scale != 1.0 and
                               np.log2(boundary_scale) % 1 != 0):
        raise ValueError(
            f"boundary_scale must be a positive power of two (exact in "
            f"both directions), got {boundary_scale}")


def _cast_float(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype) if t.is_floating_point() else t


_CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")
# Ops whose int8-typed output fakequant snaps to the grid.
_FQ_OPS = _CONVS + ("LEAKY_RELU", "ADD", "SUB", "MUL", "DIV", "QUANTIZE")


class GraphFn:
    """One lowered TFLite subgraph: batched op interpreter + initial state.

    Constants live as tensors on `device`, float ones in the compute dtype;
    conv weights are re-laid to the torch layouts once, here, and so are
    the int8 mode's per-op parameters.  The mode sets the compute dtype
    (`MODES`): int8 and fakequant compute their float ops in float32, as
    the JAX lowering requires of int8.
    """

    def __init__(self, mdef: tfl.ModelDef, signature: str = "serving_default",
                 mode: str = "float", device=None,
                 boundary_store: Optional[str] = None,
                 boundary_scale: float = 1.0, *, pin: bool = False):
        self.dtype = compute_dtype(mode)
        check_boundary(mode, boundary_store, boundary_scale)
        self.mode = "float" if mode == "bf16" else mode
        self.boundary_store = boundary_store
        self.boundary_scale = float(boundary_scale)
        # Pin the convs (see _pinned) where this lowering alone serves the
        # graph: the quantized modes and fp8 boundaries, and, by `pin`, any
        # other configuration its caller serves on it alone (int8 state
        # storage, models/streaming.py).
        self.pinned = (pin or self.mode != "float"
                       or boundary_store is not None)
        self.device = resolve(device)
        sig = mdef.signatures[signature]
        self.sg = mdef.subgraphs[sig["subgraph"]]
        self.sig_inputs: Dict[str, int] = dict(sig["inputs"])
        self.sig_outputs: Dict[str, int] = dict(sig["outputs"])
        # int8 mode keeps constants raw: the graph's own DEQUANTIZE ops
        # mark where float ops consume them (as constants of their own,
        # below), and the quantized islands want the integer values.
        self.np_consts = fold_consts(self.sg) if self.mode != "int8" else {
            t.index: t.data for t in self.sg.tensors if t.data is not None}
        self.init_state_vals = run_init_subgraphs(mdef, self.sg)
        self._var_of_handle: Dict[int, str] = {
            op.outputs[0]: op.options["shared_name"]
            for op in self.sg.ops if op.name == "VAR_HANDLE"}
        # int8 mode: op index → (fn, input indices, args, kwargs), the op
        # computing fn(*inputs, *args, **kwargs); None where the op's output
        # became a constant.
        self._int8: Dict[int, Optional[tuple]] = {}
        if self.mode == "int8":
            self._lower_int8()
        self.consts: Dict[int, torch.Tensor] = {
            i: _cast_float(torch.as_tensor(np.array(c), device=self.device),
                           self.dtype)
            for i, c in self.np_consts.items()}
        self._fq: Dict[int, Tuple[torch.Tensor, float]] = {}
        self._conv_w: Dict[int, torch.Tensor] = {}
        for op in self.sg.ops:
            if op.options.get("activation") not in _ACT_FNS:
                raise NotImplementedError(
                    f"{op.name} activation {op.options['activation']!r}")
            if self.mode == "fakequant" and op.name in _FQ_OPS:
                fq = _fq_params(self.sg.tensors[op.outputs[0]])
                if fq is not None:
                    self._fq[op.index] = (torch.tensor(
                        fq[0], dtype=self.dtype, device=self.device), fq[1])
            if op.name not in _CONVS or op.index in self._int8:
                continue
            bias = 3 if op.name == "TRANSPOSE_CONV" else 2
            self._float_operand(op.inputs[1])
            if len(op.inputs) > bias:
                self._float_operand(op.inputs[bias])
            # CONV_2D [O, KH, KW, I] -> [O, I, KH, KW]; DEPTHWISE_CONV_2D
            # [1, KH, KW, O] -> [O, 1, KH, KW]; TRANSPOSE_CONV
            # [O, KH, KW, I] -> [I, O, KH, KW].
            perm = (0, 3, 1, 2) if op.name == "CONV_2D" else (3, 0, 1, 2)
            w = self.consts[op.inputs[1]].permute(perm)
            self._conv_w[op.index] = w.contiguous()
        # boundary_store="f8": every large float intermediate materializes
        # as fp8 e4m3 (see _BoundaryEnv); graph inputs/outputs keep their
        # contract dtypes, and state stays in the compute dtype (ASSIGN
        # reads back through get(), which loads).
        io = set(self.sig_outputs.values()) | set(self.sig_inputs.values())
        self._boundary_wrap = frozenset(
            t.index for t in self.sg.tensors
            if boundary_store == "f8" and t.data is None
            and t.dtype == np.float32
            and int(np.prod(t.shape or (0,))) >= _BOUNDARY_MIN_ELEMS
            and t.index not in io)
        self._boundary_scales = (_BoundaryEnv.scales(self.boundary_scale,
                                                     self.device)
                                 if self._boundary_wrap else None)

    def _float_operand(self, i: int) -> None:
        """int8 mode: a float op reading a raw quantized constant (hybrid
        or dynamic-range quantization) would compute on raw integers
        scaled ~100x off — refused when the graph is built."""
        if i < 0 or self.mode != "int8":
            return
        t = self.sg.tensors[i]
        if (i in self.np_consts and t.quant is not None and t.quant.scale.size
                and t.dtype in (np.int8, np.uint8, np.int32)):
            raise NotImplementedError(
                f"float op consumes raw quantized constant {t.name} in int8 "
                f"mode (hybrid quantization is not supported)")

    # -- int8 mode ---------------------------------------------------------------
    def _lower_int8(self) -> None:
        """The int8 islands' entries in `_int8` (see __init__): every op
        with an int8 output, each QUANTIZE, and each DEQUANTIZE of a
        tensor (a DEQUANTIZE of a constant becomes a float constant).  Int8
        ops the interpreter's kernels would compute otherwise are refused
        here, as the JAX lowering refuses them when it traces."""
        sg, dev = self.sg, self.device
        meta = sg.tensors

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        for op in sg.ops:
            if not op.outputs:
                continue
            nm, o0 = op.name, op.outputs[0]
            t_out = meta[o0]
            opts = op.options
            if nm == "DEQUANTIZE":
                t_in = meta[op.inputs[0]]
                if op.inputs[0] in self.np_consts:
                    # Constant weights: per-channel dequantization.
                    self.np_consts[o0] = dequantize_const(t_in)
                    self._int8[op.index] = None
                    continue
                scale, zp = _tensor_qparams(t_in)
                self._int8[op.index] = (_int8_dequantize, op.inputs[:1], (),
                                        dict(scale=scalar(scale), zp=zp))
            elif nm == "QUANTIZE":
                t_in = meta[op.inputs[0]]
                if t_in.dtype == np.int8:
                    self._int8[op.index] = (
                        _int8_requantize, op.inputs[:1],
                        _requantize_params(t_in, t_out), {})
                else:
                    scale, zp = _tensor_qparams(t_out)
                    self._int8[op.index] = (_int8_quantize, op.inputs[:1], (),
                                            dict(scale=scalar(scale), zp=zp))
            elif t_out.dtype != np.int8:
                continue
            elif nm == "CONCATENATION":
                # The interpreter requantizes concat inputs whose qparams
                # differ from the output's; the (Lyra-graph) equal-qparams
                # case is a plain concatenation, the rest is refused.
                qp = [_tensor_qparams(meta[i]) for i in (*op.inputs, o0)]
                if any(q != qp[0] for q in qp[1:]):
                    raise NotImplementedError(
                        "int8 CONCATENATION with differing quantization "
                        "params is not supported")
            elif nm in ("SUB", "MUL", "DIV"):
                # Raw integer a-b / a*b would ignore scales and zero
                # points; only the ADD kernel's requantization exists.
                raise NotImplementedError(f"int8 {nm} is not supported")
            elif nm == "ADD":
                _int8_no_fused_activation(op)
                self._int8[op.index] = (
                    _int8_add, op.inputs[:2],
                    _add_params(meta[op.inputs[0]], meta[op.inputs[1]],
                                t_out), {})
            elif nm == "LEAKY_RELU":
                self._int8[op.index] = (
                    _int8_leaky_relu, op.inputs[:1],
                    _leaky_params(opts["alpha"], meta[op.inputs[0]], t_out),
                    {})
            elif nm in _CONVS:
                _int8_no_fused_activation(op)
                _check_valid(opts)
                self._int8[op.index] = self._int8_conv(op)

    def _int8_conv(self, op) -> tuple:
        """An int8 conv op's entry: exact accumulation (`_int8_conv_acc`,
        `_int8_transpose_conv_acc`), then `_int8_conv_out`."""
        meta, dev, nm = self.sg.tensors, self.device, op.name
        x_i = op.inputs[2 if nm == "TRANSPOSE_CONV" else 0]
        b_i = op.inputs[3 if nm == "TRANSPOSE_CONV" else 2] \
            if len(op.inputs) > (3 if nm == "TRANSPOSE_CONV" else 2) else -1
        t_in, t_w, t_out = meta[x_i], meta[op.inputs[1]], meta[op.outputs[0]]
        w = np.asarray(self.np_consts[op.inputs[1]])
        perm = (0, 3, 1, 2) if nm == "CONV_2D" else (3, 0, 1, 2)
        w64 = torch.as_tensor(w.astype(np.float64), device=dev).permute(
            perm).contiguous()
        c_out = int(t_out.shape[-1])
        qm, sh = _per_channel_requant_params(t_in, t_w, t_out, c_out)
        bias = (torch.as_tensor(np.asarray(self.np_consts[b_i], np.int64),
                                device=dev) if b_i >= 0 else None)
        _, zp_in = _tensor_qparams(t_in)
        _, zp_out = _tensor_qparams(t_out)
        opts = op.options
        stride = (opts["stride_h"], opts["stride_w"])
        if nm == "TRANSPOSE_CONV":
            out_shape = [int(v) for v in self.static(op.inputs[0])]
            full = [(t_in.shape[1] - 1) * stride[0] + w.shape[1],
                    (t_in.shape[2] - 1) * stride[1] + w.shape[2]]
            if full != out_shape[1:3]:
                # The int8 lowering implements the full-correlation
                # (VALID) output the Lyra graphs declare; anything else
                # would silently misalign.
                raise NotImplementedError(
                    f"int8 TRANSPOSE_CONV output {full} != declared "
                    f"{out_shape[1:3]} (unsupported padding)")
            acc = partial(_int8_transpose_conv_acc, w=w64, zp_in=zp_in,
                          stride=stride)
        else:
            groups = (int(t_in.shape[-1]) // int(w.shape[-1])
                      if nm == "CONV_2D" else int(t_in.shape[-1]))
            if nm == "DEPTHWISE_CONV_2D" and w64.shape[0] != t_in.shape[-1]:
                raise NotImplementedError("depth_multiplier != 1")
            acc = partial(_int8_conv_acc, w=w64, zp_in=zp_in, stride=stride,
                          dilation=(opts.get("dilation_h", 1),
                                    opts.get("dilation_w", 1)),
                          groups=groups)
        params = (bias, torch.as_tensor(qm.astype(np.int64), device=dev),
                  torch.as_tensor(sh.astype(np.int64), device=dev), zp_out,
                  nm, int(w.shape[-1]))
        return (lambda x: _int8_conv_out(acc(x), *params), (x_i,), (), {})

    # -- state ------------------------------------------------------------------
    def init_state(self, batch_size: int) -> State:
        """Initial state over `batch_size` streams; float leaves in the
        compute dtype, as the JAX lowering's."""
        return {k: _cast_float(torch.as_tensor(v, device=self.device),
                               self.dtype).expand(
                    (batch_size,) + v.shape).clone()
                for k, v in self.init_state_vals.items()}

    def _pinned(self):
        """Where `pinned` (the configurations this lowering alone serves),
        the convs run on cuDNN's deterministic algorithms without TF32 on
        the card, as FusedStack's edges: a replay gives an eager call's
        bits, every process the same bits, and a QUANTIZE input lands on
        the same side of its rounding edge in all of them.  The float and
        bf16 reference keeps cuDNN's choice."""
        if not self.pinned:
            return contextlib.nullcontext()
        return torch.backends.cudnn.flags(
            enabled=True, deterministic=True, allow_tf32=False)

    def __call__(self, state: State, **inputs) -> Tuple[Dict[str, torch.Tensor], State]:
        return self._run(state, inputs)[:2]

    def lower(self, capture_env: bool = False) -> Callable:
        """`fn(state, **inputs)`: this graph's call; with capture_env=True
        it also returns the full tensor-index → value environment (the JAX
        `lower(capture_env=True)`), every int8 tensor included."""
        if not capture_env:
            return self.__call__
        return lambda state, **inputs: self._run(state, inputs)

    def _run(self, state: State, inputs):
        env: Dict[int, torch.Tensor] = (
            _BoundaryEnv(self._boundary_wrap, self.boundary_scale,
                         self.dtype, self._boundary_scales)
            if self._boundary_wrap else {})
        for name, idx in self.sig_inputs.items():
            env[idx] = _cast_float(inputs[name], self.dtype)
        new_state = dict(state)
        with self._pinned():
            self.run_ops(range(len(self.sg.ops)), env, new_state)
        outputs = {name: _cast_float(self.get(env, idx), torch.float32)
                   for name, idx in self.sig_outputs.items()}
        return outputs, new_state, env

    # -- op interpreter ---------------------------------------------------------
    def get(self, env, i: int):
        if i < 0:
            return None
        if i in env:
            v = env[i]
            if v.dtype == torch.float8_e4m3fn:
                v = env.load(v)
            return v
        if i in self.consts:
            return self.consts[i]
        raise KeyError(
            f"tensor {i} ({self.sg.tensors[i].name}) used before defined")

    def static(self, i: int) -> np.ndarray:
        if i not in self.np_consts:
            raise ValueError(
                f"tensor {i} ({self.sg.tensors[i].name}) must be a static constant")
        return self.np_consts[i]

    def _batched_const(self, env, i: int, batch: int) -> torch.Tensor:
        """A graph operand with its leading dim of 1 expanded to B."""
        v = self.get(env, i)
        if i not in env and v.ndim and v.shape[0] == 1:
            v = v.expand((batch,) + tuple(v.shape[1:]))
        return v

    def run_ops(self, op_indices, env, new_state: State,
                convs: Optional[Dict[int, Callable]] = None) -> None:
        """Run `op_indices` in order over `env` (tensor index → value);
        READ/ASSIGN_VARIABLE read and write `new_state` in place.

        `convs` maps a conv op's index to a function on channels-last
        `[B, T, C]` activations (the conv-stack kernels): that op runs it
        on its input's view without the graph's W = 1 axis instead of the
        lowering below.  Such ops must have no fused activation."""
        sg = self.sg
        convs = convs or {}
        for oi in op_indices:
            op = sg.ops[oi]
            nm = op.name
            o0 = op.outputs[0] if op.outputs else -1
            opts = op.options
            if nm in ("CALL_ONCE", "VAR_HANDLE"):
                continue
            if oi in self._int8:
                if self._int8[oi] is not None:
                    fn, ins, args, kw = self._int8[oi]
                    env[o0] = fn(*(self.get(env, i) for i in ins), *args, **kw)
                continue
            if oi in convs:
                x = self.get(env, op.inputs[2 if nm == "TRANSPOSE_CONV" else 0])
                env[o0] = convs[oi](x[:, :, 0].contiguous()).unsqueeze(2)
            elif nm == "READ_VARIABLE":
                env[o0] = new_state[self._var_of_handle[op.inputs[0]]][:, 0]
            elif nm == "ASSIGN_VARIABLE":
                v = self.get(env, op.inputs[1])
                new_state[self._var_of_handle[op.inputs[0]]] = v.unsqueeze(1)
            elif nm == "RESHAPE":
                shape = opts.get("new_shape")
                if shape is None:
                    shape = [int(v) for v in self.static(op.inputs[1])]
                x = self.get(env, op.inputs[0])
                if not shape or shape[0] not in (1, -1):
                    raise NotImplementedError(
                        f"RESHAPE to {shape} folds the batch axis")
                env[o0] = x.reshape([x.shape[0]] + list(shape[1:]))
            elif nm == "CONCATENATION":
                batch = next(env[i].shape[0] for i in op.inputs if i in env)
                parts = [self._batched_const(env, i, batch) for i in op.inputs]
                axis = _batch_axis_ok(opts["axis"], parts[0].ndim)
                env[o0] = _ACT_FNS[opts.get("activation")](
                    torch.cat(parts, dim=axis))
            elif nm == "STRIDED_SLICE":
                x = self.get(env, op.inputs[0])
                env[o0] = strided_slice(
                    x, self.static(op.inputs[1]), self.static(op.inputs[2]),
                    self.static(op.inputs[3]), opts, sg.tensors[op.inputs[0]].shape)
            elif nm == "CONV_2D":
                _check_valid(opts)
                x = self.get(env, op.inputs[0])
                w = self._conv_w[oi]
                out = conv2d(x, w, self.get(env, op.inputs[2]) if len(op.inputs) > 2 else None,
                             (opts["stride_h"], opts["stride_w"]),
                             (opts.get("dilation_h", 1), opts.get("dilation_w", 1)),
                             groups=x.shape[-1] // w.shape[1])
                env[o0] = _ACT_FNS[opts.get("activation")](out)
            elif nm == "DEPTHWISE_CONV_2D":
                _check_valid(opts)
                x = self.get(env, op.inputs[0])
                if self._conv_w[oi].shape[0] != x.shape[-1]:
                    raise NotImplementedError("depth_multiplier != 1")
                out = depthwise_conv2d(
                    x, self._conv_w[oi],
                    self.get(env, op.inputs[2]) if len(op.inputs) > 2 else None,
                    (opts["stride_h"], opts["stride_w"]),
                    (opts.get("dilation_h", 1), opts.get("dilation_w", 1)))
                env[o0] = _ACT_FNS[opts.get("activation")](out)
            elif nm == "TRANSPOSE_CONV":
                _check_valid(opts)
                out_shape = [int(v) for v in self.static(op.inputs[0])]
                out = transpose_conv(
                    self.get(env, op.inputs[2]), self._conv_w[oi],
                    self.get(env, op.inputs[3]) if len(op.inputs) > 3 else None,
                    (opts["stride_h"], opts["stride_w"]), out_shape[1:3])
                env[o0] = _ACT_FNS[opts.get("activation")](out)
            elif nm == "LEAKY_RELU":
                env[o0] = leaky_relu(self.get(env, op.inputs[0]), opts["alpha"])
            elif nm in ("ADD", "SUB", "MUL", "DIV"):
                a, b = self.get(env, op.inputs[0]), self.get(env, op.inputs[1])
                out = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul,
                       "DIV": torch.div}[nm](a, b)
                env[o0] = _ACT_FNS[opts.get("activation")](out)
            elif nm == "SPLIT":
                x = self.get(env, op.inputs[1])
                axis = _batch_axis_ok(int(self.static(op.inputs[0])), x.ndim)
                for out_idx, part in zip(op.outputs, torch.chunk(
                        x, opts["num_splits"], dim=axis)):
                    env[out_idx] = part
            elif nm in ("QUANTIZE", "DEQUANTIZE"):
                env[o0] = self.get(env, op.inputs[0])
            else:
                raise NotImplementedError(f"TFLite op {nm} not supported")
            if oi in self._fq:
                env[o0] = _fq(self.get(env, o0), *self._fq[oi])


def load_graph(path: str, signature: str = "serving_default",
               mode: str = "float", device=None,
               boundary_store: Optional[str] = None,
               boundary_scale: float = 1.0, *, pin: bool = False) -> GraphFn:
    """Parse `path` and lower `signature` to a batched torch function.

    boundary_store="f8" stores large layer-boundary activations as fp8
    e4m3 (see _BoundaryEnv); boundary_scale is a power-of-two pre-scale
    for graphs whose activations exceed e4m3's 448.  pin=True pins the
    convs (GraphFn._pinned) in float and bf16 too, for a caller that
    serves the graph on this lowering alone."""
    return GraphFn(tfl.load(path), signature, mode=mode, device=device,
                   boundary_store=boundary_store,
                   boundary_scale=boundary_scale, pin=pin)

