# Frozen copy of the float path of lyra_tpu_torch/tflite/executor.py at
# commit d33c86f8529266b8cfd7b29e220ae5f0401d98aa, for the benchmark's plain
# reference: the quantized modes, bf16, fp8 boundaries and the kernel hooks
# are cut; the op lowerings are the executor's, op for op.
"""A TFLite streaming graph as a plain float32 PyTorch function.

    y, new_state = graph(state, x)

Every graph tensor's leading batch dim of 1 carries the B streams.  State
leaves are `[B, *variable_shape]`; the variables start from the graph's
CALL_ONCE init subgraph.  Convolutions run as torch's own `F.conv2d` /
`F.conv_transpose2d` in float32: the caller decides TF32 (the benchmark's
comparison turns it off).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import tflite_model as tfl

State = Dict[str, torch.Tensor]

_ACT_FNS = {
    None: lambda x: x,
    "RELU": torch.relu,
    "RELU6": lambda x: torch.clamp(x, 0.0, 6.0),
    "RELU_N1_TO_1": lambda x: torch.clamp(x, -1.0, 1.0),
    "TANH": torch.tanh,
}
_CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")


def dequantize_const(t: tfl.TensorDef) -> np.ndarray:
    """Constant int8/int32 tensor → float32 with per-channel scales applied."""
    data, q = t.data, t.quant
    if q is None or data is None or data.dtype.kind == "f":
        return data
    scale = q.scale.astype(np.float32)
    zp = (q.zero_point.astype(np.float32) if q.zero_point.size
          else np.zeros_like(scale))
    if q.per_channel:
        shape = [1] * data.ndim
        shape[q.quantized_dimension] = scale.size
        scale, zp = scale.reshape(shape), zp.reshape(shape)
    return (data.astype(np.float32) - zp) * scale


def fold_consts(sg: tfl.SubGraphDef) -> Dict[int, np.ndarray]:
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
                val = init_sg.tensors[iop.inputs[1]].data
                if val is None:
                    raise ValueError("non-constant variable initializer")
                state[handles[iop.inputs[0]]] = np.array(val)
            else:
                raise NotImplementedError(f"init subgraph op {iop.name}")
    return state


def _conv2d(x, w, b, stride, dilation, groups):
    """NHWC VALID conv; `w` in torch layout [O, I/groups, KH, KW]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                 dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def _transpose_conv(x, w, b, stride, out_hw):
    """TFLite TRANSPOSE_CONV (VALID) on NHWC, cut to `out_hw`; `w` in
    torch layout [I, O, KH, KW]."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride)
    return y[:, :, :out_hw[0], :out_hw[1]].permute(0, 2, 3, 1)


def _strided_slice(x, begin, end, strides, opts, x_shape: Sequence[int]):
    begin, end = [int(v) for v in begin], [int(v) for v in end]
    strides = [int(v) for v in strides]
    bm, em = opts.get("begin_mask", 0), opts.get("end_mask", 0)
    sm = opts.get("shrink_axis_mask", 0)
    if opts.get("ellipsis_mask", 0) or opts.get("new_axis_mask", 0):
        raise NotImplementedError("ellipsis/new-axis masks")
    if sm & 1 or not (bm & 1 or begin[0] in (0, -1)) or strides[0] != 1:
        raise NotImplementedError("strided slice over the batch axis")
    slices, shrink = [slice(None)], []
    for i in range(1, len(begin)):
        if sm & (1 << i):
            b = begin[i] + (x_shape[i] if begin[i] < 0 else 0)
            slices.append(slice(b, b + 1, 1))
            shrink.append(i)
            continue
        if strides[i] < 1:
            raise NotImplementedError("negative-stride slices")
        slices.append(slice(None if bm & (1 << i) else begin[i],
                            None if em & (1 << i) else end[i], strides[i]))
    out = x[tuple(slices)]
    if shrink:
        out = out.reshape([s for j, s in enumerate(out.shape)
                           if j not in shrink])
    return out


def _axis(axis: int, ndim: int) -> int:
    axis = axis + ndim if axis < 0 else axis
    if axis == 0:
        raise NotImplementedError("op along the batch axis")
    return axis


class Graph:
    """The serving signature of one .tflite file, in float32 on `device`."""

    def __init__(self, path: str, device, signature: str = "serving_default"):
        mdef = tfl.load(path)
        sig = mdef.signatures[signature]
        self.sg = sg = mdef.subgraphs[sig["subgraph"]]
        (self._in,) = dict(sig["inputs"]).values()
        (self._out,) = dict(sig["outputs"]).values()
        self.device = torch.device(device)
        self.np_consts = fold_consts(sg)
        self._init = run_init_subgraphs(mdef, sg)
        self._var = {op.outputs[0]: op.options["shared_name"]
                     for op in sg.ops if op.name == "VAR_HANDLE"}
        self.consts = {
            i: torch.as_tensor(np.array(c), device=self.device).to(
                torch.float32) if np.asarray(c).dtype.kind == "f"
            else torch.as_tensor(np.array(c), device=self.device)
            for i, c in self.np_consts.items()}
        self._w: Dict[int, torch.Tensor] = {}
        for op in sg.ops:
            if op.options.get("activation") not in _ACT_FNS:
                raise NotImplementedError(f"activation of {op.name}")
            if op.name in _CONVS:
                # CONV_2D [O, KH, KW, I] -> [O, I, KH, KW]; DEPTHWISE
                # [1, KH, KW, O] -> [O, 1, KH, KW]; TRANSPOSE_CONV
                # [O, KH, KW, I] -> [I, O, KH, KW].
                perm = (0, 3, 1, 2) if op.name == "CONV_2D" else (3, 0, 1, 2)
                self._w[op.index] = self.consts[op.inputs[1]].permute(
                    perm).contiguous()

    def init_state(self, batch: int) -> State:
        return {k: torch.as_tensor(v, device=self.device).to(torch.float32)
                .expand((batch,) + v.shape).clone()
                for k, v in self._init.items()}

    def _get(self, env, i):
        if i < 0:
            return None
        return env[i] if i in env else self.consts[i]

    def _static(self, i):
        return self.np_consts[i]

    def __call__(self, state: State, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, State]:
        sg, env, new_state = self.sg, {self._in: x.float()}, dict(state)
        for oi, op in enumerate(sg.ops):
            nm, opts = op.name, op.options
            o0 = op.outputs[0] if op.outputs else -1
            act = _ACT_FNS[opts.get("activation")]
            if nm in ("CALL_ONCE", "VAR_HANDLE"):
                continue
            if nm == "READ_VARIABLE":
                env[o0] = new_state[self._var[op.inputs[0]]][:, 0]
            elif nm == "ASSIGN_VARIABLE":
                new_state[self._var[op.inputs[0]]] = self._get(
                    env, op.inputs[1]).unsqueeze(1)
            elif nm == "RESHAPE":
                shape = opts.get("new_shape")
                if shape is None:
                    shape = [int(v) for v in self._static(op.inputs[1])]
                v = self._get(env, op.inputs[0])
                env[o0] = v.reshape([v.shape[0]] + list(shape[1:]))
            elif nm == "CONCATENATION":
                b = next(env[i].shape[0] for i in op.inputs if i in env)
                parts = []
                for i in op.inputs:
                    v = self._get(env, i)
                    if i not in env and v.ndim and v.shape[0] == 1:
                        v = v.expand((b,) + tuple(v.shape[1:]))
                    parts.append(v)
                env[o0] = act(torch.cat(parts, dim=_axis(opts["axis"],
                                                         parts[0].ndim)))
            elif nm == "STRIDED_SLICE":
                env[o0] = _strided_slice(
                    self._get(env, op.inputs[0]),
                    self._static(op.inputs[1]), self._static(op.inputs[2]),
                    self._static(op.inputs[3]), opts,
                    sg.tensors[op.inputs[0]].shape)
            elif nm in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                v, w = self._get(env, op.inputs[0]), self._w[oi]
                groups = v.shape[-1] // w.shape[1]
                env[o0] = act(_conv2d(
                    v, w, self._get(env, op.inputs[2])
                    if len(op.inputs) > 2 else None,
                    (opts["stride_h"], opts["stride_w"]),
                    (opts.get("dilation_h", 1), opts.get("dilation_w", 1)),
                    groups))
            elif nm == "TRANSPOSE_CONV":
                out_shape = [int(v) for v in self._static(op.inputs[0])]
                env[o0] = act(_transpose_conv(
                    self._get(env, op.inputs[2]), self._w[oi],
                    self._get(env, op.inputs[3])
                    if len(op.inputs) > 3 else None,
                    (opts["stride_h"], opts["stride_w"]), out_shape[1:3]))
            elif nm == "LEAKY_RELU":
                v = self._get(env, op.inputs[0])
                env[o0] = torch.where(v >= 0, v, v * opts["alpha"])
            elif nm in ("ADD", "SUB", "MUL", "DIV"):
                a, b = self._get(env, op.inputs[0]), self._get(env, op.inputs[1])
                env[o0] = act({"ADD": torch.add, "SUB": torch.sub,
                               "MUL": torch.mul, "DIV": torch.div}[nm](a, b))
            elif nm == "SPLIT":
                v = self._get(env, op.inputs[1])
                axis = _axis(int(self._static(op.inputs[0])), v.ndim)
                for out, part in zip(op.outputs, torch.chunk(
                        v, opts["num_splits"], dim=axis)):
                    env[out] = part
            elif nm in ("QUANTIZE", "DEQUANTIZE"):
                env[o0] = self._get(env, op.inputs[0])
            else:
                raise NotImplementedError(f"TFLite op {nm}")
        return self._get(env, self._out).float(), new_state


def codebooks(quantizer_path: str) -> np.ndarray:
    """[stages, 16, 64] float32 RVQ codebooks in the encode graph's stage
    order (stage 0, the coarsest, in the packet's first bits): the constant
    operand of each SQUARED_DIFFERENCE."""
    mdef = tfl.load(quantizer_path)
    sg = mdef.subgraphs[mdef.signatures["encode"]["subgraph"]]
    cbs = [np.asarray(sg.tensors[op.inputs[1]].data, np.float32)
           for op in sg.ops if op.name == "SQUARED_DIFFERENCE"]
    return np.stack([c.reshape(16, -1) for c in cbs])
