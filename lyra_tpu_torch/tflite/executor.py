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
to bfloat16, every torch op in bfloat16, and float32 outputs.  int8 and
fakequant modes and fp8 boundary storage are refused until they are ported.
"""

from __future__ import annotations

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


def _batch_axis_ok(axis: int, ndim: int) -> int:
    axis = axis + ndim if axis < 0 else axis
    if axis == 0:
        raise NotImplementedError("op along the batch axis")
    return axis


MODES = {"float": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(mode: str) -> torch.dtype:
    """The float dtype a graph computes in under `mode`."""
    if mode in ("int8", "fakequant"):
        raise NotImplementedError(
            f"mode {mode!r}: only float and bf16 modes are ported (int8 and "
            f"fakequant run in lyra_tpu)")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {sorted(MODES)}")
    return MODES[mode]


def _cast_float(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype) if t.is_floating_point() else t


class GraphFn:
    """One lowered TFLite subgraph: batched op interpreter + initial state.

    Constants live as tensors on `device`, float ones in the compute dtype;
    conv weights are re-laid to the torch layouts once, here.
    """

    def __init__(self, mdef: tfl.ModelDef, signature: str = "serving_default",
                 mode: str = "float", device=None,
                 boundary_store: Optional[str] = None):
        self.dtype = compute_dtype(mode)
        if boundary_store is not None:
            raise NotImplementedError(
                "boundary_store: fp8 layer-boundary storage is not ported")
        self.device = resolve(device)
        sig = mdef.signatures[signature]
        self.sg = mdef.subgraphs[sig["subgraph"]]
        self.sig_inputs: Dict[str, int] = dict(sig["inputs"])
        self.sig_outputs: Dict[str, int] = dict(sig["outputs"])
        self.np_consts = fold_consts(self.sg)
        self.init_state_vals = run_init_subgraphs(mdef, self.sg)
        self.consts: Dict[int, torch.Tensor] = {
            i: _cast_float(torch.as_tensor(np.array(c), device=self.device),
                           self.dtype)
            for i, c in self.np_consts.items()}
        self._var_of_handle: Dict[int, str] = {
            op.outputs[0]: op.options["shared_name"]
            for op in self.sg.ops if op.name == "VAR_HANDLE"}
        self._conv_w: Dict[int, torch.Tensor] = {}
        for op in self.sg.ops:
            if op.options.get("activation") not in _ACT_FNS:
                raise NotImplementedError(
                    f"{op.name} activation {op.options['activation']!r}")
            if op.name not in ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV"):
                continue
            # CONV_2D [O, KH, KW, I] -> [O, I, KH, KW]; DEPTHWISE_CONV_2D
            # [1, KH, KW, O] -> [O, 1, KH, KW]; TRANSPOSE_CONV
            # [O, KH, KW, I] -> [I, O, KH, KW].
            perm = (0, 3, 1, 2) if op.name == "CONV_2D" else (3, 0, 1, 2)
            w = self.consts[op.inputs[1]].permute(perm)
            self._conv_w[op.index] = w.contiguous()

    # -- state ------------------------------------------------------------------
    def init_state(self, batch_size: int) -> State:
        """Initial state over `batch_size` streams; float leaves in the
        compute dtype, as the JAX lowering's."""
        return {k: _cast_float(torch.as_tensor(v, device=self.device),
                               self.dtype).expand(
                    (batch_size,) + v.shape).clone()
                for k, v in self.init_state_vals.items()}

    def __call__(self, state: State, **inputs) -> Tuple[Dict[str, torch.Tensor], State]:
        env: Dict[int, torch.Tensor] = {}
        for name, idx in self.sig_inputs.items():
            env[idx] = _cast_float(inputs[name], self.dtype)
        new_state = dict(state)
        self.run_ops(range(len(self.sg.ops)), env, new_state)
        outputs = {name: _cast_float(self.get(env, idx), torch.float32)
                   for name, idx in self.sig_outputs.items()}
        return outputs, new_state

    # -- op interpreter ---------------------------------------------------------
    def get(self, env, i: int):
        if i < 0:
            return None
        if i in env:
            return env[i]
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


def load_graph(path: str, signature: str = "serving_default",
               mode: str = "float", device=None) -> GraphFn:
    """Parse `path` and lower `signature` (float or bf16 mode) to a batched
    torch function."""
    return GraphFn(tfl.load(path), signature, mode=mode, device=device)

