"""Partitioned conv-stack executor: torch audio edges around a kernel core.

Port of `lyra_tpu/ops/fused_stack.py::FusedStackKernel`.  The graph
analysis is the same pure-numpy dataflow partition (`_find_state_shapes`,
`_partition`, `_validate_core`, `_mapped_shape`): any op touching a
channel-1 activation is an audio *edge* op (SoundStream's first strided
conv with its 48-sample input context; LyraGAN's final transpose conv with
its overlap-add tail); edge ops ahead of the multi-channel core form the
prologue, the rest the epilogue.

Prologue, core and epilogue run in that order through the executor's op
interpreter (tflite/executor.py), with one difference: the core's three
conv kinds go to the conv-stack kernels (ops/conv_stack.py), which launch
the CUDA kernels on a CUDA tensor and run the executor's lowering on a CPU
tensor.  The elementwise and data-movement ops between them stay torch
ops.  Fusing those into the kernels (one persistent kernel for the whole
stack, the Pallas design) is the next step for this kernel.

State trees are the executor's (`[B, *graph_shape]` per variable, the JAX
engine's keys and shapes), so both backends load each other's state.

`mode="bf16"` (the Pallas kernel's default) runs the executor in bf16 and
holds the kernel-layout weights in bf16, so the core's convs go to the
bf16 kernels; the state tree's float leaves are then bf16, as in the JAX
XLA bf16 engine's tree.  Input and output stay float32.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from lyra_tpu_torch.ops import conv_stack, cuda_build
from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.tflite.executor import GraphFn, State


def _mapped_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """Graph tensor shape (leading batch 1) → core shape sans batch."""
    shape = list(shape)
    if not shape or shape[0] != 1:
        raise ValueError(f"expected leading batch dim 1, got {shape}")
    rest = shape[1:]
    if len(rest) == 3 and rest[1] == 1:  # [T, 1, C] -> [T, C]
        return (rest[0], rest[2])
    return tuple(rest)


def _is_c1(shape: Sequence[int]) -> bool:
    """Channel-1 / channel-less tensors stay on the edge side."""
    m = _mapped_shape(shape)
    return len(m) < 2 or m[-1] == 1


class ConvLaunch(NamedTuple):
    """One core conv op as a conv-stack kernel call on `[B, T, C]`."""
    kernel: cuda_build.KernelCounter
    fn: Callable  # the wrapper: kernel on CUDA, plain version on CPU
    plain: Callable
    in_shape: Tuple[int, int]  # the input's [T, C], sans batch
    w: torch.Tensor  # kernel layout
    bias: Optional[torch.Tensor]
    extra: tuple  # stride, dilation or (stride, t_out)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x, self.w, self.bias, *self.extra)


class FusedStack:
    """Same contract as GraphFn for a 1-input/1-output streaming graph:
    `(state, x) → (y, new_state)` with x and y batch-native in graph shape."""

    def __init__(self, path: str, signature: str = "serving_default",
                 mode: str = "float", device=None):
        self.graph = GraphFn(tfl.load(path), signature, mode=mode,
                             device=device)
        gl = self.graph
        self.device = gl.device
        self.sg = gl.sg
        self._consts = gl.np_consts
        if len(gl.sig_inputs) != 1 or len(gl.sig_outputs) != 1:
            raise NotImplementedError("fused stack expects 1 input / 1 output")
        self.input_idx = next(iter(gl.sig_inputs.values()))
        self.output_idx = next(iter(gl.sig_outputs.values()))
        self._var_of_handle: Dict[int, str] = {
            op.outputs[0]: op.options["shared_name"]
            for op in self.sg.ops if op.name == "VAR_HANDLE"}
        self._state_shapes = self._find_state_shapes()
        self._partition()
        self._validate_core()
        self._collect_weights()

    # -- graph analysis (pure numpy) ------------------------------------------
    def _find_state_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {self._var_of_handle[op.inputs[0]]:
                tuple(self.sg.tensors[op.outputs[0]].shape)
                for op in self.sg.ops if op.name == "READ_VARIABLE"}

    def _op_is_edge(self, op) -> bool:
        if op.name in ("CALL_ONCE", "VAR_HANDLE", "SPLIT"):
            return False
        if op.name == "READ_VARIABLE":
            return _is_c1(self._state_shapes[self._var_of_handle[op.inputs[0]]])
        if op.name == "ASSIGN_VARIABLE":
            return _is_c1(self.sg.tensors[op.inputs[1]].shape)
        return any(_is_c1(self.sg.tensors[t].shape)
                   for t in list(op.inputs) + list(op.outputs)
                   if t >= 0 and t not in self._consts)

    def _partition(self) -> None:
        sg = self.sg
        producer: Dict[int, int] = {}
        consumers: Dict[int, List[int]] = {}
        for i, op in enumerate(sg.ops):
            for o in op.outputs:
                producer[o] = i
            for t in op.inputs:
                consumers.setdefault(t, []).append(i)
        edge = [self._op_is_edge(op) for op in sg.ops]
        core = [i for i, op in enumerate(sg.ops)
                if not edge[i] and op.name not in ("CALL_ONCE", "VAR_HANDLE")]
        core_set = set(core)

        # Edge ops whose outputs feed the core (transitively) are prologue.
        reaches: Dict[int, bool] = {}

        def op_reaches(i) -> bool:
            if i in reaches:
                return reaches[i]
            reaches[i] = False
            for o in sg.ops[i].outputs:
                for c in consumers.get(o, []):
                    if c in core_set or (edge[c] and op_reaches(c)):
                        reaches[i] = True
            return reaches[i]

        prologue: Set[int] = {i for i in range(len(sg.ops))
                              if edge[i] and op_reaches(i)}
        # Attach state-maintenance ops (slice/assign of prologue outputs).
        changed = True
        while changed:
            changed = False
            for i, op in enumerate(sg.ops):
                if not edge[i] or i in prologue:
                    continue
                ins = [t for t in op.inputs
                       if t >= 0 and t not in self._consts and t in producer
                       and sg.ops[producer[t]].name != "VAR_HANDLE"]
                if ins and all(producer[t] in prologue for t in ins):
                    prologue.add(i)
                    changed = True
        self._prologue = sorted(prologue)
        self._epilogue = [i for i in range(len(sg.ops))
                          if edge[i] and i not in prologue]
        self._core = core

        epi_outs = {o for i in self._epilogue for o in sg.ops[i].outputs}
        if any(t in epi_outs for i in core for t in sg.ops[i].inputs):
            raise NotImplementedError("core op consumes an epilogue output")

        edge_states: Set[str] = set()
        core_states: Set[str] = set()
        epilogue = set(self._epilogue)
        for i, op in enumerate(sg.ops):
            if op.name in ("READ_VARIABLE", "ASSIGN_VARIABLE"):
                name = self._var_of_handle[op.inputs[0]]
                (edge_states if (i in prologue or i in epilogue)
                 else core_states).add(name)
        if edge_states & core_states:
            raise NotImplementedError("state var shared between edge and core")
        self._core_state_names = sorted(core_states)

    def _validate_core(self) -> None:
        """Refuse what the JAX kernel refuses, so that both backends take
        the same graphs: fused activations (the conv table skips them),
        read-after-assign of a state var inside one tick, and core vars
        read but never assigned."""
        for op in self.sg.ops:
            if (op.name in ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV",
                            "ADD", "SUB", "MUL", "DIV", "CONCATENATION")
                    and op.options.get("activation") is not None):
                raise NotImplementedError(
                    f"fused stack: {op.name} with fused activation "
                    f"{op.options['activation']!r} is not supported")
        assigned = set()
        for i in self._core:
            op = self.sg.ops[i]
            if op.name == "READ_VARIABLE":
                name = self._var_of_handle[op.inputs[0]]
                if name in assigned:
                    raise NotImplementedError(
                        f"fused stack: state var {name!r} read after "
                        f"assign within one tick is not supported")
            elif op.name == "ASSIGN_VARIABLE":
                assigned.add(self._var_of_handle[op.inputs[0]])
        read_only = set(self._core_state_names) - assigned
        if read_only:
            raise NotImplementedError(
                f"fused stack: core state vars {sorted(read_only)} are read "
                f"but never assigned")

    # -- kernel-layout weights --------------------------------------------------
    def _collect_weights(self) -> None:
        """Per core conv op: its conv-stack kernel call, with the weight in
        kernel layout on the device, in the graph's compute dtype."""
        dev, dtype = self.device, self.graph.dtype

        def as_t(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32),
                                device=dev).to(dtype)

        def bias(op, pos):
            if len(op.inputs) > pos and op.inputs[pos] >= 0:
                return as_t(self._consts[op.inputs[pos]])
            return None

        conv1d_k, depthwise_k, tconv_k = conv_stack.BY_DTYPE[dtype]
        self._convs: Dict[int, ConvLaunch] = {}
        for i in self._core:
            op = self.sg.ops[i]
            opts = op.options
            if op.name not in ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV"):
                continue
            x_shape = self.sg.tensors[
                op.inputs[2 if op.name == "TRANSPOSE_CONV" else 0]].shape
            if (opts["padding"] != "VALID" or opts["stride_w"] != 1
                    or opts.get("dilation_w", 1) != 1 or len(x_shape) != 4
                    or x_shape[2] != 1):
                raise NotImplementedError(
                    f"fused stack: {op.name} {opts} on {list(x_shape)} is not "
                    f"a temporal VALID conv")
            w = np.asarray(self._consts[op.inputs[1]], np.float32)
            if op.name == "CONV_2D":  # [O, K, 1, I_f] -> [K, I_f, O]
                if opts.get("dilation_h", 1) != 1:
                    raise NotImplementedError("dilated dense conv not in Lyra graphs")
                call = (conv1d_k, conv_stack.conv1d,
                        conv_stack.conv1d_plain,
                        as_t(np.transpose(w[:, :, 0, :], (1, 2, 0))), bias(op, 2),
                        (opts["stride_h"],))
            elif op.name == "DEPTHWISE_CONV_2D":  # [1, K, 1, C] -> [K, C]
                if opts["stride_h"] != 1:
                    raise NotImplementedError("strided depthwise not in Lyra graphs")
                call = (depthwise_k, conv_stack.depthwise_conv1d,
                        conv_stack.depthwise_conv1d_plain, as_t(w[0, :, 0, :]),
                        bias(op, 2), (opts.get("dilation_h", 1),))
            else:  # TRANSPOSE_CONV [O, K, 1, I] -> [K, I, O]
                call = (tconv_k, conv_stack.transpose_conv1d,
                        conv_stack.transpose_conv1d_plain,
                        as_t(np.transpose(w[:, :, 0, :], (1, 2, 0))), bias(op, 3),
                        (opts["stride_h"], self.sg.tensors[op.outputs[0]].shape[1]))
            kernel, fn, plain, wk, b, extra = call
            self._convs[i] = ConvLaunch(kernel, fn, plain, _mapped_shape(x_shape),
                                        wk, b, extra)

    # -- public API -----------------------------------------------------------
    def init_state(self, batch_size: int) -> State:
        return self.graph.init_state(batch_size)

    def conv_launches(self) -> List[ConvLaunch]:
        """The conv-stack kernel calls one hop makes, in graph order."""
        return list(self._convs.values())

    def __call__(self, state: State, x: torch.Tensor):
        """x: [B, *graph_input_shape[1:]] → ([B, *graph_output_shape[1:]],
        new_state)."""
        env: Dict[int, torch.Tensor] = {self.input_idx: x.to(self.graph.dtype)}
        new_state = dict(state)
        # The audio edges run through cuDNN.  LyraGAN's output edge is a
        # transposed conv, i.e. cuDNN's backward-data pass, whose fastest
        # algorithms sum with atomics: the same inputs then give other bits
        # from run to run (seen at B=1024 on an H100), and a CUDA-graph
        # replay other bits than an eager launch.  Only cuDNN's
        # deterministic algorithms here, then; TF32 stays as the caller set
        # it, and the plain executor (the reference) keeps cuDNN's choice.
        with torch.backends.cudnn.flags(
                enabled=True, deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            self.graph.run_ops(self._prologue + self._core + self._epilogue,
                               env, new_state, convs=self._convs)
        return env[self.output_idx].float(), new_state
