"""Partitioned conv-stack executor: audio edges around a kernel core.

Port of `lyra_tpu/ops/fused_stack.py::FusedStackKernel`.  The graph
analysis is the same pure-numpy dataflow partition (`_find_state_shapes`,
`_partition`, `_validate_core`, `_mapped_shape`): any op touching a
channel-1 activation is an audio *edge* op (SoundStream's first strided
conv with its 48-sample input context; LyraGAN's final transpose conv with
its overlap-add tail); edge ops ahead of the multi-channel core form the
prologue, the rest the epilogue.  An epilogue of LyraGAN's form (the
transpose conv to one channel with a bias, its overlap-add state, views
between) runs as one launch of the output-edge kernel (`_match_edge`,
ops/out_edge.py); the prologue, and an epilogue of any other form, run
through the executor's op interpreter (tflite/executor.py, cuDNN on the
card).

The core runs as a launch plan (`_build_plan`, built once from the graph in
pure Python): one conv-stack kernel call (ops/conv_stack.py) per conv op,
each with the ops it absorbs (`conv_stack.Fusion`), matched on dataflow:

  * input side: the CONCATENATION of a READ_VARIABLE with the conv's
    input (two pointers), a SPLIT or a STRIDED_SLICE of a channel range
    (a channel offset), and a LEAKY_RELU on load where its input is not a
    core conv's output or has other consumers (then every consumer applies
    it);
  * output side: the residual ADD/SUB of a tensor already written (or its
    LEAKY_RELU on load), a MUL or DIV by a per-channel constant, a
    STRIDED_SLICE crop of a transpose conv, and a LEAKY_RELU, in graph
    order; a transpose conv whose sibling absorbs their ADD/SUB writes only
    the rows the crop after it keeps;
  * side store: STRIDED_SLICE → ASSIGN_VARIABLE of that concatenation, by
    the first launch that reads it;
  * QUANTIZE, DEQUANTIZE (identity in float and bf16: the graph's int8
    islands), RESHAPE (same [T, C]) and READ_VARIABLE are views.
Each remaining ADD/SUB/MUL/DIV, CONCATENATION and STRIDED_SLICE is a call
of a core kernel of its own (`CoreLaunch`: conv_stack.eltwise or
conv_stack.gather, a gather also reading the STRIDED_SLICEs that only its
CONCATENATION reads).  Anything else in the core raises
NotImplementedError naming the op.  On the card no torch kernel runs
between the core's first launch and its last (the profiler span
"fused_stack.core"); on CPU tensors each launch runs its plain version,
the graph's torch ops in the graph's order.
`unfused` runs the whole graph op by op with only the convs on the
kernels (the earlier design, the reference of the f32 bitwise check).

State trees are the executor's (`[B, *graph_shape]` per variable, the JAX
engine's keys and shapes), so both backends load each other's state; a
launch writes each new state leaf as a fresh `[B, T, C]` tensor.

`mode="bf16"` (the Pallas kernel's default) runs the executor in bf16 and
holds the kernel-layout weights in bf16, so the core goes to the bf16
kernels; the state tree's float leaves are then bf16, as in the JAX XLA
bf16 engine's tree.  Input and output stay float32.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence, Set,
                    Tuple)


import numpy as np
import torch

from lyra_tpu_torch.ops import conv_stack, cuda_build, out_edge
from lyra_tpu_torch.tflite import executor
from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.tflite.executor import QUANT_MODES, GraphFn, State
from lyra_tpu_torch.utils import trace


def _mapped_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """Graph tensor shape (leading batch 1) → core shape sans batch."""
    shape = list(shape)
    if not shape or shape[0] != 1:
        raise ValueError(f"expected leading batch dim 1, got {shape}")
    rest = shape[1:]
    if len(rest) == 3 and rest[1] == 1:  # [T, 1, C] -> [T, C]
        return (rest[0], rest[2])
    return tuple(rest)


def _batch_axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


def _is_c1(shape: Sequence[int]) -> bool:
    """Channel-1 / channel-less tensors stay on the edge side."""
    m = _mapped_shape(shape)
    return len(m) < 2 or m[-1] == 1


def _window(sg, consts, i):
    """((row0, rstride, rows), (col0, cstride, cols)) of the rows and
    channels of [T, C] a STRIDED_SLICE (op i) keeps, else None."""
    op = sg.ops[i]
    full = sg.tensors[op.inputs[0]].shape
    if (op.inputs[0] in consts or len(full) not in (3, 4)
            or (len(full) == 4 and full[2] != 1) or any(
                op.options.get(m, 0) for m in (
                    "shrink_axis_mask", "ellipsis_mask", "new_axis_mask"))):
        return None
    idx = torch.arange(int(np.prod(full))).reshape(full)
    got = executor.strided_slice(
        idx, consts[op.inputs[1]], consts[op.inputs[2]],
        consts[op.inputs[3]], op.options, full)
    if got.numel() == 0 or got.ndim != len(full) or got.shape[0] != 1:
        return None
    g = got.reshape(got.shape[1], got.shape[-1])
    c_full = full[-1]
    rows, cols = g[:, 0] // c_full, g[0] % c_full
    axes = []
    for v in (rows, cols):
        step = int(v[1] - v[0]) if len(v) > 1 else 1
        if step < 1 or not torch.equal(v, v[0] + step * torch.arange(len(v))):
            return None
        axes.append((int(v[0]), step, len(v)))
    if not torch.equal(g, rows[:, None] * c_full + cols[None, :]):
        return None
    return tuple(axes)


_CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")
# Ops that pass their input on as the same [T, C] (QUANTIZE and DEQUANTIZE
# are identity in float and bf16, as in the Pallas kernel).
_VIEWS = ("RESHAPE", "QUANTIZE", "DEQUANTIZE")


class FusedLaunch(NamedTuple):
    """One core conv op as a conv-stack kernel call on `[B, T, C]`, with
    the graph ops it absorbs."""
    op: int  # the conv op's index
    kind: str  # "conv1d", "depthwise" or "tconv"
    kernel: cuda_build.KernelCounter
    fn: Callable  # the wrapper: kernel on CUDA, plain version on CPU
    w: torch.Tensor  # kernel layout
    bias: Optional[torch.Tensor]
    extra: tuple  # stride, dilation or (stride, t_out)
    in_shape: Tuple[int, int]  # the conv's input [T, C], state rows included
    x: int  # the tensor read as x
    x_shape: Tuple[int, int]  # its [T, C]
    out: int  # the tensor written
    out_shape: Tuple[int, int]
    state: Optional[str] = None  # the state var whose rows precede x's
    split: Optional[Tuple[int, int]] = None
    leaky_in: Optional[float] = None
    res: Optional[int] = None  # the residual tensor
    res_op: str = "add"
    res_leaky: Optional[float] = None
    leaky_out: Optional[float] = None
    crop: Optional[Tuple[int, int]] = None
    side: Optional[Tuple[str, int, int]] = None  # (state var, begin, rows)
    chan: Optional[torch.Tensor] = None  # MUL/DIV constant, [O] or [1]
    chan_op: str = "mul"
    chan_pos: int = 0
    absorbed: Tuple[int, ...] = ()  # the graph ops it absorbs

    def fusion(self, state=None, res=None) -> conv_stack.Fusion:
        """The wrapper's fused operands, given the state and residual
        tensors `[B, T, C]`."""
        return conv_stack.Fusion(
            state=state, split=self.split, leaky_in=self.leaky_in, res=res,
            res_op=self.res_op, res_leaky=self.res_leaky,
            leaky_out=self.leaky_out, crop=self.crop,
            side=self.side and self.side[1:], chan=self.chan,
            chan_op=self.chan_op, chan_pos=self.chan_pos)

    def __call__(self, x, state=None, res=None):
        """→ out, or (out, new state) for a launch with a side store."""
        return self.fn(x, self.w, self.bias, *self.extra,
                       **self.fusion(state, res)._asdict())

    def plain(self, x, state=None, res=None):
        """The plain version: the same ops as torch ops, on any device."""
        return conv_stack.fused_plain(conv_stack.PLAIN[self.kind], x, self.w,
                                      self.bias, self.extra,
                                      self.fusion(state, res))


class CoreLaunch(NamedTuple):
    """A core op that no conv launch absorbs, as one call of a core kernel
    (conv_stack.eltwise or conv_stack.gather) on `[B, T, C]` tensors."""
    op: int  # the op's index
    kind: str  # "eltwise" or "gather"
    kernel: cuda_build.KernelCounter
    # eltwise: its two operands; gather: its parts as GatherPart fields;
    # each tensor a core tensor's index or a constant
    args: tuple
    arg: object  # eltwise: "add", "sub", "mul" or "div"; gather: the axis
    out: int  # the tensor written
    out_shape: Tuple[int, int]
    absorbed: Tuple[int, ...] = ()  # STRIDED_SLICEs a gather reads through

    def operands(self, core: Dict[int, torch.Tensor]) -> tuple:
        """The operands, the core's tensors given by `core`."""
        def get(a):
            return a if isinstance(a, torch.Tensor) else core[a]

        if self.kind == "eltwise":
            return tuple(get(a) for a in self.args)
        return tuple(conv_stack.GatherPart(get(p[0]), *p[1:])
                     for p in self.args)

    def __call__(self, core):
        ops = self.operands(core)
        if self.kind == "eltwise":
            return conv_stack.eltwise(*ops, self.arg)
        return conv_stack.gather(ops, self.arg, _batch(ops))

    def plain(self, core):
        """The plain version: the graph's torch ops, on any device."""
        ops = self.operands(core)
        if self.kind == "eltwise":
            return conv_stack.eltwise_plain(*ops, self.arg)
        return conv_stack.gather_plain(ops, self.arg, _batch(ops))


class EdgeLaunch(NamedTuple):
    """The epilogue's output edge (its TRANSPOSE_CONV to one channel and
    the overlap-add tail after it) as one out_edge call on the core tensor
    it reads, `[B, T, C]`, and its state, `[B, L]`."""
    op: int  # the TRANSPOSE_CONV's index
    kernel: cuda_build.KernelCounter
    w: torch.Tensor  # [K, C]
    bias: torch.Tensor  # [1]
    stride: int
    rows: int  # the conv's output rows N
    x: int  # the core tensor it reads
    state: str  # the state var of L samples
    absorbed: Tuple[int, ...]  # every epilogue op

    def __call__(self, x, state):
        """→ (PCM [B, N − L] float32, new state [B, L])."""
        return out_edge.out_edge(x, self.w, self.bias, self.stride,
                                 self.rows, state)

    def conv(self, x):
        """The TRANSPOSE_CONV alone on the same kernel, [B, N, 1]."""
        return out_edge.out_edge(x, self.w, self.bias, self.stride,
                                 self.rows)

    def plain(self, x, state):
        """The plain version: the executor's ops, on any device."""
        return out_edge.out_edge_plain(x, self.w, self.bias, self.stride,
                                       self.rows, state)


def _batch(parts) -> int:
    return next(p.src.shape[0] for p in parts if p.src.dim() == 3)


def _plain_call(launch: FusedLaunch) -> Callable:
    """The launch's kernel without fused operands, on its conv's input."""
    return lambda x: launch.fn(x, launch.w, launch.bias, *launch.extra)


def refuse_kernel_backend(mode: str, state_dtype=None,
                          boundary_store=None) -> None:
    """The kernel backend runs float and bf16 with float state: the
    quantized modes, int8 state storage and fp8 boundaries are refused
    (the JAX fused backend's ValueError), naming the backend that runs
    them."""
    what = ([f"mode={mode!r}"] if mode in QUANT_MODES else []) + (
        [f"state_dtype={state_dtype!r}"] if state_dtype is not None else []
    ) + ([f"boundary_store={boundary_store!r}"]
         if boundary_store is not None else [])
    if what:
        raise ValueError(
            f"{', '.join(what)} runs on backend=\"plain\" only: the kernel "
            f"backend (the JAX backend='fused') runs float and bf16 with "
            f"uncompressed state")


class FusedStack:
    """Same contract as GraphFn for a 1-input/1-output streaming graph:
    `(state, x) → (y, new_state)` with x and y batch-native in graph shape."""

    def __init__(self, path: str, signature: str = "serving_default",
                 mode: str = "float", device=None,
                 segment: Optional[str] = None):
        """`segment` names the stack for the tracer: a call marks
        `<segment>.prologue`, `.core` and `.epilogue` (utils/trace.py),
        None marks nothing."""
        refuse_kernel_backend(mode)
        self._marks = (None if segment is None else tuple(
            f"{segment}.{part}" for part in ("prologue", "core", "epilogue")))
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
        self._build_plan()
        self.edge = self._match_edge()

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

    # -- the launch plan --------------------------------------------------------
    def _build_plan(self) -> None:
        """`plan`: the core as the kernel calls of one hop in graph order —
        a FusedLaunch per conv op, with the kernel-layout weights on the
        device in the graph's compute dtype, and a CoreLaunch per op that
        no conv launch absorbs; `roles`: every core op's one role, "conv",
        "absorbed", "view" or "kernel" (a CoreLaunch of its own)."""
        sg, consts = self.sg, self._consts
        dev, dtype = self.device, self.graph.dtype
        core = set(self._core)
        producer: Dict[int, int] = {}
        consumers: Dict[int, List[int]] = {}
        for i, op in enumerate(sg.ops):
            for o in op.outputs:
                producer[o] = i
            for t in op.inputs:
                consumers.setdefault(t, []).append(i)
        roles: Dict[int, str] = {}
        written: Set[int] = set()  # tensors a launch writes or the core reads in
        precrop: Dict[int, Tuple[int, int]] = {}  # tensor → rows it was cut to

        def shape(t):
            return _mapped_shape(sg.tensors[t].shape)

        def op_of(t, name=None):
            """The core op producing t (of type `name`), or None."""
            i = producer.get(t)
            if i is None or i not in core:
                return None
            return i if name is None or sg.ops[i].name == name else None

        def is_view(i):
            op = sg.ops[i]
            return op.name in _VIEWS and shape(op.inputs[0]) == shape(
                op.outputs[0])

        def unview(t):
            """t with the core's views (QUANTIZE, DEQUANTIZE, RESHAPE of the
            same [T, C]) looked through."""
            while (i := op_of(t)) is not None and sg.ops[i].name in _VIEWS:
                if not is_view(i):
                    raise NotImplementedError(
                        f"fused stack: {sg.ops[i].name} (op {i}) "
                        f"{shape(sg.ops[i].inputs[0])} → {shape(t)} is not a "
                        f"view of [T, C]")
                roles[i] = "view"
                t = sg.ops[i].inputs[0]
            return t

        def only_consumer(t):
            cons = consumers.get(t, [])
            if len(cons) != 1 or t == self.output_idx:
                return None
            return cons[0] if cons[0] in core else None

        def fwd(t):
            """(the one core op that reads t, the tensor it reads), with the
            views between looked through; None where there is no such op."""
            while (c := only_consumer(t)) is not None and is_view(c):
                roles[c] = "view"
                t = sg.ops[c].outputs[0]
            return None if c is None else (c, t)

        def uses(t):
            """(op, tensor it reads) of every op that reads t, through views."""
            out = []
            for c in consumers.get(t, []):
                if c in core and is_view(c):
                    roles[c] = "view"
                    out += uses(sg.ops[c].outputs[0])
                else:
                    out.append((c, t))
            return out

        def loadable(t):
            """(tensor, alpha) a launch reads for t: t itself once written
            (alpha None), or the written input of the LEAKY_RELU that
            produces t, which then runs on load; None where neither is
            written yet."""
            t = unview(t)
            if t in written:
                return t, None
            i = op_of(t, "LEAKY_RELU")
            if i is not None:
                src = unview(sg.ops[i].inputs[0])
                if src in written:
                    roles[i] = "absorbed"
                    return src, sg.ops[i].options["alpha"]
            return None

        def window(i):
            return _window(sg, consts, i)

        def time_range(i):
            """(begin, end) of a STRIDED_SLICE (op i) that cuts only the
            time axis, else None."""
            w = window(i)
            if w is None or w[0][1] != 1 or w[1] != (
                    0, 1, shape(sg.ops[i].inputs[0])[1]):
                return None
            return w[0][0], w[0][0] + w[0][2]

        def channel_range(i):
            """(first channel, channels) of a STRIDED_SLICE (op i) that
            keeps all rows and a run of channels, else None."""
            w = window(i)
            if w is None or w[0] != (0, 1, shape(sg.ops[i].inputs[0])[0]) \
                    or w[1][1] != 1:
                return None
            return w[1][0], w[1][2]

        def as_t(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32),
                                device=dev).to(dtype)

        def per_channel(t, c):
            """Constant t as one value per channel ([c]) or one value ([1]),
            else None."""
            v = np.asarray(consts[t], np.float32)
            if v.size == 1 or (v.size == c and v.shape[-1] == c):
                return as_t(v.reshape(-1))
            return None

        def chan_of(cop, t):
            """The constant of a MUL by a per-channel constant (either
            operand) or of a DIV by one (the divisor), given the tensor t
            it reads; None where cop is neither."""
            if cop.name not in ("MUL", "DIV") or len(cop.inputs) != 2:
                return None
            k = cop.inputs.index(t)
            other = cop.inputs[1 - k]
            if other not in consts or (cop.name == "DIV" and k != 0):
                return None
            return per_channel(other, shape(t)[1])

        conv1d_k, depthwise_k, tconv_k = conv_stack.BY_DTYPE[dtype]
        eltwise_k, gather_k = conv_stack.CORE_BY_DTYPE[dtype]
        read_state: Dict[int, str] = {
            op.outputs[0]: self._var_of_handle[op.inputs[0]]
            for i, op in enumerate(sg.ops)
            if i in core and op.name == "READ_VARIABLE"}

        def state_cat(j):
            """Whether CONCATENATION op j is a state ahead of an input along
            time (a conv launch absorbs it, with its state slice)."""
            cat = sg.ops[j]
            return (_batch_axis(cat.options["axis"], len(
                sg.tensors[cat.outputs[0]].shape)) == 1
                and len(cat.inputs) == 2
                and unview(cat.inputs[0]) in read_state)

        def operand(t, i):
            """Core tensor t as an operand of core kernel op i: the index of
            its written source."""
            u = unview(t)
            if u not in written:
                raise NotImplementedError(
                    f"fused stack: the input of {sg.ops[i].name} (op {i}) is "
                    f"not written before it")
            return u

        def own_slice(i) -> bool:
            """Whether STRIDED_SLICE op i needs a gather of its own: not a
            state slice, nor a slice a CONCATENATION's gather reads, nor a
            channel range that only dense and transpose convs read (as a
            channel offset)."""
            use = fwd(sg.ops[i].outputs[0])
            if use is not None and sg.ops[use[0]].name == "CONCATENATION" \
                    and not state_cat(use[0]):
                return False
            j = op_of(unview(sg.ops[i].inputs[0]), "CONCATENATION")
            if j is not None and state_cat(j):
                return False
            readers = uses(sg.ops[i].outputs[0])
            return not (channel_range(i) is not None and readers and all(
                sg.ops[c].name in ("CONV_2D", "TRANSPOSE_CONV")
                for c, _ in readers))

        def eltwise_launch(i) -> CoreLaunch:
            """ADD/SUB/MUL/DIV (op i) of two core tensors of its output's
            shape, or of one and a constant per channel or one constant."""
            op = sg.ops[i]
            out_shape = shape(op.outputs[0])
            args = []
            for t in op.inputs:
                if t in consts:
                    a = per_channel(t, out_shape[1])
                    if a is None:
                        raise NotImplementedError(
                            f"fused stack: {op.name} (op {i}) by a constant "
                            f"that is not one value per channel")
                else:
                    a = operand(t, i)
                    if shape(a) != out_shape:
                        raise NotImplementedError(
                            f"fused stack: {op.name} (op {i}) broadcasts a "
                            f"tensor")
                args.append(a)
            if all(isinstance(a, torch.Tensor) for a in args):
                raise NotImplementedError(
                    f"fused stack: {op.name} (op {i}) of two constants")
            return CoreLaunch(i, "eltwise", eltwise_k, tuple(args),
                              op.name.lower(), op.outputs[0], out_shape)

        def gather_launch(i) -> CoreLaunch:
            """A CONCATENATION (op i) along time or channels, each input a
            written tensor, a constant, or a STRIDED_SLICE that only it
            reads (absorbed); or a STRIDED_SLICE (op i) alone."""
            op = sg.ops[i]
            absorbed: List[int] = []
            if op.name == "STRIDED_SLICE":
                w = window(i)
                if w is None:
                    raise NotImplementedError(
                        f"fused stack: STRIDED_SLICE (op {i}) is not a window "
                        f"of [T, C] (slice masks, or the batch or width "
                        f"axis)")
                parts = [(operand(op.inputs[0], i), *w[0], *w[1])]
                axis = 1
            else:
                nd = len(sg.tensors[op.outputs[0]].shape)
                axis = {1: 1, nd - 1: 2}.get(
                    _batch_axis(op.options["axis"], nd))
                if axis is None or \
                        len(op.inputs) > conv_stack.GATHER_MAX_PARTS:
                    raise NotImplementedError(
                        f"fused stack: CONCATENATION (op {i}) of "
                        f"{len(op.inputs)} inputs along axis "
                        f"{op.options['axis']}")
                parts = []
                for t in op.inputs:
                    if t in consts:
                        t_p, c_p = shape(t)
                        parts.append((as_t(np.reshape(consts[t], (t_p, c_p))),
                                      0, 1, t_p, 0, 1, c_p))
                        continue
                    u = unview(t)
                    j = op_of(u, "STRIDED_SLICE")
                    if (j is not None and j not in roles
                            and (fwd(u) or (None,))[0] == i
                            and (w := window(j)) is not None):
                        roles[j] = "absorbed"
                        absorbed.append(j)
                        parts.append((operand(sg.ops[j].inputs[0], j),
                                      *w[0], *w[1]))
                    else:
                        t_p, c_p = shape(t)
                        parts.append((operand(t, i), 0, 1, t_p, 0, 1, c_p))
                if all(isinstance(p[0], torch.Tensor) for p in parts):
                    raise NotImplementedError(
                        f"fused stack: CONCATENATION (op {i}) of constants")
            return CoreLaunch(i, "gather", gather_k, tuple(parts), axis,
                              op.outputs[0], shape(op.outputs[0]),
                              tuple(absorbed))

        side_done: Set[int] = set()  # concatenations whose state is stored
        for i in self._core:  # tensors the core reads from outside
            for t in sg.ops[i].inputs:
                if t >= 0 and t not in consts and op_of(t) is None \
                        and producer.get(t) is not None \
                        and sg.ops[producer[t]].name != "VAR_HANDLE":
                    written.add(t)
                elif t >= 0 and t == self.input_idx:
                    written.add(t)
        self._core_inputs = sorted(written)
        plan: List = []
        for i in self._core:
            op = sg.ops[i]
            if op.name not in _CONVS:
                if i in roles:
                    continue
                launch = None
                if op.name in ("ADD", "SUB", "MUL", "DIV"):
                    launch = eltwise_launch(i)
                elif (op.name == "CONCATENATION" and not state_cat(i)) or (
                        op.name == "STRIDED_SLICE" and own_slice(i)):
                    launch = gather_launch(i)
                if launch is not None:
                    roles[i] = "kernel"
                    written.add(launch.out)
                    plan.append(launch)
                continue
            opts = op.options
            x_t = op.inputs[2 if op.name == "TRANSPOSE_CONV" else 0]
            x_shape = sg.tensors[x_t].shape
            if (opts["padding"] != "VALID" or opts["stride_w"] != 1
                    or opts.get("dilation_w", 1) != 1 or len(x_shape) != 4
                    or x_shape[2] != 1):
                raise NotImplementedError(
                    f"fused stack: {op.name} {opts} on {list(x_shape)} is not "
                    f"a temporal VALID conv")
            roles[i] = "conv"
            absorbed: List[int] = []
            in_shape = shape(x_t)
            f = {}
            # Input side: SPLIT or channel STRIDED_SLICE, CONCATENATION
            # with a state, LEAKY on load.
            t = unview(x_t)
            if (j := op_of(t, "SPLIT")) is not None:
                sp = sg.ops[j]
                src = sg.ops[j].inputs[1]
                axis = int(consts[sp.inputs[0]])
                if axis not in (3, -1):
                    raise NotImplementedError(
                        f"fused stack: SPLIT (op {j}) along axis {axis}")
                width = shape(src)[1] // sp.options["num_splits"]
                f["split"] = (sp.outputs.index(t) * width, width)
                roles[j] = "view"
                t = unview(src)
            elif (op.name != "DEPTHWISE_CONV_2D"
                  and (j := op_of(t, "STRIDED_SLICE")) is not None
                  and j not in roles
                  and (cr := channel_range(j)) is not None):
                f["split"] = cr
                roles[j] = "view"
                t = unview(sg.ops[j].inputs[0])
            if (j := op_of(t, "CONCATENATION")) is not None \
                    and roles.get(j) != "kernel":
                cat = sg.ops[j]
                parts = [unview(p) for p in cat.inputs]
                if not state_cat(j):
                    raise NotImplementedError(
                        f"fused stack: CONCATENATION (op {j}) is not a state "
                        f"ahead of an input along time")
                f["state"] = read_state[parts[0]]
                roles[producer[parts[0]]] = "view"
                if j not in side_done:
                    side_done.add(j)
                    roles[j] = "absorbed"
                    absorbed.append(j)
                    for c, _ in uses(t):
                        if sg.ops[c].name in _CONVS + ("SPLIT",) \
                                or roles.get(c) == "view":
                            continue
                        asg = fwd(sg.ops[c].outputs[0])
                        rows = (time_range(c)
                                if sg.ops[c].name == "STRIDED_SLICE" else None)
                        if (rows is None or asg is None
                                or sg.ops[asg[0]].name != "ASSIGN_VARIABLE"):
                            raise NotImplementedError(
                                f"fused stack: {sg.ops[c].name} (op {c}) of "
                                f"CONCATENATION (op {j}) is not a state slice")
                        asg = asg[0]
                        name = self._var_of_handle[sg.ops[asg].inputs[0]]
                        if "side" in f or _mapped_shape(
                                self._state_shapes[name])[0] != rows[1] - rows[0]:
                            raise NotImplementedError(
                                f"fused stack: state slice (op {c}) of "
                                f"CONCATENATION (op {j})")
                        f["side"] = (name, rows[0], rows[1] - rows[0])
                        roles[c] = roles[asg] = "absorbed"
                        absorbed += [c, asg]
                t = parts[1]
            src = loadable(t)
            if src is None:
                raise NotImplementedError(
                    f"fused stack: the input of {op.name} (op {i}) is not "
                    f"written before it")
            x, f["leaky_in"] = src
            if f["leaky_in"] is not None:
                absorbed.append(producer[unview(t)])
            # Output side: ADD/SUB, MUL/DIV by a per-channel constant, crop,
            # LEAKY, in graph order.
            y = op.outputs[0]
            while (use := fwd(y)) is not None:
                c, yv = use
                cop = sg.ops[c]
                if cop.name in ("ADD", "SUB") and "res" not in f \
                        and "leaky_out" not in f:
                    k = cop.inputs.index(yv)
                    src = loadable(cop.inputs[1 - k])
                    if src is None:
                        # A sibling conv's operand, not written yet: it
                        # absorbs this op; keep only the rows it keeps.
                        nxt = fwd(cop.outputs[0])
                        if (op.name == "TRANSPOSE_CONV" and nxt is not None
                                and sg.ops[nxt[0]].name == "STRIDED_SLICE"
                                and (rows := time_range(nxt[0])) is not None):
                            f["crop"] = rows
                            precrop[y] = rows
                        break
                    f["res"], f["res_leaky"] = src
                    if src[1] is not None:
                        absorbed.append(producer[unview(cop.inputs[1 - k])])
                    f["res_op"] = ("add" if cop.name == "ADD"
                                   else "sub" if k == 0 else "rsub")
                elif "chan" not in f and (ch := chan_of(cop, yv)) is not None:
                    f["chan"], f["chan_op"] = ch, cop.name.lower()
                    f["chan_pos"] = (2 if "leaky_out" in f
                                     else 1 if "res" in f else 0)
                elif (cop.name == "STRIDED_SLICE" and "crop" not in f
                      and op.name == "TRANSPOSE_CONV"
                      and (rows := time_range(c)) is not None):
                    f["crop"] = rows
                elif cop.name == "LEAKY_RELU" and "leaky_out" not in f:
                    f["leaky_out"] = cop.options["alpha"]
                else:
                    break
                roles[c] = "absorbed"
                absorbed.append(c)
                y = cop.outputs[0]
            if "res" in f and f["res"] in precrop \
                    and precrop[f["res"]] != f.get("crop"):
                raise NotImplementedError(
                    f"fused stack: {op.name} (op {i}) adds rows "
                    f"{precrop[f['res']]} of its sibling but keeps "
                    f"{f.get('crop')}")
            written.add(y)
            out_t, out_c = shape(op.outputs[0])
            if "crop" in f:
                out_t = f["crop"][1] - f["crop"][0]
            # Weights in kernel layout.
            w = np.asarray(consts[op.inputs[1]], np.float32)
            bias_pos = 3 if op.name == "TRANSPOSE_CONV" else 2
            bias = (as_t(consts[op.inputs[bias_pos]])
                    if len(op.inputs) > bias_pos and op.inputs[bias_pos] >= 0
                    else None)
            if op.name == "CONV_2D":  # [O, K, 1, I_f] -> [K, I_f, O]
                if opts.get("dilation_h", 1) != 1:
                    raise NotImplementedError("dilated dense conv not in Lyra graphs")
                kind, kernel, fn = "conv1d", conv1d_k, conv_stack.conv1d
                wk, extra = np.transpose(w[:, :, 0, :], (1, 2, 0)), (opts["stride_h"],)
            elif op.name == "DEPTHWISE_CONV_2D":  # [1, K, 1, C] -> [K, C]
                if opts["stride_h"] != 1:
                    raise NotImplementedError("strided depthwise not in Lyra graphs")
                kind, kernel, fn = "depthwise", depthwise_k, conv_stack.depthwise_conv1d
                wk, extra = w[0, :, 0, :], (opts.get("dilation_h", 1),)
            else:  # TRANSPOSE_CONV [O, K, 1, I] -> [K, I, O]
                kind, kernel, fn = "tconv", tconv_k, conv_stack.transpose_conv1d
                wk = np.transpose(w[:, :, 0, :], (1, 2, 0))
                extra = (opts["stride_h"], sg.tensors[op.outputs[0]].shape[1])
            plan.append(FusedLaunch(
                i, kind, kernel, fn, as_t(wk), bias, extra, in_shape, x,
                shape(x), y, (out_t, out_c), absorbed=tuple(absorbed),
                **{k: v for k, v in f.items() if v is not None}))
        # Core tensors the epilogue or the output reads, by their source.
        epi = {t for j in self._epilogue for t in sg.ops[j].inputs}
        self._core_outputs = {
            t: unview(t) for j in self._core for t in sg.ops[j].outputs
            if t in epi or t == self.output_idx}
        unwritten = set(self._core_outputs.values()) - written
        if unwritten:
            raise NotImplementedError(
                f"fused stack: core tensors {sorted(unwritten)} leave the core "
                f"but no launch writes them")
        missing = [j for j in self._core if j not in roles]
        if missing:
            j = missing[0]
            raise NotImplementedError(
                f"fused stack: {sg.ops[j].name} (op {j}) is not absorbed by "
                f"any conv launch of the core")
        self.roles = {j: roles[j] for j in self._core}
        self.plan = plan

    # -- the output edge ------------------------------------------------------
    def _match_edge(self) -> Optional[EdgeLaunch]:
        """The epilogue as one output-edge launch, where it is exactly
        LyraGAN's: a TRANSPOSE_CONV from a core tensor [T, C] to [N, 1] with
        a bias; the READ_VARIABLE of a state of L samples ADDed to its rows
        0 .. L; its rows N − L .. N ASSIGNed to the same state; and the
        CONCATENATION of that sum with its rows L .. N − L as the graph's
        output, with RESHAPE, QUANTIZE and DEQUANTIZE read as views; and
        within what the kernels take (out_edge.supported).  Else None: the
        executor runs the epilogue op by op."""
        sg, consts = self.sg, self._consts
        producer: Dict[int, int] = {}
        consumers: Dict[int, List[int]] = {}
        for i in self._epilogue:
            for o in sg.ops[i].outputs:
                producer[o] = i
            for t in sg.ops[i].inputs:
                consumers.setdefault(t, []).append(i)
        used: Set[int] = set()

        def numel(t):
            return int(np.prod(sg.tensors[t].shape))

        def is_view(i):
            op = sg.ops[i]
            return op.name in _VIEWS and numel(op.inputs[0]) == numel(
                op.outputs[0])

        def readers(t):
            """The epilogue's ops that read t, its views looked through."""
            out = []
            for c in consumers.get(t, []):
                if is_view(c):
                    used.add(c)
                    out += readers(sg.ops[c].outputs[0])
                else:
                    out.append(c)
            return out

        def source(t):
            """t with the views that produce it looked through."""
            while (i := producer.get(t)) is not None and is_view(i):
                used.add(i)
                t = sg.ops[i].inputs[0]
            return t

        def one(ops, name):
            return ops[0] if len(ops) == 1 and sg.ops[ops[0]].name == name \
                else None

        convs = [i for i in self._epilogue
                 if sg.ops[i].name == "TRANSPOSE_CONV"]
        if len(convs) != 1:
            return None
        i = convs[0]
        op = sg.ops[i]
        opts = op.options
        if (len(op.inputs) < 4 or op.inputs[3] not in consts
                or op.inputs[1] not in consts or op.inputs[0] not in consts
                or opts["padding"] != "VALID" or opts["stride_w"] != 1):
            return None
        x_t, y_t = op.inputs[2], op.outputs[0]
        w = np.asarray(consts[op.inputs[1]], np.float32)  # [1, K, 1, C]
        x_shape, y_shape = sg.tensors[x_t].shape, sg.tensors[y_t].shape
        if (w.ndim != 4 or w.shape[0] != 1 or w.shape[2] != 1
                or list(x_shape) != [1, x_shape[1], 1, w.shape[3]]
                or len(y_shape) != 4 or list(y_shape) != [1, y_shape[1], 1, 1]
                or [int(v) for v in consts[op.inputs[0]]][1:3] != [
                    y_shape[1], 1]
                or x_t not in self._core_outputs):
            return None
        k, c, n, stride = w.shape[1], w.shape[3], y_shape[1], opts["stride_h"]
        # The three slices of the conv's rows: head, middle and tail.
        slices = readers(y_t)
        if len(slices) != 3:
            return None
        ranges = {}
        for j in slices:
            win = (_window(sg, consts, j)
                   if sg.ops[j].name == "STRIDED_SLICE" else None)
            if win is None or win[0][1] != 1 or win[1] != (0, 1, 1):
                return None
            ranges[(win[0][0], win[0][0] + win[0][2])] = sg.ops[j].outputs[0]
            used.add(j)
        head = [r for r in ranges if r[0] == 0]
        if not head:
            return None
        rows = head[0][1]
        if (not out_edge.supported(x_shape[1], c, k, stride, n, rows)
                or set(ranges) != {(0, rows), (rows, n - rows),
                                   (n - rows, n)}):
            return None
        head, mid, tail = (ranges[r] for r in (
            (0, rows), (rows, n - rows), (n - rows, n)))
        # head + READ_VARIABLE, tail → ASSIGN_VARIABLE of the same state.
        add = one(readers(head), "ADD")
        asg = one(readers(tail), "ASSIGN_VARIABLE")
        if add is None or asg is None:
            return None
        srcs = [source(t) for t in sg.ops[add].inputs]
        if len(srcs) != 2 or head not in srcs or srcs[0] == srcs[1]:
            return None
        read = producer.get(srcs[1 - srcs.index(head)])
        if (read is None or sg.ops[read].name != "READ_VARIABLE"
                or readers(sg.ops[read].outputs[0]) != [add]
                or source(sg.ops[asg].inputs[1]) != tail or read > asg):
            return None
        var = self._var_of_handle[sg.ops[read].inputs[0]]
        if (self._var_of_handle.get(sg.ops[asg].inputs[0]) != var
                or _mapped_shape(self._state_shapes[var]) != (rows, 1)
                or sum(o.name in ("READ_VARIABLE", "ASSIGN_VARIABLE")
                       and self._var_of_handle.get(o.inputs[0]) == var
                       for o in sg.ops) != 2):
            return None
        # CONCATENATION(head + state, middle) along time → the output.
        add_out = sg.ops[add].outputs[0]
        cat = one(readers(add_out), "CONCATENATION")
        if (cat is None or readers(mid) != [cat]
                or [source(t) for t in sg.ops[cat].inputs] != [add_out, mid]
                or _batch_axis(sg.ops[cat].options["axis"], len(
                    sg.tensors[sg.ops[cat].outputs[0]].shape)) != 1
                or readers(sg.ops[cat].outputs[0])
                or source(self.output_idx) != sg.ops[cat].outputs[0]):
            return None
        used |= {i, read, add, asg, cat}
        if used != set(self._epilogue):
            return None
        dev, dtype = self.device, self.graph.dtype

        def as_t(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32),
                                device=dev).to(dtype)

        return EdgeLaunch(
            i, out_edge.BY_DTYPE[dtype], as_t(w[0, :, 0, :]),
            as_t(np.reshape(consts[op.inputs[3]], (1,))), stride, n, x_t,
            var, tuple(self._epilogue))

    # -- public API -----------------------------------------------------------
    def init_state(self, batch_size: int) -> State:
        return self.graph.init_state(batch_size)

    def _edges(self):
        # The audio edges that no kernel takes run through cuDNN:
        # SoundStream's input edge, and an output edge that `_match_edge`
        # does not take.  A transposed conv is cuDNN's backward-data pass,
        # whose fastest algorithms sum with atomics: the same inputs then
        # give other bits from run to run (seen at B=1024 on an H100), and
        # a CUDA-graph replay other bits than an eager launch.  Only cuDNN's
        # deterministic algorithms here, then, and no TF32: PyTorch allows
        # TF32 in cuDNN by default, so a process that does not turn it off
        # (a spawned serving host) would otherwise run the float edges at
        # TF32 precision and give other bits than one that does.  The
        # plain executor keeps cuDNN's choice in float and bf16, where it
        # is the reference; in the configurations it alone serves (int8,
        # fakequant, fp8 boundaries, int8 state storage) it pins its convs
        # the same way (executor.GraphFn._pinned).
        return torch.backends.cudnn.flags(
            enabled=True, deterministic=True, allow_tf32=False)

    def __call__(self, state: State, x: torch.Tensor):
        """x: [B, *graph_input_shape[1:]] → ([B, *graph_output_shape[1:]],
        new_state)."""
        marks = self._marks
        if marks:
            trace.mark(marks[0], x)
        env: Dict[int, torch.Tensor] = {self.input_idx: x.to(self.graph.dtype)}
        new_state = dict(state)
        with self._edges():
            self.graph.run_ops(self._prologue, env, new_state)
        b = x.shape[0]
        # The core's operands as [B, T, C], before its first launch.
        core = {t: env[t].reshape((b,) + _mapped_shape(
            self.sg.tensors[t].shape)).contiguous() for t in self._core_inputs}
        states = {name: state[name].reshape(
            (b,) + _mapped_shape(self._state_shapes[name])).contiguous()
            for name in self._core_state_names}
        if marks:
            trace.mark(marks[1], x)
        with torch.profiler.record_function("fused_stack.core"):
            for launch in self.plan:
                if isinstance(launch, CoreLaunch):
                    core[launch.out] = launch(core)
                    continue
                y = launch(core[launch.x],
                           launch.state and states[launch.state],
                           core.get(launch.res))
                if launch.side is not None:
                    y, side = y
                    name = launch.side[0]
                    new_state[name] = side.view(
                        (b,) + tuple(self._state_shapes[name]))
                core[launch.out] = y
        if marks:
            trace.mark(marks[2], x)
        edge = self.edge
        if edge is not None:
            shape = self._state_shapes[edge.state]
            pcm, side = edge(core[self._core_outputs[edge.x]],
                             state[edge.state].reshape(b, -1).contiguous())
            new_state[edge.state] = side.view((b,) + tuple(shape))
            return pcm.view((b,) + tuple(
                self.sg.tensors[self.output_idx].shape[1:])), new_state
        for t, src in self._core_outputs.items():
            env[t] = core[src].view((b,) + tuple(self.sg.tensors[t].shape[1:]))
        with self._edges():
            self.graph.run_ops(self._epilogue, env, new_state)
        return env[self.output_idx].float(), new_state

    def unfused(self, state: State, x: torch.Tensor):
        """The same hop op by op: the core's convs on the conv-stack kernels
        without fused operands, the output edge's TRANSPOSE_CONV on its
        kernel without its tail, every other op a torch op."""
        env: Dict[int, torch.Tensor] = {self.input_idx: x.to(self.graph.dtype)}
        new_state = dict(state)
        convs = {launch.op: _plain_call(launch) for launch in self.plan
                 if isinstance(launch, FusedLaunch)}
        if self.edge is not None:
            convs[self.edge.op] = self.edge.conv
        with self._edges():
            self.graph.run_ops(self._prologue + self._core + self._epilogue,
                               env, new_state, convs=convs)
        return env[self.output_idx].float(), new_state
