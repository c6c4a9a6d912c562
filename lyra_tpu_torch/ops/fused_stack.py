"""Partitioned conv-stack executor: torch audio edges around a kernel core.

Port of `lyra_tpu/ops/fused_stack.py::FusedStackKernel`.  The graph
analysis is the same pure-numpy dataflow partition (`_find_state_shapes`,
`_partition`, `_validate_core`, `_mapped_shape`): any op touching a
channel-1 activation is an audio *edge* op (SoundStream's first strided
conv with its 48-sample input context; LyraGAN's final transpose conv with
its overlap-add tail); edge ops ahead of the multi-channel core form the
prologue, the rest the epilogue.  The edges run through the executor's op
interpreter (tflite/executor.py, cuDNN on the card).

The core runs as a launch plan (`_plan`, built once from the graph in pure
Python): one conv-stack kernel call (ops/conv_stack.py) per conv op, each
with the ops it absorbs (`conv_stack.Fusion`), matched on dataflow:

  * input side: the CONCATENATION of a READ_VARIABLE with the conv's
    input (two pointers), a SPLIT (a channel offset), and a LEAKY_RELU on
    load where its input is not a core conv's output or has other
    consumers (then every consumer applies it);
  * output side: the residual ADD/SUB of a tensor already written (or its
    LEAKY_RELU on load), a STRIDED_SLICE crop of a transpose conv, and a
    LEAKY_RELU, in that graph order; a transpose conv whose sibling
    absorbs their ADD/SUB writes only the rows the crop after it keeps;
  * side store: STRIDED_SLICE → ASSIGN_VARIABLE of that concatenation, by
    the first launch that reads it;
  * RESHAPE (same [T, C]) and READ_VARIABLE are views.
Anything else in the core raises NotImplementedError naming the op.  On
the card no torch kernel runs between the core's first launch and its
last (the profiler span "fused_stack.core"); on CPU tensors each launch
runs its plain version, the graph's torch ops in the graph's order.
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

from lyra_tpu_torch.ops import conv_stack, cuda_build
from lyra_tpu_torch.tflite import executor
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


def _batch_axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


def _is_c1(shape: Sequence[int]) -> bool:
    """Channel-1 / channel-less tensors stay on the edge side."""
    m = _mapped_shape(shape)
    return len(m) < 2 or m[-1] == 1


_CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")


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
    absorbed: Tuple[int, ...] = ()  # the graph ops it absorbs

    def fusion(self, state=None, res=None) -> conv_stack.Fusion:
        """The wrapper's fused operands, given the state and residual
        tensors `[B, T, C]`."""
        return conv_stack.Fusion(
            state=state, split=self.split, leaky_in=self.leaky_in, res=res,
            res_op=self.res_op, res_leaky=self.res_leaky,
            leaky_out=self.leaky_out, crop=self.crop,
            side=self.side and self.side[1:])

    def __call__(self, x, state=None, res=None):
        """→ out, or (out, new state) for a launch with a side store."""
        return self.fn(x, self.w, self.bias, *self.extra,
                       **self.fusion(state, res)._asdict())

    def plain(self, x, state=None, res=None):
        """The plain version: the same ops as torch ops, on any device."""
        return conv_stack.fused_plain(conv_stack.PLAIN[self.kind], x, self.w,
                                      self.bias, self.extra,
                                      self.fusion(state, res))


def _plain_call(launch: FusedLaunch) -> Callable:
    """The launch's kernel without fused operands, on its conv's input."""
    return lambda x: launch.fn(x, launch.w, launch.bias, *launch.extra)


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
        self._build_plan()

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
        """`plan`: the core as fused launches, the conv-stack kernel calls
        of one hop in graph order, with the kernel-layout weights on the
        device in the graph's compute dtype; `roles`: every core op's one
        role, "conv", "absorbed" or "view"."""
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

        def unview(t):
            """t with the core's RESHAPEs of the same [T, C] looked through."""
            while (i := op_of(t, "RESHAPE")) is not None:
                src = sg.ops[i].inputs[0]
                if shape(src) != shape(t):
                    raise NotImplementedError(
                        f"fused stack: RESHAPE (op {i}) {shape(src)} → "
                        f"{shape(t)} is not a view of [T, C]")
                roles[i] = "view"
                t = src
            return t

        def only_consumer(t):
            cons = consumers.get(t, [])
            if len(cons) != 1 or t == self.output_idx:
                return None
            return cons[0] if cons[0] in core else None

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

        def time_range(i):
            """(begin, end) of a STRIDED_SLICE (op i) that cuts only the
            time axis, else None."""
            op = sg.ops[i]
            full = sg.tensors[op.inputs[0]].shape
            if len(full) != 4 or op.inputs[0] in consts:
                return None
            idx = torch.arange(int(np.prod(full))).reshape(full)
            got = executor.strided_slice(
                idx, consts[op.inputs[1]], consts[op.inputs[2]],
                consts[op.inputs[3]], op.options, full)
            lo = int(got.flatten()[0]) // int(np.prod(full[2:])) \
                if got.numel() else 0
            hi = lo + got.shape[1] if got.ndim == 4 else lo
            if got.ndim != 4 or not torch.equal(got, idx[:, lo:hi]):
                return None
            return lo, hi

        def as_t(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32),
                                device=dev).to(dtype)

        conv1d_k, depthwise_k, tconv_k = conv_stack.BY_DTYPE[dtype]
        read_state: Dict[int, str] = {
            op.outputs[0]: self._var_of_handle[op.inputs[0]]
            for i, op in enumerate(sg.ops)
            if i in core and op.name == "READ_VARIABLE"}
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
        plan: List[FusedLaunch] = []
        for i in self._core:
            op = sg.ops[i]
            if op.name not in _CONVS:
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
            # Input side: SPLIT, CONCATENATION with a state, LEAKY on load.
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
            if (j := op_of(t, "CONCATENATION")) is not None:
                cat = sg.ops[j]
                parts = [unview(p) for p in cat.inputs]
                if (_batch_axis(cat.options["axis"], 4) != 1
                        or len(parts) != 2 or parts[0] not in read_state):
                    raise NotImplementedError(
                        f"fused stack: CONCATENATION (op {j}) is not a state "
                        f"ahead of an input along time")
                f["state"] = read_state[parts[0]]
                roles[producer[parts[0]]] = "view"
                if j not in side_done:
                    side_done.add(j)
                    roles[j] = "absorbed"
                    absorbed.append(j)
                    for c in consumers[t]:
                        if sg.ops[c].name in _CONVS + ("SPLIT",):
                            continue
                        asg = only_consumer(sg.ops[c].outputs[0])
                        rows = (time_range(c)
                                if sg.ops[c].name == "STRIDED_SLICE" else None)
                        if (rows is None or asg is None
                                or sg.ops[asg].name != "ASSIGN_VARIABLE"):
                            raise NotImplementedError(
                                f"fused stack: {sg.ops[c].name} (op {c}) of "
                                f"CONCATENATION (op {j}) is not a state slice")
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
            # Output side: ADD/SUB, crop, LEAKY, in graph order.
            y = op.outputs[0]
            while (c := only_consumer(y)) is not None:
                cop = sg.ops[c]
                if cop.name in ("ADD", "SUB") and "res" not in f \
                        and "leaky_out" not in f:
                    k = cop.inputs.index(y)
                    src = loadable(cop.inputs[1 - k])
                    if src is None:
                        # A sibling conv's operand, not written yet: it
                        # absorbs this op; keep only the rows it keeps.
                        nxt = only_consumer(cop.outputs[0])
                        if (op.name == "TRANSPOSE_CONV" and nxt is not None
                                and sg.ops[nxt].name == "STRIDED_SLICE"
                                and (rows := time_range(nxt)) is not None):
                            f["crop"] = rows
                            precrop[y] = rows
                        break
                    f["res"], f["res_leaky"] = src
                    if src[1] is not None:
                        absorbed.append(producer[unview(cop.inputs[1 - k])])
                    f["res_op"] = ("add" if cop.name == "ADD"
                                   else "sub" if k == 0 else "rsub")
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

    # -- public API -----------------------------------------------------------
    def init_state(self, batch_size: int) -> State:
        return self.graph.init_state(batch_size)

    def _edges(self):
        # The audio edges run through cuDNN.  LyraGAN's output edge is a
        # transposed conv, i.e. cuDNN's backward-data pass, whose fastest
        # algorithms sum with atomics: the same inputs then give other bits
        # from run to run (seen at B=1024 on an H100), and a CUDA-graph
        # replay other bits than an eager launch.  Only cuDNN's
        # deterministic algorithms here, then; TF32 stays as the caller set
        # it, and the plain executor (the reference) keeps cuDNN's choice.
        return torch.backends.cudnn.flags(
            enabled=True, deterministic=True,
            allow_tf32=torch.backends.cudnn.allow_tf32)

    def __call__(self, state: State, x: torch.Tensor):
        """x: [B, *graph_input_shape[1:]] → ([B, *graph_output_shape[1:]],
        new_state)."""
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
        with torch.profiler.record_function("fused_stack.core"):
            for launch in self.plan:
                y = launch(core[launch.x],
                           launch.state and states[launch.state],
                           core.get(launch.res))
                if launch.side is not None:
                    y, side = y
                    name = launch.side[0]
                    new_state[name] = side.view(
                        (b,) + tuple(self._state_shapes[name]))
                core[launch.out] = y
        for t, src in self._core_outputs.items():
            env[t] = core[src].view((b,) + tuple(self.sg.tensors[t].shape[1:]))
        with self._edges():
            self.graph.run_ops(self._epilogue, env, new_state)
        return env[self.output_idx].float(), new_state

    def unfused(self, state: State, x: torch.Tensor):
        """The same hop op by op: the core's convs on the conv-stack kernels
        without fused operands, every other op a torch op."""
        env: Dict[int, torch.Tensor] = {self.input_idx: x.to(self.graph.dtype)}
        new_state = dict(state)
        convs = {launch.op: _plain_call(launch) for launch in self.plan}
        with self._edges():
            self.graph.run_ops(self._prologue + self._core + self._epilogue,
                               env, new_state, convs=convs)
        return env[self.output_idx].float(), new_state
