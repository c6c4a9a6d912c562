"""Lyra v2's work class (the Lyra configurations' `work`): operations and
bytes of the tick's work, counted from the TFLite graphs (parsed by the
reference's own reader), against the chip's peaks (portbench/peaks.py).

The harness builds a configuration's work class as Work(config, streams,
bits) (bits: one count for every row, or each row's own) and hands it to
the per-layer metrics; `tick_mfu_pct`, which every cell reads, takes
only its `peak` (the configuration dtype's peak FLOP/s) and
`tick_flop()` (the model's operations of one tick).

The rules are chip_smoke.py's `_work` (d33c86f), applied to graph ops
instead of the port's launches, so that a roofline reads the same work
whatever implements it: each input row that some tap reads is read once,
the weights and bias once, each output row the graph keeps written once,
in the compute dtype (the bf16 configuration holds weights and
activations in bf16).  A conv's operations are 2 × its multiply-adds over
the output rows kept: a transpose conv whose output only a STRIDED_SLICE
on the time axis reads counts the taps that land on the rows it keeps.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Tuple

import numpy as np

from portbench.peaks import PEAK_FLOPS, bound_s
from portbench.reference import tflite_model as tfl
from portbench.reference.codec import stages_of

MODELS = ("soundstream_encoder", "lyragan")
CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV")
CODES = 16  # codewords per RVQ stage
FEATURES = 64


def _graph(path: str) -> tfl.SubGraphDef:
    mdef = tfl.load(path)
    return mdef.subgraphs[mdef.signatures["serving_default"]["subgraph"]]


def _kept_rows(sg: tfl.SubGraphDef, op, t_full: int) -> range:
    """The output rows of `op` that its consumers read: a crop where every
    consumer is a STRIDED_SLICE on the time axis (axis 1), else all."""
    out = op.outputs[0]
    users = [o for o in sg.ops if out in o.inputs]
    lo, hi = t_full, 0
    for u in users:
        if u.name != "STRIDED_SLICE" or u.inputs[0] != out:
            return range(t_full)
        begin = sg.tensors[u.inputs[1]].data
        end = sg.tensors[u.inputs[2]].data
        strides = sg.tensors[u.inputs[3]].data
        bm, em = u.options.get("begin_mask", 0), u.options.get("end_mask", 0)
        if int(strides[1]) != 1:
            return range(t_full)
        b = 0 if bm & 2 else int(begin[1])
        e = t_full if em & 2 else int(end[1])
        lo, hi = min(lo, b), max(hi, e)
    return range(lo, hi) if users else range(t_full)


def conv_work(sg: tfl.SubGraphDef, op, batch: int,
              elem: int) -> Tuple[float, float]:
    """(operations, bytes) of one conv-family op over `batch` streams."""
    opts, t = op.options, sg.tensors
    if op.name == "TRANSPOSE_CONV":
        w, x = t[op.inputs[1]], t[op.inputs[2]]
        bias = t[op.inputs[3]] if len(op.inputs) > 3 else None
        o_ch, k, _, i_ch = w.shape
        s = opts["stride_h"]
        t_in = x.shape[1]
        keep = _kept_rows(sg, op, (t_in - 1) * s + k)
        taps = [(r - kk) // s for r in keep
                for kk in range(r % s, min(k, r + 1), s) if (r - kk) // s < t_in]
        macs = len(taps) * i_ch * o_ch
        rows_in, rows_out, c_in = len(set(taps)), len(keep), i_ch
    else:
        x, w = t[op.inputs[0]], t[op.inputs[1]]
        bias = t[op.inputs[2]] if len(op.inputs) > 2 else None
        t_in, c_in = x.shape[1], x.shape[3]
        s, d = opts["stride_h"], opts.get("dilation_h", 1)
        k = w.shape[1]
        rows_out = (t_in - (k - 1) * d - 1) // s + 1
        rows_in = len({r * s + kk * d for r in range(rows_out)
                       for kk in range(k)})
        if op.name == "DEPTHWISE_CONV_2D":
            o_ch = w.shape[3]
            macs = rows_out * o_ch * k
        else:
            o_ch = w.shape[0]
            macs = rows_out * o_ch * k * w.shape[2] * w.shape[3]
    nbytes = elem * (batch * (rows_in * c_in + rows_out * o_ch)
                     + int(np.prod(w.shape))
                     + (int(np.prod(bias.shape)) if bias is not None else 0))
    return 2.0 * batch * macs, float(nbytes)


def op_work(sg: tfl.SubGraphDef, op, batch: int,
            elem: int) -> Tuple[float, float]:
    """(operations, bytes) of a graph op that does work of its own in the
    conv-stack core: a conv, or an elementwise / gather op the core runs
    as a kernel of its own (its inputs read once, its output written
    once; operations not counted)."""
    if op.name in CONVS:
        return conv_work(sg, op, batch, elem)
    tensors = [sg.tensors[i] for i in (*op.inputs, *op.outputs) if i >= 0]
    nbytes = sum(elem * int(np.prod(tt.shape)) * (
        1 if tt.data is not None else batch) for tt in tensors)
    return 0.0, float(nbytes)


class Work:
    """The cell's work per tick at its batch and dtype."""

    def __init__(self, config: dict, streams: int, bits):
        """`streams` admitted rows, each sending packets of `bits` quantized
        bits: one count for every row, or each row's own ([streams])."""
        self.dtype = "bfloat16" if config["mode"] == "bf16" else "float32"
        self.elem = 2 if self.dtype == "bfloat16" else 4
        self.peak = PEAK_FLOPS[self.dtype]
        self.streams = streams
        self.stages = np.broadcast_to(stages_of(np.asarray(bits, np.int64)),
                                      (streams,))
        self.graphs = {m: _graph(os.path.join(config["model_dir"],
                                              m + ".tflite")) for m in MODELS}

    def core_bound_s(self, core_ops: Dict[str, Iterable[int]]) -> float:
        """Σ over the given ops of each graph of max(operations / peak,
        bytes / bandwidth), in the configuration's dtype."""
        total = 0.0
        for model, ops in core_ops.items():
            sg = self.graphs[model]
            for i in ops:
                total += bound_s(
                    *op_work(sg, sg.ops[i], self.streams, self.elem),
                    self.peak)
        return total

    def rvq(self) -> Tuple[float, float]:
        """(operations, bytes) of one RVQ search over the stages each row's
        packets carry: per stage 16 dot products of 64 and the residual
        update; features, the codebooks of the most stages and their ‖c‖²
        read once, codes written once, float32."""
        b, total = self.streams, int(self.stages.sum())
        flop = total * (CODES * 2 * FEATURES + FEATURES)
        nbytes = 4 * (b * FEATURES + int(self.stages.max()) * CODES
                      * (FEATURES + 1) + total)
        return float(flop), float(nbytes)

    def tick_flop(self) -> float:
        """Model operations of one tick: 2 × the multiply-adds of every
        conv-family op of both graphs, plus the RVQ search."""
        total = self.rvq()[0]
        for sg in self.graphs.values():
            for op in sg.ops:
                if op.name in CONVS:
                    total += conv_work(sg, op, self.streams, self.elem)[0]
        return total
