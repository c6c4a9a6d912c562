"""CUDA-graph capture of pure step functions: the port's counterpart of
`jax.jit` as the JAX engines and servers use it.

The JAX engines compile each step into one program (`jax.jit(_step_impl)`,
a jitted `reset_rows`, the servers' fused unpack+step and step+pack
programs).  Run eagerly, the port's step is ~500 small launches from
Python per tick.  `GraphCache.run(fn, key, state, *inputs)` runs a pure
`fn(state, *inputs) -> (*outputs, new_state)` as one CUDA-graph replay
instead:

  * `key` names `fn` and its static arguments (a wire width, a bitrate);
    the cache adds the inputs' shapes and dtypes and the state tree's
    leaf shapes and dtypes.  The first call of a full key allocates static
    input and output buffers, warms `fn` once on a side stream (lazy
    initialisation: cuBLAS and cuDNN handles, a kernel library's first
    launch) and captures it with `torch.cuda.graph`.  Every graph of one
    cache shares one memory pool (`torch.cuda.graph_pool_handle()`), which
    holds only the graphs' intermediates: inputs, outputs and state trees
    are allocated outside it.
  * Each call copies its inputs (device tensors, pinned or pageable host
    tensors, numpy arrays) into the static inputs and replays once.  The
    outputs returned are the static output buffers: the next replay of
    the same key overwrites them, so a caller copies out what it keeps
    (stream order suffices: a copy enqueued before the next replay reads
    this replay's values).
  * With the tracer on (utils/trace.py), the full key also holds
    `trace.enabled()`: graphs captured while tracing is off hold no
    device marker, and turning tracing on captures graphs of their own
    and never touches those.  Each call is a `graph.replay` span, a
    capture a `graph.capture` span inside it (counted as
    `graph.captures`), and a captured graph marks `graph.state_copy`
    before its output and state copies and `graph.end` after them.  What
    `fn` counts while it is captured is kept with the graph and counted
    again at each replay; what the warm-up counts is dropped.
  * State lives in two static trees per state signature (ping-pong): the
    graph captured from tree A writes tree B, and the one from tree B
    writes tree A.  If `state` is not one of the two trees (leaf for
    leaf), its leaves are first copied into tree A; `state` itself is
    never written.  The tree returned stays valid until two more replays
    have run over trees of its signature, the analog of JAX's
    `donate_argnums` — as long as each replay is fed the tree the one
    before it returned.  A replay fed any other tree overwrites the last
    tree returned.
  * So a cache's trees belong to one holder of a state lineage.  An
    engine's own cache serves its `step` and `reset_rows`; each server
    holds a cache of its own (`GraphCache(device, pool=engine's pool)`),
    so two servers on one engine never write each other's trees.  Graphs
    of caches that share a pool may run in any order: every graph keeps
    its outputs and state outside the pool, which holds only
    intermediates, and replays run in stream order.

There is no fallback: a failed capture or replay raises.  Whether a
function runs through the cache or eagerly is the engine's choice by its
device (`GraphCache` needs a CUDA device), never the result of an error.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lyra_tpu_torch.utils import trace

Tree = Dict[str, Any]


def leaves(tree: Tree, prefix: Tuple[str, ...] = ()
           ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """[(path, leaf)] of a nested dict of tensors, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _signature(tree: Tree) -> tuple:
    return tuple((p, tuple(t.shape), t.dtype) for p, t in leaves(tree))


def _alloc_like(tree: Tree) -> Tree:
    return {k: _alloc_like(v) if isinstance(v, dict) else torch.empty_like(
        v, memory_format=torch.contiguous_format) for k, v in tree.items()}


def _at(tree: Tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _copy_tree(dst: Tree, src: Tree) -> None:
    """Copies every leaf of `src` into the leaf of `dst` at its path."""
    for path, d in leaves(dst):
        d.copy_(_at(src, path), non_blocking=True)


def as_input(x) -> torch.Tensor:
    """A step input as a tensor: numpy arrays are wrapped without a copy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def replay(graphs: "GraphCache | None", device, fn: Callable, key,
           state: Tree, *inputs) -> tuple:
    """`fn(state, *inputs) -> (*outputs, new_state)` as one replay of its
    graph for `key` in `graphs`, or eagerly on `device` where `graphs` is
    None (the CPU).  Inputs may be numpy arrays or tensors on any
    device."""
    if graphs is not None:
        return graphs.run(fn, key, state, *inputs)
    with trace.span("graph.replay"):
        return fn(state, *(as_input(x).to(device) for x in inputs))


class _Graphs:
    """One full key: static inputs and outputs, a graph per input tree."""

    def __init__(self, inputs: Sequence[torch.Tensor], device):
        self.ins = [torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
                    for x in inputs]
        self.outs: Optional[List[torch.Tensor]] = None
        self.graphs: List[Optional[torch.cuda.CUDAGraph]] = [None, None]
        self.counts: List[Dict[str, int]] = [{}, {}]  # trace.count a replay


class GraphCache:
    """CUDA graphs of pure functions over one engine's state trees."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._trees: Dict[tuple, List[Tree]] = {}  # signature → [A, B]
        self._graphs: Dict[tuple, _Graphs] = {}

    # -- state trees ------------------------------------------------------------
    def _pair(self, state: Tree) -> Tuple[List[Tree], int]:
        """The two static trees of `state`'s signature and the index of the
        one holding `state`: `state` itself if it is one of them, else
        tree A after `state` is copied into it."""
        sig = _signature(state)
        pair = self._trees.get(sig)
        if pair is None:
            pair = self._trees[sig] = [_alloc_like(state), _alloc_like(state)]
        mine = [t for _, t in leaves(state)]
        for i, tree in enumerate(pair):
            if all(a is b for a, (_, b) in zip(mine, leaves(tree))):
                return pair, i
        _copy_tree(pair[0], state)
        return pair, 0

    # -- capture and replay -----------------------------------------------------
    def _entry(self, key, sig, inputs) -> _Graphs:
        full = (key, sig, tuple((tuple(x.shape), x.dtype) for x in inputs),
                trace.enabled())
        ent = self._graphs.get(full)
        if ent is None:
            ent = self._graphs[full] = _Graphs(inputs, self.device)
        return ent

    def run(self, fn: Callable, key, state: Tree, *inputs) -> tuple:
        """`fn(state, *inputs)` as one replay: (*outputs, new_state)."""
        # The cache's card is the current device throughout: a capture
        # records on the current device's streams, and the kernels launch
        # there (a process may hold caches of several cards).
        with trace.span("graph.replay"), torch.cuda.device(self.device):
            inputs = [as_input(x) for x in inputs]
            pair, i = self._pair(state)
            ent = self._entry(key, _signature(state), inputs)
            for dst, x in zip(ent.ins, inputs):
                dst.copy_(x, non_blocking=True)
            if ent.graphs[i] is None:
                with trace.span("graph.capture"):
                    trace.count("graph.captures")
                    ent.graphs[i], ent.counts[i] = self._capture(
                        fn, ent, pair[i], pair[1 - i])
            ent.graphs[i].replay()
            if ent.counts[i]:
                trace.add(ent.counts[i])
        return (*ent.outs, pair[1 - i])

    def _capture(self, fn, ent: _Graphs, src: Tree, dst: Tree):
        if ent.outs is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), trace.apart():
                warm = fn(src, *ent.ins)
            torch.cuda.current_stream(self.device).wait_stream(side)
            ent.outs = [torch.empty_like(t) for t in warm[:-1]]
            del warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool), trace.apart() as counts:
            res = fn(src, *ent.ins)
            trace.mark("graph.state_copy", self.device)
            for out, t in zip(ent.outs, res[:-1]):
                out.copy_(t)
            _copy_tree(dst, res[-1])
            trace.mark("graph.end", self.device)
        return graph, counts
