"""Multi-device serving: shard the stream batch over a device mesh — the
port of lyra_tpu/parallel/sharding.py.

The lockstep engines treat streams as a leading `[B]` axis with no
cross-stream arithmetic, so the batch splits over devices with no
communication at all: a mesh of N devices holds the rows of shard k,
k·B/N … (k+1)·B/N − 1, on its k-th device, and every program runs on each
shard over its own rows.  The JAX package gets this from GSPMD (one
program over global arrays); the port runs one replica of the engine per
shard:

  * A `Mesh` is an ordered tuple of devices plus the axis name.  CPU
    callers pass `["cpu"] * n`; a mesh may name one card more than once,
    which runs N shards on it (the test arrangement that checks the
    sharded path on a machine with one card).
  * A `[B, …]` tensor or state tree on the mesh is a `Sharded`: its parts
    in shard order, part k on `mesh.devices[k]`.  `shard_batch_tree`
    splits a tree into contiguous row blocks and `unshard_batch_tree`
    concatenates them back in shard order, so a sharded state's host image
    is the unsharded one, row for row.
  * `ShardedEngine(engine, mesh)` holds one engine replica per shard
    (weights built once per distinct device; shards on one device share
    them) and drops into every seam a plain engine fits: `init_state`,
    `reset_rows`, `step`, and the servers' `_run` / `_reset` /
    `own_graphs` / `device`.  Each shard runs its programs from a graph
    cache of its own on its device (utils/capture.py), so each shard's
    step is one replay there; the shards are launched one after the other
    with no host wait between them.

The fresh state of an admission is built at the global batch and split,
never per shard: the comfort-noise counters are seeded from the row index
(codec/comfort_noise.py), so shard k's rows keep the lineage they have on
one engine.  A row's result depends on the mesh only where an op picks
its algorithm by the row count: the decoder-side noise estimator's and
the comfort-noise generator's DFT matmuls are BLAS GEMMs (MKL on the CPU,
cuBLAS on the card) that sum in another order at another batch, so a hop
with comfort noise in it may differ by an int16 LSB.  Everything else —
the conv-stack and RVQ kernels, the cuDNN edges, the resampler, every
elementwise op — gives the unsharded step's bits (tests/
test_torch_sharding.py, chip_smoke.py phase 14).

`donate` is accepted and changes nothing, as on the port's engines (their
state trees already ping-pong in place); `donation_supported` is a probe
of a TPU plugin and is not ported.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from lyra_tpu_torch.models.streaming import mask_tree
from lyra_tpu_torch.utils.capture import GraphCache, as_input, replay
from lyra_tpu_torch.utils.device import resolve

STREAM_AXIS = "streams"


def _norm(device) -> torch.device:
    """`device` with the card's index made explicit ("cuda" → "cuda:i")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class _Devices(tuple):
    """A mesh's devices in shard order; `size` as on a JAX mesh's array."""

    @property
    def size(self) -> int:
        return len(self)


class Mesh:
    """A 1-D device mesh: the devices in shard order and the axis name."""

    def __init__(self, devices: Sequence, axis_name: str = STREAM_AXIS):
        devs = tuple(_norm(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {devs}")
        self.devices = _Devices(devs)
        self.axis_name = axis_name

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_name == other.axis_name)

    def __hash__(self) -> int:
        return hash((tuple(self.devices), self.axis_name))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_name!r})")


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = STREAM_AXIS) -> Mesh:
    """1-D mesh over every attached card (or the given devices), stream
    axis only.  Without a card the default raises (utils/device.py's
    rule); CPU callers pass `["cpu"] * n`."""
    if devices is None:
        resolve(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis_name)


class BatchSharding:
    """The leading (stream) dimension split over a mesh's axis in
    contiguous row blocks, the rest of each leaf whole."""

    def __init__(self, mesh: Mesh, axis_name: str = STREAM_AXIS):
        self.mesh = mesh
        self.axis_name = axis_name

    def __eq__(self, other) -> bool:
        return (isinstance(other, BatchSharding) and self.mesh == other.mesh
                and self.axis_name == other.axis_name)

    def __hash__(self) -> int:
        return hash((self.mesh, self.axis_name))

    def blocks(self, batch: int) -> List[tuple]:
        """[(first row, end row)] of each shard for a batch of `batch`."""
        n = self.mesh.devices.size
        if batch % n:
            raise ValueError(f"batch size {batch} must divide evenly over "
                             f"{n} devices")
        per = batch // n
        return [(k * per, (k + 1) * per) for k in range(n)]


def batch_sharding(mesh: Mesh, axis_name: str = STREAM_AXIS) -> BatchSharding:
    """Shard the leading (stream) dimension, keep the rest whole."""
    return BatchSharding(mesh, axis_name)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        if not tree:
            return None
        tree = next(iter(tree.values()))
    return tree


class Sharded:
    """A `[B, …]` tensor or state tree split over a mesh's stream axis:
    `parts[k]` holds rows `sharding.blocks(B)[k]` on `mesh.devices[k]`."""

    __slots__ = ("parts", "sharding")

    def __init__(self, parts: Sequence, sharding: BatchSharding):
        self.parts = tuple(parts)
        self.sharding = sharding

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def shape(self) -> tuple:
        """The global shape of a sharded tensor."""
        p = self.parts[0]
        return (sum(int(q.shape[0]) for q in self.parts), *p.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def __array__(self, dtype=None, copy=None):
        a = unshard_batch_tree(self).numpy()
        return a if dtype is None else a.astype(dtype)


def shard_batch_tree(tree: Any, mesh: Mesh,
                     axis_name: str = STREAM_AXIS) -> Sharded:
    """Place every leaf of a `[B, ...]` tree (tensors or numpy arrays, or
    one such leaf) with dim 0 split over the mesh: part k, rows
    k·B/N … (k+1)·B/N − 1 of every leaf, copied to `mesh.devices[k]`."""
    sh = batch_sharding(mesh, axis_name)
    if isinstance(tree, Sharded):
        if tree.sharding == sh:
            return tree
        tree = unshard_batch_tree(tree)
    first = _first_leaf(tree)
    if first is None:  # an empty tree
        return Sharded([{} for _ in mesh.devices], sh)
    if np.ndim(first) < 1:
        raise ValueError("shard_batch_tree needs [B, ...] leaves")
    blocks = sh.blocks(int(first.shape[0]))

    def part(k):
        (lo, hi), dev = blocks[k], mesh.devices[k]

        def leaf(x):
            if int(x.shape[0]) != blocks[-1][1]:
                raise ValueError(f"leaf of {x.shape[0]} rows in a tree of "
                                 f"{blocks[-1][1]}")
            return as_input(x)[lo:hi].to(
                dev, copy=True, memory_format=torch.contiguous_format)

        return _tree_map(leaf, tree)

    return Sharded([part(k) for k in range(len(blocks))], sh)


def unshard_batch_tree(tree: Sharded, device="cpu") -> Any:
    """The inverse of `shard_batch_tree`: every leaf's parts concatenated
    in shard order on `device` (the host by default)."""
    def cat(parts):
        if isinstance(parts[0], dict):
            return {k: cat([p[k] for p in parts]) for k in parts[0]}
        return torch.cat([p.to(device) for p in parts])

    return cat(tree.parts)


class ShardedEngine:
    """Wraps an Encoder/DecoderEngine so state and per-tick IO are sharded
    over the stream axis of `mesh` (see the module docstring)."""

    def __init__(self, engine, mesh: Optional[Mesh] = None,
                 axis_name: str = STREAM_AXIS, donate: bool = False):
        self.engine = engine
        self.mesh = mesh if mesh is not None else make_mesh(
            axis_name=axis_name)
        self.axis_name = axis_name
        self._sh = batch_sharding(self.mesh, axis_name)
        # `donate` changes nothing: the state trees ping-pong in place.
        base = _norm(engine.device)
        replicas = {}
        for d in self.mesh.devices:
            if d not in replicas:
                replicas[d] = engine if d == base else engine.replica(d)
        self._replicas = [replicas[d] for d in self.mesh.devices]
        self.graphs: Optional[List[GraphCache]] = (
            [GraphCache(d) for d in self.mesh.devices]
            if self.mesh.devices[0].type == "cuda" else None)
        self._fresh = {}
        self._cur: Optional[int] = None  # the shard a program runs for

    @property
    def num_devices(self) -> int:
        return self.mesh.devices.size

    @property
    def device(self) -> torch.device:
        """Shard 0's device; every shard's is of its type."""
        return self.mesh.devices[0]

    def _check_batch(self, batch_size: int):
        if batch_size % self.num_devices != 0:
            raise ValueError(
                f"batch size {batch_size} must divide evenly over "
                f"{self.num_devices} devices")

    def __getattr__(self, name):
        # Delegate engine metadata (rvq, hop_samples, ...) so a ShardedEngine
        # drops into every seam a plain engine fits — notably the stream
        # servers (tools/stream_server.py).  Dunders are excluded so
        # protocol probes (copy/pickle) see this object, not the engine.
        if name.startswith("__") or name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    # -- the server seam ------------------------------------------------------------
    def own_graphs(self) -> Optional[List[GraphCache]]:
        """Graph caches for one holder of a long-lived sharded state (a
        server): one per shard, on that shard's memory pool.  None where
        the shards run eagerly."""
        if self.graphs is None:
            return None
        return [GraphCache(g.device, pool=g.pool) for g in self.graphs]

    @contextlib.contextmanager
    def _on_shard(self, k: int):
        """Runs the body for shard k: its replica answers `_step_impl`, and
        its card is the current device (captures and launches land
        there)."""
        dev = self.mesh.devices[k]
        guard = (torch.cuda.device(dev) if dev.type == "cuda"
                 else contextlib.nullcontext())
        self._cur = k
        try:
            with guard:
                yield
        finally:
            self._cur = None

    def _split(self, x) -> Sequence:
        """One step input → its per-shard inputs: a Sharded's parts, row
        blocks of a batch-leading array, or the array whole on every shard
        (the JAX wrapper's rule: a leading dim that divides is sharded)."""
        if isinstance(x, Sharded):
            if x.mesh != self.mesh:
                raise ValueError(f"input sharded over {x.mesh}, engine over "
                                 f"{self.mesh}")
            return x.parts
        shape = tuple(getattr(x, "shape", np.shape(x)))
        if shape and shape[0] % self.num_devices == 0:
            return [x[lo:hi] for lo, hi in self._sh.blocks(shape[0])]
        return [x] * self.num_devices

    def _split_state(self, state) -> Sequence:
        if isinstance(state, Sharded):
            if state.mesh != self.mesh:
                raise ValueError(f"state sharded over {state.mesh}, engine "
                                 f"over {self.mesh}")
            return state.parts
        return shard_batch_tree(state, self.mesh, self.axis_name).parts

    def _run(self, fn: Callable, key, state, *inputs,
             graphs: Optional[List[GraphCache]] = None):
        """`fn(state, *inputs) -> (*outputs, new_state)` on every shard over
        its own rows: one replay per shard in its graph cache (`graphs`, by
        default the engine's own), or eagerly where `graphs` is None.
        Every shard is launched before any result is read.  → each output
        and the new state as a Sharded."""
        caches = graphs or self.graphs
        if self.graphs is None:
            caches = None  # eager: the CPU, or where a caller chose so
        states = self._split_state(state)
        ins = [self._split(x) for x in inputs]
        res = []
        for k, dev in enumerate(self.mesh.devices):
            with self._on_shard(k):
                res.append(replay(caches[k] if caches else None, dev, fn,
                                  key, states[k], *(p[k] for p in ins)))
        return tuple(Sharded(col, self._sh) for col in zip(*res))

    def _step_impl(self, state, *args):
        """The current shard's replica's step (inside `_run` only)."""
        if self._cur is None:
            raise RuntimeError("ShardedEngine._step_impl runs inside _run, "
                               "one shard at a time")
        return self._replicas[self._cur]._step_impl(state, *args)

    def _reset(self, state, mask, graphs: Optional[List[GraphCache]] = None,
               **init):
        """Re-initialize the masked rows from a fresh tree built at the
        global batch and split (so each row keeps its unsharded lineage),
        one replay per shard."""
        mask = as_input(mask).bool()
        b = int(mask.shape[0])
        self._check_batch(b)
        key = (b, *sorted(init.items()))
        if key not in self._fresh:
            self._fresh[key] = shard_batch_tree(
                self.engine.init_state(b, **init), self.mesh, self.axis_name)
        fresh = self._fresh[key].parts
        return self._run(
            lambda s, m: (mask_tree(m, fresh[self._cur], s),),
            ("reset", key), state, mask, graphs=graphs)[0]

    # -- the engine API ----------------------------------------------------------
    def init_state(self, batch_size: int, **kw) -> Sharded:
        self._check_batch(batch_size)
        return shard_batch_tree(self.engine.init_state(batch_size, **kw),
                                self.mesh, self.axis_name)

    def reset_rows(self, state, mask, **kw) -> Sharded:
        """Stream admission/eviction on the mesh: re-initialize the masked
        rows, keeping every leaf sharded over the stream axis (the fresh
        template is cached per batch size and seed)."""
        return self._reset(state, mask, **kw)

    def step(self, state, *args):
        """The engine's step on every shard; outputs and the new state come
        back sharded, each part under its shard's capture rule (the tree
        stays valid through one more step)."""
        return self._run(self._step_impl, "step", state,
                         *self.engine._step_args(*args))
