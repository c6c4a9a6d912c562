"""Batched streaming wrappers for the learned codec networks.

Port of lyra_tpu/models/streaming.py.  Each network advances B streams by
one 20 ms hop per call, with its per-stream conv state as an explicit dict
of `[B, ...]` tensors (the JAX engine's keys and shapes).

The backend is chosen by composition: `backend="kernel"` runs the graph
through FusedStack (the conv-stack kernels on its multi-channel core),
`backend="plain"` through the executor's torch lowering.  Both take and
return the same state tree.  `mode` ("float" or "bf16") is the graphs'
compute dtype on either backend; inputs and outputs stay float32.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from lyra_tpu_torch.ops.fused_stack import FusedStack
from lyra_tpu_torch.tflite.executor import load_graph

State = Dict[str, torch.Tensor]
BACKENDS = ("kernel", "plain")


class _PlainGraph:
    """Executor GraphFn behind FusedStack's `(state, x) → (y, state)` call."""

    def __init__(self, path: str, mode: str, device):
        self._graph = load_graph(path, mode=mode, device=device)
        (self._input_name,) = self._graph.sig_inputs
        (self._output_name,) = self._graph.sig_outputs

    def init_state(self, batch_size: int) -> State:
        return self._graph.init_state(batch_size)

    def __call__(self, state: State, x: torch.Tensor):
        outputs, new_state = self._graph(state, **{self._input_name: x})
        return outputs[self._output_name], new_state


def mask_tree(mask: torch.Tensor, new_tree, old_tree):
    """Per-leaf select of `new_tree` where `mask` ([B] bool) is set, over
    nested dicts of `[B, ...]` tensors."""
    if isinstance(new_tree, dict):
        return {k: mask_tree(mask, v, old_tree[k]) for k, v in new_tree.items()}
    return torch.where(mask.reshape((-1,) + (1,) * (new_tree.ndim - 1)),
                       new_tree, old_tree)


class StreamingModel:
    """One stateful streaming graph run by the chosen backend."""

    def __init__(self, path: str, backend: str = "kernel",
                 mode: str = "float", device=None,
                 state_dtype: str | None = None,
                 boundary_store: str | None = None):
        if state_dtype is not None:
            raise NotImplementedError(
                "state_dtype: int8 state storage is not ported")
        if boundary_store is not None:
            raise NotImplementedError(
                "boundary_store: fp8 boundary storage is not ported")
        if backend == "kernel":
            self._run = FusedStack(path, mode=mode, device=device)
        elif backend == "plain":
            self._run = _PlainGraph(path, mode, device)
        else:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")

    def init_state(self, batch_size: int) -> State:
        """Initial streaming state replicated over `batch_size` streams."""
        return self._run.init_state(batch_size)

    def reset_rows(self, state: State, mask: torch.Tensor) -> State:
        """Reset state to initial values where `mask` ([B] bool) is set."""
        return mask_tree(mask.bool(), self.init_state(int(mask.shape[0])),
                         state)

    def __call__(self, state: State, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
        return self._run(state, x)


class SoundStreamEncoder(StreamingModel):
    """320 samples @16 kHz → 64 features per stream (unit-float audio in)."""

    def __init__(self, model_path: str, **kwargs):
        super().__init__(os.path.join(model_path, "soundstream_encoder.tflite"),
                         **kwargs)

    def extract(self, state: State, frames: torch.Tensor):
        feats, state = self(state, frames)  # [B, 320] -> [B, 1, 64]
        return feats[:, 0, :], state


class LyraGanModel(StreamingModel):
    """64 features → 320 samples @16 kHz per stream (unit-float audio out)."""

    def __init__(self, model_path: str, **kwargs):
        super().__init__(os.path.join(model_path, "lyragan.tflite"), **kwargs)

    def decode_hop(self, state: State, features: torch.Tensor):
        return self(state, features[:, None, :])  # [B, 1, 64] -> [B, 320]
