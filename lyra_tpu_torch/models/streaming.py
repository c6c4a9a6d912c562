"""Batched streaming wrappers for the learned codec networks.

Port of lyra_tpu/models/streaming.py.  Each network advances B streams by
one 20 ms hop per call, with its per-stream conv state as an explicit dict
of `[B, ...]` tensors (the JAX engine's keys and shapes).

The backend is chosen by composition: `backend="kernel"` runs the graph
through FusedStack (the conv-stack kernels on its multi-channel core),
`backend="plain"` through the executor's torch lowering.  Both take and
return the same state tree.  `mode` is the graphs' compute mode; inputs and
outputs stay float32.  The quantized modes ("int8", "fakequant") and fp8
boundaries (`boundary_store="f8"`) run on the plain lowering only, as the
JAX package's run on its xla lowering: the kernel backend refuses them, as
the JAX fused backend does.

`state_dtype="int8"` stores the large streaming-state buffers between
calls as int8 with a per-stream dynamic scale (`_quantize_leaf`): a leaf
becomes `{"q": int8 [B, ...], "s": float32 [B]}`.  The graph still
computes in its own dtype; only the storage of state between hops changes
(half the bytes of a snapshot, as in the JAX package).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from lyra_tpu_torch.ops.fused_stack import FusedStack, refuse_kernel_backend
from lyra_tpu_torch.tflite.executor import load_graph

State = Dict[str, torch.Tensor]
BACKENDS = ("kernel", "plain")

# Streaming-state leaves below this element count (per stream) are kept
# uncompressed when state compression is on: the per-stream scale would
# cost more than it saves.
_COMPRESS_MIN_SIZE = 256


def _quantize_leaf(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-stream int8 quantization of one [B, ...] state buffer.

    The scale is dynamic (recomputed each hop from the buffer's amax), so
    no calibration is needed and silence stays exactly zero."""
    flat = torch.abs(x.to(torch.float32).reshape(x.shape[0], -1))
    amax = torch.amax(flat, dim=1)
    # A divisor tensor on the card: CUDA divides by a host scalar as a
    # multiplication by its reciprocal, which rounds otherwise.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    q = torch.round(x.to(torch.float32)
                    / scale.reshape((-1,) + (1,) * (x.ndim - 1)))
    return {"q": torch.clamp(q, -127, 127).to(torch.int8), "s": scale}


def _dequantize_leaf(packed: Dict[str, torch.Tensor],
                     dtype: torch.dtype) -> torch.Tensor:
    q = packed["q"]
    s = packed["s"].reshape((-1,) + (1,) * (q.ndim - 1))
    return (q.to(torch.float32) * s).to(dtype)


class _PlainGraph:
    """Executor GraphFn behind FusedStack's `(state, x) → (y, state)` call."""

    def __init__(self, path: str, mode: str, device, boundary_store=None,
                 boundary_scale: float = 1.0, pin: bool = False):
        self._graph = load_graph(path, mode=mode, device=device,
                                 boundary_store=boundary_store,
                                 boundary_scale=boundary_scale, pin=pin)
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
    """One stateful streaming graph run by the chosen backend.

    `boundary_scale` is the power-of-two pre-scale of fp8 boundaries (the
    JAX models': 0.5 for SoundStream, 1.0 for LyraGAN)."""

    SEGMENT: str | None = None  # the kernel backend's tracer segments

    def __init__(self, path: str, backend: str = "kernel",
                 mode: str = "float", device=None,
                 state_dtype: str | None = None,
                 boundary_store: str | None = None,
                 boundary_scale: float = 1.0):
        if state_dtype not in (None, "int8"):
            raise ValueError(f"unsupported state_dtype {state_dtype!r}")
        if backend == "kernel":
            refuse_kernel_backend(mode, state_dtype, boundary_store)
            self._run = FusedStack(path, mode=mode, device=device,
                                   segment=self.SEGMENT)
        elif backend == "plain":
            # Compressed state is served by the plain lowering alone.
            self._run = _PlainGraph(path, mode, device, boundary_store,
                                    boundary_scale,
                                    pin=state_dtype is not None)
        else:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        template = self._run.init_state(1)
        self._dtypes = {k: v.dtype for k, v in template.items()}
        self._compress_keys = frozenset(
            k for k, v in template.items()
            if v[0].numel() >= _COMPRESS_MIN_SIZE) if state_dtype else \
            frozenset()

    def _compress(self, raw: State) -> State:
        return {k: _quantize_leaf(v) if k in self._compress_keys else v
                for k, v in raw.items()}

    def _decompress(self, state: State) -> State:
        return {k: _dequantize_leaf(v, self._dtypes[k])
                if k in self._compress_keys else v for k, v in state.items()}

    def init_state(self, batch_size: int) -> State:
        """Initial streaming state replicated over `batch_size` streams
        (compressed leaves as `{"q", "s"}`)."""
        return self._compress(self._run.init_state(batch_size))

    def reset_rows(self, state: State, mask: torch.Tensor) -> State:
        """Reset state to initial values where `mask` ([B] bool) is set."""
        return mask_tree(mask.bool(), self.init_state(int(mask.shape[0])),
                         state)

    def __call__(self, state: State, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
        if self._compress_keys:
            out, new_raw = self._run(self._decompress(state), x)
            return out, self._compress(new_raw)
        return self._run(state, x)


class SoundStreamEncoder(StreamingModel):
    """320 samples @16 kHz → 64 features per stream (unit-float audio in)."""

    SEGMENT = "ss"

    def __init__(self, model_path: str, **kwargs):
        # boundary_scale 0.5: the encoder's depthwise-conv context concats
        # peak at amax 628 > fp8 e4m3's 448 (the JAX package's measurement);
        # a half pre-scale (an exact power of two) brings them to 314.
        super().__init__(os.path.join(model_path, "soundstream_encoder.tflite"),
                         boundary_scale=0.5, **kwargs)

    def extract(self, state: State, frames: torch.Tensor):
        feats, state = self(state, frames)  # [B, 320] -> [B, 1, 64]
        return feats[:, 0, :], state


class LyraGanModel(StreamingModel):
    """64 features → 320 samples @16 kHz per stream (unit-float audio out)."""

    SEGMENT = "gan"

    def __init__(self, model_path: str, **kwargs):
        # boundary_scale 1.0: LyraGAN's activations peak at amax 31, far
        # inside e4m3's 448 (the JAX package's measurement).
        super().__init__(os.path.join(model_path, "lyragan.tflite"),
                         boundary_scale=1.0, **kwargs)

    def decode_hop(self, state: State, features: torch.Tensor):
        return self(state, features[:, None, :])  # [B, 1, 64] -> [B, 320]
