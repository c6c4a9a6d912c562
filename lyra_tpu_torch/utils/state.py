"""Carry engine state trees between the JAX package and the port.

A JAX engine state tree, taken leaf by leaf as `np.asarray`, becomes a
torch tree with the same keys and shapes, and back.  Two dtypes differ in
transit:

  * JAX's uint32 (the comfort-noise phase counter `cng.ctr`), which the
    port holds as int64 (torch lacks uint32 arithmetic on the CPU);
  * bfloat16 (the conv states of the bf16 engines), which numpy holds as
    `ml_dtypes.bfloat16` and torch cannot take directly: its bits move as
    16-bit integers and are reinterpreted on the other side, so the
    roundtrip is bitwise.  `ml_dtypes` is imported only when such a leaf
    appears (the GPU machine has no jax, and so maybe no ml_dtypes).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lyra_tpu_torch.utils.device import resolve


def state_from_numpy(tree: Any, device=None) -> Any:
    """numpy (or JAX) state tree → torch tree on `device` (the card by
    default)."""
    device = resolve(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(a.view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def state_to_numpy(tree: Any) -> Any:
    """torch state tree → numpy tree with the JAX package's dtypes."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    a = t.numpy()
    if a.dtype == np.int64:
        a = a.astype(np.uint32)
    return a
