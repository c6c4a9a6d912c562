"""Carry engine state trees between the JAX package and the port.

A JAX engine state tree, taken leaf by leaf as `np.asarray`, becomes a
torch tree with the same keys and shapes, and back.  Two dtypes differ in
transit:

  * JAX's uint32 comfort-noise phase counter (`cng.ctr`), which the port
    holds as int64 (torch lacks uint32 arithmetic on the CPU): a uint32
    leaf comes in as int64, and the leaf named `ctr` goes back as uint32;
  * bfloat16 (the conv states of the bf16 engines), which numpy has no
    dtype of its own for.  The JAX package holds it as
    `ml_dtypes.bfloat16`; `np.savez` stores such an array as `|V2`, and
    `np.load` gives `|V2` back.  Both come in by their 16-bit pattern, so
    the roundtrip is bitwise.  Going out, a bf16 leaf becomes
    `ml_dtypes.bfloat16` where that package is installed (it comes with
    jax) and `|V2` where it is not: the same bits either way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lyra_tpu_torch.utils.device import resolve

_UINT32_LEAF = "ctr"  # the comfort-noise phase counter, cng.ctr


def _is_bf16_bits(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def state_from_numpy(tree: Any, device=None) -> Any:
    """numpy (or JAX) state tree → torch tree on `device` (the card by
    default)."""
    device = resolve(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if _is_bf16_bits(a):
        bits = torch.tensor(a.view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def _bf16_dtype() -> np.dtype:
    try:
        import ml_dtypes
    except ImportError:
        return np.dtype("V2")
    return np.dtype(ml_dtypes.bfloat16)


def state_to_numpy(tree: Any, key: str = "") -> Any:
    """torch state tree → numpy tree with the JAX package's dtypes."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v, k) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16_dtype())
    a = t.numpy()
    if key == _UINT32_LEAF and a.dtype == np.int64:
        a = a.astype(np.uint32)
    return a
