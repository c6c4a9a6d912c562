"""The chip's published peaks and the roofline bound, shared by every
configuration's work class (its `work`) and every roofline metric."""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
# 700 W power limit.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12


def bound_s(flop: float, nbytes: float, peak: float) -> float:
    """The least time of `flop` operations at `peak` and `nbytes` bytes at
    the chip's bandwidth: the larger of the two."""
    return max(flop / peak, nbytes / PEAK_BYTES_S)
