"""The device the port's entry points run on when the caller names none.

The port is written for the card: every constructor and function that
takes `device=` defaults to `torch.device("cuda")`.  Without a card that
default raises instead of falling back to the CPU, so a CPU run is always
asked for (`device="cpu"`), never silent.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means torch.device("cuda"), and
    raises when torch sees no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lyra_tpu_torch runs on a CUDA device by default and torch sees "
            "none; pass device=\"cpu\" to run the plain PyTorch versions on "
            "the CPU")
    return torch.device("cuda")
