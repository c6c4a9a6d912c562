"""Shared reading of a traced window's device events by kernel name."""

from __future__ import annotations

from typing import Iterable

from portbench import profiling


def seconds_per_tick(ctx, names: Iterable[str] = ()) -> float:
    """Device seconds per profiled tick of the kernels whose own name is
    one of `names`, or of every device event (copies too) where `names`
    is empty."""
    names = tuple(names)
    total = 0.0
    for event, (secs, _) in ctx["profile"]["by_name"].items():
        if names and not any(profiling.own(n, event) for n in names):
            continue
        total += secs
    return total / ctx["profiled_ticks"]
