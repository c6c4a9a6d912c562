"""The conv-stack kernels (K1) against their roofline: Σ over the cores'
graph ops of max(operations / peak, bytes / 3.35 TB/s) at the cell's
batch and dtype (portbench/work.py), over K1's device time per tick, in %.

CORE_OPS are the graph ops that FusedStack's partition runs as launches of
their own at d33c86f (roles "conv" and "kernel" of its plan, on the
synthetic Lyra v2 fixture): the ops it absorbs (state concatenations,
splits, leaky ReLUs, residual adds, crops, state stores) and its views
cost no bytes of their own here.  A design that moves fewer bytes than
these ops read and write (one launch for a whole core) could pass 100 %:
its roofline would need a new name."""

from portbench.metrics.conv_stack_device_ms import K1_KERNELS
from portbench.metrics._device import seconds_per_tick

CORE_OPS = {
    "soundstream_encoder": (
        34, 36, 38, 41, 43, 45, 48, 50, 52, 55, 58, 60, 62, 65, 67, 69, 72,
        74, 76, 79, 82, 84, 86, 89, 91, 93, 96, 98, 100, 103, 106),
    "lyragan": (
        39, 42, 44, 46, 49, 51, 53, 56, 58, 60, 64, 65, 80, 83, 85, 87, 90,
        92, 94, 97, 99, 101, 105, 106, 111, 113, 115, 118, 120, 122, 125,
        127, 129, 132, 136, 140, 144),
}


def read(ctx):
    s = seconds_per_tick(ctx, K1_KERNELS)
    if s <= 0:
        return None
    return 100.0 * ctx["work"].core_bound_s(CORE_OPS) / s
