"""The RVQ search kernel (K2, ops/csrc/rvq_encode.cu) against its
roofline: the bound of the search these packets need (portbench/work.py
`Work.rvq`, float32) over its device time per tick, in %."""

from portbench import work
from portbench.metrics._device import seconds_per_tick

K2_KERNELS = ("rvq_encode",)


def read(ctx):
    s = seconds_per_tick(ctx, K2_KERNELS)
    if s <= 0:
        return None
    w = ctx["work"]
    flop, nbytes = w.rvq()
    return 100.0 * w.bound_s(flop, nbytes, work.PEAK_FLOPS["float32"]) / s
