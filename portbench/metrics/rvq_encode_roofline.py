"""The RVQ search kernel (K2, ops/csrc/rvq_encode.cu) against its
roofline: the bound of the search these packets need (portbench/work.py
`Work.rvq`, float32) over its device time per tick, in %."""

from portbench import peaks
from portbench.metrics._device import seconds_per_tick

K2_KERNELS = ("rvq_encode",)


def read(ctx):
    s = seconds_per_tick(ctx, K2_KERNELS)
    if s <= 0:
        return None
    flop, nbytes = ctx["work"].rvq()
    bound = peaks.bound_s(flop, nbytes, peaks.PEAK_FLOPS["float32"])
    return 100.0 * bound / s
