"""Device ms per tick of every kernel that is neither K1's nor K2's: the
engines' torch ops (codec/engine.py, dsp/, PLC, the noise estimator,
comfort noise, packet.py's device wire) and the cuDNN audio edges.
Copies are the servers', not counted here."""

from portbench import profiling
from portbench.metrics.conv_stack_device_ms import K1_KERNELS
from portbench.metrics.rvq_encode_roofline import K2_KERNELS


def read(ctx):
    total = 0.0
    for event, (secs, _) in ctx["profile"]["by_name"].items():
        if profiling.is_copy(event) or any(
                profiling.own(n, event) for n in K1_KERNELS + K2_KERNELS):
            continue
        total += secs
    if total <= 0:
        return None
    return total / ctx["profiled_ticks"] * 1e3
