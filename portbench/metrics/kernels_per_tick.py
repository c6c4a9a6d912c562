"""CUDA kernels per profiled tick (copies and fills not counted): a count
that a window of captured ticks repeats exactly."""


def read(ctx):
    k = ctx["profile"]["kernels"]
    return k / ctx["profiled_ticks"] if k > 0 else None
