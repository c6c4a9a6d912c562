"""Share of the profiled window's wall time in which no kernel or copy ran
on the device: 1 − (union of their intervals on the profiler's timeline ÷
the window), in %."""


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
