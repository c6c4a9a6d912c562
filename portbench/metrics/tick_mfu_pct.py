"""The whole tick against the chip's peak: model operations per tick (2 ×
the multiply-adds of every conv-family op of both graphs, plus the RVQ
search; elementwise ops not counted) × ticks completed ÷ the measured
window's seconds ÷ the configuration dtype's peak (67 TFLOP/s float32
with TF32 off, 989 TFLOP/s bf16), in %.  Read over the window of the
traced run, before its profiler stretch."""


def read(ctx):
    w, win = ctx["work"], ctx["window"]
    if win["ticks"] <= 0:
        return None
    return 100.0 * w.tick_flop() * win["ticks"] / win["window_s"] / w.peak
