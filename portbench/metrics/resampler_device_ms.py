"""Device ms per tick of the resampler both ways: the `enc.resample` and
`dec.resample` marker segments (codec/engine.py → dsp/resampler.py),
over the traced stretch (portbench/traced.py).  Only a cell whose rate is
not 16 kHz runs them."""

from portbench import traced


def read(ctx):
    return traced.device_ms(ctx, "enc.resample", "dec.resample")
