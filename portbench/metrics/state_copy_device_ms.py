"""Device ms per tick of copying state: the `graph.state_copy` segment
(utils/capture.py: each program's outputs and state tree into the static
buffers) and the `dec.gan_select` and `enc.ss_select` segments (the
models' state kept or replaced per row), over the traced stretch
(portbench/traced.py)."""

from portbench import traced


def read(ctx):
    return traced.device_ms(ctx, "graph.state_copy", "dec.gan_select",
                            "enc.ss_select")
