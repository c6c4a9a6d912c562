"""Device ms per tick of the conv stacks' edges: the `gan.prologue`,
`gan.epilogue`, `ss.prologue` and `ss.epilogue` marker segments
(ops/fused_stack.py: the graph ops around each model's core, the cuDNN
audio edges among them), over the traced stretch (portbench/traced.py)."""

from portbench import traced


def read(ctx):
    return traced.device_ms(ctx, "gan.prologue", "gan.epilogue",
                            "ss.prologue", "ss.epilogue")
