"""Host ms per tick of launching the servers' programs: the self time of
the `graph.replay` spans (utils/capture.py: the state-signature walk, the
static-input copies, the replay call), both servers summed, over the
traced stretch (portbench/traced.py)."""

from portbench import traced


def read(ctx):
    return traced.host_ms(ctx, "graph.replay")
