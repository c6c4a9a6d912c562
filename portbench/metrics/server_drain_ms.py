"""Host ms per tick the servers spend draining a tick's outputs: the self
time of the `enc.drain` and `dec.drain` spans (tools/stream_server.py:
the copies out of pinned memory, the masks and sizes after them), both
servers summed, over the traced stretch (portbench/traced.py)."""

from portbench import traced


def read(ctx):
    return traced.host_ms(ctx, "enc.drain", "dec.drain")
