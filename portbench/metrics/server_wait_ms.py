"""Host ms per tick the servers wait on the card: the `host.wait` spans
(tools/stream_server.py: every event wait of `_HostIO`), both servers
summed, over the traced stretch (portbench/traced.py).  Waiting, not
host work."""

from portbench import traced


def read(ctx):
    return traced.host_ms(ctx, "host.wait")
