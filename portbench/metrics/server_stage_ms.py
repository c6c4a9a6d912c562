"""Host ms per tick the servers spend preparing a tick's inputs: the
self time of the `enc.stage`, `dec.stage` and `dec.unpack` spans
(tools/stream_server.py: `_pcm_in`, the copies into pinned memory, the
decoder's size and mask work), both servers summed, over the traced
stretch (portbench/traced.py)."""

from portbench import traced


def read(ctx):
    return traced.host_ms(ctx, "enc.stage", "dec.stage", "dec.unpack")
