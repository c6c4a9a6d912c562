"""The serial host part of a tick of the servers (tools/stream_server.py):
over a stretch of synchronous EncoderServer.tick_wire →
DecoderServer.tick_wire pairs, the mean wall time per pair minus the
device time per tick of the profiled async ticks (the same programs)."""

from portbench.metrics._device import seconds_per_tick


def read(ctx):
    device = seconds_per_tick(ctx)
    walls = ctx["sync_wall_s"]
    if device <= 0 or not walls:
        return None
    return (sum(walls) / len(walls) - device) * 1e3
