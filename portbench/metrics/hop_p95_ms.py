"""The 95th percentile, over every tick submitted and decoded inside the
measured window, of the time from handing tick t's PCM to
EncoderServer.tick_wire_async to getting tick t's PCM back from
DecoderServer (two ticks later in the pipelines), host clock.  At
capacity the tail swings with the smallest change of pace, so it is read
here and not bounded."""

import numpy as np


def read(ctx):
    lat = ctx["hop_latency_ms"]
    return float(np.percentile(lat, 95)) if len(lat) else None
