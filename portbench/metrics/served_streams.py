"""realtime_streams where the host paces the tick, read and not bounded:
B × ticks completed in the traced run's measured window × the hop (the
configuration's `hop_ms`) ÷ the window's seconds (host clock).  In the
48 kHz cells the servers' serial host work (staging and draining 8 MB of
PCM a tick each way) takes about as long as the card's, so this swings
with the host's load; the card's own capacity there is the end-to-end
card_streams."""

from portbench.harness import streams_carried


def read(ctx):
    win = ctx["window"]
    if win["ticks"] <= 0:
        return None
    return streams_carried(win["streams"], win["ticks"], win["hop_s"],
                           win["window_s"])
