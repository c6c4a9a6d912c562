"""realtime_streams where the host paces the tick, read and not bounded:
B × ticks completed in the traced run's measured window × 0.020 s ÷ the
window's seconds (host clock).  In the 48 kHz cells the servers' serial
host work (staging and draining 8 MB of PCM a tick each way) takes about
as long as the card's, so this swings with the host's load; the card's
own capacity there is the end-to-end card_streams."""

HOP_S = 0.020


def read(ctx):
    win = ctx["window"]
    if win["ticks"] <= 0:
        return None
    return win["streams"] * win["ticks"] * HOP_S / win["window_s"]
