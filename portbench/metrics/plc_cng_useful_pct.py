"""The share of decoder rows whose loss concealment or comfort noise is
used: 100 × (`dec.rows_concealed` + `dec.rows_comfort_noise`) ÷
`dec.rows_run`, the program's counters over the traced stretch
(portbench/traced.py).  The servers count the first two as they drain
(tools/stream_server.py); the decoder's step counts the rows its
concealment and comfort noise run over (codec/engine.py; kept with each
captured graph and counted at its replays), every row today, so the
capacity a tick.

A lower bound: a received row fading back from comfort noise uses the
noise too, and the host does not see it."""

from portbench import traced


def read(ctx):
    r = traced.reading(ctx)
    if r is None or not r["counts"].get("dec.rows_run"):
        return None
    c = r["counts"]
    return 100.0 * (c.get("dec.rows_concealed", 0)
                    + c.get("dec.rows_comfort_noise", 0)) / c["dec.rows_run"]
