"""Per-layer metrics, one module each, named as in BENCHMARK.json.

Each module's `read(ctx)` returns the metric's value, or None where the
run has nothing for it to read (the harness then leaves the metric out of
the line).  `ctx` (portbench/harness.py) holds the configuration and mix,
the streams and bits per packet, `window` (ticks completed and seconds of
the measured window, streams, and the hop's seconds), `profile`
(portbench/profiling.read of the traced ticks: device seconds and count
by event name, kernels, busy and window seconds), `profiled_ticks`,
`sync_wall_s` (wall seconds of each synchronous tick pair) and `work`
(the configuration's work class: Lyra's is portbench/work.Work).  A
metric that every cell reads takes only `peak` and `tick_flop()` of
`work`; one that reads more of it lists its cells (`workloads`).
"""
