"""Runnable call examples on the port — the counterparts of the JAX
package's `examples/`, each `python -m lyra_tpu_torch.examples.<name>`:

- `drain_migrate`     save → fresh servers → restore mid-call, in one
                      process; exits 1 unless the post-migration audio is
                      bitwise the never-drained run's;
- `loopback_call`     a simulated lossy network, the jitter buffer and PLC;
- `udp_call`          real UDP datagrams and the async device wire path
                      (`--mixed`, `--adaptive`, `--red`, `--ingest`);
- `conference_call`   `serve_main --mode bridge` in a thread, callers on
                      their own sockets, reply-routed downlink;
- `rate_adapt_call`   a congestion controller walking an encode host down
                      the bitrate ladder through `HostControl.set_bitrate`;
- `multihost_migrate` two `serve_main` host processes (and, with
                      `--controller`, a `fleet_main` process): a live drain
                      or, with `--failover`, a SIGKILL and the watchdog,
                      measured for each caller's longest audio gap.

Each `main(argv=None, *, device=None)` runs on the card by default and
raises without one; `device="cpu"` runs the plain PyTorch versions
(`multihost_migrate` spawns its hosts on the card only).  The model
directory is `--model_path` or LYRA_TPU_MODEL_PATH; without `--input` an
example plays a seeded stand-in for speech (`_common.test_signal`), so
none needs a file from outside the repository.
"""
