"""Example: drain a serving host mid-call and resume on another — the
port of examples/drain_migrate.py.

A maintenance drain with live calls must not drop them: this example runs
concurrent calls through EncoderServer / DecoderServer, snapshots both
servers mid-call (engine state + slot table + per-stream bitrates +
counters, `save()`), "moves the host" by constructing fresh servers, and
resumes (`restore()`).  The decoded audio after migration is bitwise the
audio of a never-drained run — checked at the end, and the exit code is 1
on any difference.

Run from the repo root (on the card; `main(argv, device="cpu")` runs the
plain PyTorch versions):

    python -m lyra_tpu_torch.examples.drain_migrate --callers 3 \
        --model_path DIR --out_dir /tmp/migrate
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.examples import _common
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils import wav
from lyra_tpu_torch.utils.device import resolve


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default=None,
                   help="A 16 kHz wav (default: a seeded stand-in for "
                        "speech).")
    p.add_argument("--callers", type=int, default=3)
    p.add_argument("--bitrate", type=int, default=3200)
    p.add_argument("--ticks_before_drain", type=int, default=25)
    p.add_argument("--ticks_after", type=int, default=25)
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "lyra_tpu_torch_migrate"))
    _common.add_model_flag(p)
    args = p.parse_args(argv)
    _common.check_model_flag(p, args)
    dev = resolve(device)

    total_ticks = args.ticks_before_drain + args.ticks_after
    data = _common.read_input(args.input, total_ticks / config.FRAME_RATE)
    if data.sample_rate_hz != config.INTERNAL_SAMPLE_RATE:
        print(f"this demo expects a {config.INTERNAL_SAMPLE_RATE} Hz wav "
              f"(got {data.sample_rate_hz}); see loopback_call.py for the "
              f"multi-rate serving setup", file=sys.stderr)
        return 1
    hop = config.num_samples_per_hop(data.sample_rate_hz)
    cap = args.callers
    usable = (min(len(data.samples), total_ticks * hop) // hop) * hop
    if usable == 0:
        print("input shorter than one 20 ms hop", file=sys.stderr)
        return 1
    frames = data.samples[:usable].reshape(-1, hop)

    def servers():
        enc = EncoderServer(cap, model_path=args.model_path,
                            bitrate=args.bitrate, device=dev)
        dec = DecoderServer(cap, model_path=args.model_path, device=dev)
        return enc, dec

    def tick(enc, dec, t):
        audio = np.broadcast_to(frames[t % len(frames)], (cap, hop))
        pkts = enc.tick({c: audio[c] for c in range(cap)})
        return dec.tick(pkts)

    # Host A carries the calls...
    enc_a, dec_a = servers()
    enc_a.add_streams(range(cap))
    dec_a.add_streams(range(cap))
    # ...and a control pair runs the same calls with no drain (the oracle).
    enc_o, dec_o = servers()
    enc_o.add_streams(range(cap))
    dec_o.add_streams(range(cap))

    decoded = {c: [] for c in range(cap)}
    for t in range(args.ticks_before_drain):
        out = tick(enc_a, dec_a, t)
        tick(enc_o, dec_o, t)
        for c in range(cap):
            decoded[c].append(out[c])

    # Maintenance drain: snapshot host A, stand up host B, resume.
    with tempfile.TemporaryDirectory() as snap:
        enc_a.save(os.path.join(snap, "enc"))
        dec_a.save(os.path.join(snap, "dec"))
        enc_b, dec_b = servers()
        enc_b.restore(os.path.join(snap, "enc"))
        dec_b.restore(os.path.join(snap, "dec"))
    print(f"drained host A after {args.ticks_before_drain} ticks; "
          f"host B resumed {enc_b.num_active} calls")

    mismatches = 0
    for t in range(args.ticks_before_drain, total_ticks):
        out = tick(enc_b, dec_b, t)
        ref = tick(enc_o, dec_o, t)
        for c in range(cap):
            decoded[c].append(out[c])
            if not np.array_equal(out[c], ref[c]):
                mismatches += 1

    os.makedirs(args.out_dir, exist_ok=True)
    for c in range(cap):
        wav.write_wav_int16(os.path.join(args.out_dir, f"caller{c}.wav"),
                            np.concatenate(decoded[c]),
                            config.INTERNAL_SAMPLE_RATE)
    print(f"{total_ticks} ticks x {cap} callers; post-migration audio "
          f"mismatches vs the never-drained oracle: {mismatches}")
    return 0 if mismatches == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
