"""Example: a lossy network call through the batched serving stack — the
port of examples/loopback_call.py.

Simulates N concurrent callers: each 20 ms tick their audio is encoded to
wire packets (EncoderServer), pushed through a jittery network (random
delay, reordering, loss), reassembled by the native JitterBuffer, and
decoded back to audio (DecoderServer) — packet-loss concealment and comfort
noise engage on gaps.  Writes one decoded wav per caller.

Run from the repo root (on the card; `main(argv, device="cpu")` runs the
plain PyTorch versions):

    python -m lyra_tpu_torch.examples.loopback_call --seconds 2 \
        --callers 3 --loss 0.1 --model_path DIR --out_dir /tmp/call

This is the serving-API twin of the file-based CLIs
(lyra_tpu_torch/tools/{encoder,decoder}_main.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.examples import _common
from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils import wav
from lyra_tpu_torch.utils.device import resolve


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default=None,
                   help="A wav at 8/16/32/48 kHz (default: a seeded "
                        "stand-in for speech at 16 kHz).")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--callers", type=int, default=3)
    p.add_argument("--bitrate", type=int, default=3200)
    p.add_argument("--loss", type=float, default=0.1)
    p.add_argument("--max_delay_ticks", type=int, default=2)
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "lyra_tpu_torch_call"))
    p.add_argument("--seed", type=int, default=0)
    _common.add_model_flag(p)
    args = p.parse_args(argv)
    _common.check_model_flag(p, args)
    dev = resolve(device)

    rng = np.random.RandomState(args.seed)
    data = _common.read_input(args.input, args.seconds + 1, args.seed)
    rate = data.sample_rate_hz
    if not config.is_sample_rate_supported(rate):
        print(f"unsupported sample rate {rate}", file=sys.stderr)
        return 1
    hop = config.num_samples_per_hop(rate)
    ticks = min(int(args.seconds * config.FRAME_RATE),
                data.samples.size // hop)

    cap = args.callers
    # Engines at the wav's own rate (8/16/32/48 kHz all work): the servers'
    # hop size and the output wavs follow the input.
    enc = EncoderServer(cap, engine=EncoderEngine(
        rate, model_path=args.model_path, device=dev), bitrate=args.bitrate)
    dec = DecoderServer(cap, engine=DecoderEngine(
        rate, model_path=args.model_path, emit_dtype="int16", device=dev))
    jb = JitterBuffer(cap, config.packet_size(184),
                      depth=args.max_delay_ticks + 6)
    for c in range(cap):
        enc.add_stream(c)
        slot = dec.add_stream(c)
        jb.add_stream(slot, playout_delay=args.max_delay_ticks)

    in_flight = []  # (deliver_at_tick, slot, seq, bytes)
    decoded = [[] for _ in range(cap)]
    lost = 0
    for t in range(ticks):
        # Every caller speaks the same signal, offset per caller.
        audio = np.stack([
            data.samples[(t * hop + c * 160) % (data.samples.size - hop):]
            [:hop] for c in range(cap)
        ])  # int16 end-to-end: the server uploads 2 B/sample
        pkts, sizes = enc.tick_packed(audio)

        # "Network": random per-packet delay, loss.
        for c in range(cap):
            if rng.uniform() < args.loss:
                lost += 1
                continue
            delay = rng.randint(0, args.max_delay_ticks + 1)
            in_flight.append((t + delay, c, t, bytes(pkts[c, : sizes[c]])))
        arrived = [x for x in in_flight if x[0] <= t]
        in_flight = [x for x in in_flight if x[0] > t]
        for _, slot, seq, payload in arrived:
            jb.insert(slot, seq, payload)

        out = dec.tick_packed(*jb.collect())
        for c in range(cap):
            decoded[c].append(out[c])

    os.makedirs(args.out_dir, exist_ok=True)
    for c in range(cap):
        path = os.path.join(args.out_dir, f"caller{c}.wav")
        wav.write_wav_int16(path, np.concatenate(decoded[c]), rate)
    stats = jb.stats()
    print(f"{ticks} ticks, {cap} callers, {lost} packets dropped by the "
          f"network, jitter buffer stats: {stats}")
    print(f"decoded wavs in {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
