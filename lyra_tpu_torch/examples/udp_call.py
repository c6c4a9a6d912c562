"""Example: a real-transport loopback call — UDP datagrams, jitter buffer,
async device wire path, measured send→playout latency — the port of
examples/udp_call.py.

The full serving transport driven end to end:

  mic tick → EncoderServer.tick_wire_async (the card encodes + packs wire
  bytes) → one UDP datagram per stream per 20 ms (header: slot, seq) →
  127.0.0.1 loopback → socket drain → native JitterBuffer (reordering,
  late-drop, playout delay) → DecoderServer.tick_wire_async (the card
  unpacks + decodes, PLC/CNG on gaps) → playout.

Latency is measured per hop, wall clock from the UDP send of a packet to
the drain of its decoded audio, and reported as mean/p95 beside the
deterministic tick budget (jitter playout_delay + 2 async pipeline ticks).

Run from the repo root (on the card; `main(argv, device="cpu")` runs the
plain PyTorch versions):

    python -m lyra_tpu_torch.examples.udp_call --seconds 2 --callers 3 \
        --loss 0.1 --model_path DIR [--realtime]

`--realtime` paces ticks on the 20 ms wall-clock grid (the latency figures
then include real pacing); without it the loop free-runs and the wall
figures measure the pipeline itself.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
import time

import numpy as np

from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.examples import _common
from lyra_tpu_torch.tools.jitter_buffer import JitterBuffer
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils import wav
from lyra_tpu_torch.utils.device import resolve

_HDR = 6  # 2 B slot + 4 B seq, big-endian


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default=None,
                   help="A wav at 8/16/32/48 kHz (default: a seeded "
                        "stand-in for speech at 16 kHz).")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--callers", type=int, default=3)
    p.add_argument("--bitrate", type=int, default=3200)
    p.add_argument("--mixed", action="store_true",
                   help="Rotate callers through 3.2/6/9.2 kbps — the "
                        "mixed-bitrate device wire path end to end.")
    p.add_argument("--loss", type=float, default=0.1,
                   help="Probability a datagram is dropped before send.")
    p.add_argument("--playout_delay", type=int, default=2,
                   help="Jitter-buffer playout delay in ticks.")
    p.add_argument("--jitter_ticks", type=int, default=0,
                   help="Simulate bursty network delay: during Gilbert "
                        "bursts (5%% entry, 25%% recovery) datagrams are "
                        "held back uniform[2, J] ticks before the send.")
    p.add_argument("--adaptive", default=None, metavar="MIN:MAX[:WINDOW]",
                   help="Adaptive jitter-buffer playout delay within "
                        "[MIN, MAX] ticks, deciding every WINDOW ticks "
                        "(default 50): grows on observed lateness, gives "
                        "back sustained excess cushion.")
    p.add_argument("--red", type=int, default=0, metavar="D",
                   help="RED packet redundancy: each datagram also "
                        "carries the packet D ticks earlier "
                        "(packet.build_red framing; needs "
                        "--playout_delay >= D+1), so a lost datagram is "
                        "healed by its successor instead of concealed.")
    p.add_argument("--realtime", action="store_true",
                   help="Pace ticks on the 20 ms wall-clock grid.")
    p.add_argument("--ingest", choices=("python", "native"),
                   default="python",
                   help="Receive path: per-datagram Python drain, or the "
                        "native UDP pump (C++ recvmmsg thread -> jitter "
                        "buffer).")
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "lyra_tpu_torch_udp_call"))
    p.add_argument("--seed", type=int, default=0)
    _common.add_model_flag(p)
    args = p.parse_args(argv)
    _common.check_model_flag(p, args)

    if args.red and args.playout_delay < args.red + 1:
        p.error(f"--red {args.red} needs --playout_delay >= {args.red + 1} "
                "(the redundant copy must arrive before its sequence is "
                "due)")
    dev = resolve(device)

    rng = np.random.RandomState(args.seed)
    data = _common.read_input(args.input, args.seconds + 1, args.seed)
    rate = data.sample_rate_hz
    hop = config.num_samples_per_hop(rate)
    ticks = min(int(args.seconds * config.FRAME_RATE),
                data.samples.size // hop)
    cap = args.callers

    enc = EncoderServer(cap, engine=EncoderEngine(
        rate, model_path=args.model_path, device=dev), bitrate=args.bitrate)
    dec = DecoderServer(cap, engine=DecoderEngine(
        rate, model_path=args.model_path, emit_dtype="int16", device=dev))
    ad_max = (int(args.adaptive.split(":")[1])
              if args.adaptive is not None else 0)
    jb = JitterBuffer(cap, config.packet_size(184),
                      depth=max(args.playout_delay, ad_max,
                                args.jitter_ticks) + 6)
    pump = rx = None
    if args.ingest == "native":
        from lyra_tpu_torch.tools.udp_ingest import UdpIngest

        pump = UdpIngest(jb)  # owns the socket; all jb access goes via it
        addr = ("127.0.0.1", pump.port)
    rates = (3200, 6000, 9200) if args.mixed else (args.bitrate,)
    ingest = pump or jb
    if args.adaptive is not None:
        parts = [int(x) for x in args.adaptive.split(":")]
        window = parts[2] if len(parts) > 2 else 50
        ingest.set_adaptive(parts[0], parts[1], window)
    if args.red and pump is not None:
        pump.set_red(args.red)  # the python path parses in the drain below
    for c in range(cap):
        enc.add_stream(c, bitrate=rates[c % len(rates)])
        ingest.add_stream(dec.add_stream(c),
                          playout_delay=args.playout_delay)

    if pump is None:
        # Real UDP loopback: the receiver socket is the "remote end".
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.setblocking(False)
        addr = rx.getsockname()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    send_wall = {}  # (slot, seq) -> wall time of the UDP send
    latencies = []
    decoded = [[] for _ in range(cap)]
    sent = lost = 0
    next_tick = time.perf_counter()
    # --jitter_ticks: datagrams held back by a Gilbert-modulated number of
    # ticks before the send (tick -> [(slot, seq, pkt)]); one burst state
    # per caller, as each caller is its own network path.
    held = {}
    net_bad = [False] * cap
    # --red: per caller, the packet the next datagram carries as its
    # redundant block, and the packets still waiting to become one.
    prev_pkt = [b""] * cap
    prev_hist = [[] for _ in range(cap)]

    def network_delay(c):
        if args.jitter_ticks <= 0:
            return 0
        net_bad[c] = (rng.uniform() < 0.75) if net_bad[c] else (
            rng.uniform() < 0.05)
        return rng.randint(2, args.jitter_ticks + 1) if net_bad[c] else 0

    for t in range(ticks):
        if args.realtime:
            while time.perf_counter() < next_tick:
                time.sleep(0.001)
            # Pace relative to the previous tick, re-anchoring after any
            # overrun (e.g. the first tick's graph capture) instead of
            # free-running to catch up on a stale absolute grid.
            next_tick = max(next_tick, time.perf_counter()) + 0.02

        # Stays int16 end-to-end: the server uploads 2 B/sample (the engine
        # casts to f32 on the card) — half the host-link PCM traffic.
        audio = np.stack([
            data.samples[(t * hop + c * 160) % (data.samples.size - hop):]
            [:hop] for c in range(cap)
        ])

        # Encode (async device pipeline: returns tick t-1's wire bytes).
        got = enc.tick_wire_async(audio)
        if got is not None:
            wire, sizes = got
            seq = t - 1
            for c in range(cap):
                if sizes[c] == 0:
                    if args.red:
                        prev_pkt[c] = b""  # a silent tick heals nothing
                    continue  # DTX / inactive: nothing on the wire
                cur = bytes(wire[c, : sizes[c]])
                payload = cur
                if args.red:
                    # The datagram for seq also carries the packet emitted
                    # `red` ticks earlier — framed regardless of what the
                    # lossy network below does to either datagram (the
                    # sender can't know; that's the point).
                    payload = packet.build_red(cur, prev_pkt[c])
                    prev_hist[c].append(cur)
                    prev_pkt[c] = (prev_hist[c].pop(0)
                                   if len(prev_hist[c]) > args.red - 1
                                   else b"")
                if rng.uniform() < args.loss:
                    lost += 1
                    continue
                pkt = (c.to_bytes(2, "big") + seq.to_bytes(4, "big")
                       + payload)
                d = network_delay(c)
                if d > 0:
                    held.setdefault(t + d, []).append((c, seq, pkt))
                    continue
                tx.sendto(pkt, addr)
                send_wall[(c, seq)] = time.perf_counter()
                sent += 1
        for c, seq, pkt in held.pop(t, ()):
            tx.sendto(pkt, addr)  # a delayed datagram finally arriving
            send_wall[(c, seq)] = time.perf_counter()
            sent += 1

        if pump is None:
            # Drain the receiver socket into the jitter buffer; a RED
            # payload splits into its primary and the redundant copy.
            while True:
                try:
                    dgram, _ = rx.recvfrom(2048)
                except BlockingIOError:
                    break
                slot = int.from_bytes(dgram[:2], "big")
                seq = int.from_bytes(dgram[2:_HDR], "big")
                if not args.red:
                    jb.insert(slot, seq, dgram[_HDR:])
                    continue
                cur, prev = packet.parse_red(dgram[_HDR:])
                jb.insert(slot, seq, cur)
                if prev and seq >= args.red:
                    jb.insert_red(slot, seq - args.red, prev)
            pkts, received, sizes = jb.collect()
        else:
            # Native ingest: the pump's C++ thread has been filing
            # datagrams since they hit the socket; collect one tick.
            pkts, received, sizes = pump.collect()

        # Decode (async device pipeline over the device wire codec).
        out = dec.tick_wire_async(pkts, received, sizes.astype(np.int32))
        if out is None:
            continue
        now = time.perf_counter()
        # The audio drained now was submitted at tick t-1, which decoded the
        # jitter-buffer collect of that tick; the buffer's cursor drains
        # seq = collect_tick - playout_delay once warmed up.
        s = t - 1 - args.playout_delay
        for c in range(cap):
            decoded[c].append(out[c])
            key = (c, s)
            if key in send_wall:
                latencies.append(now - send_wall.pop(key))

    os.makedirs(args.out_dir, exist_ok=True)
    for c in range(cap):
        wav.write_wav_int16(os.path.join(args.out_dir, f"caller{c}.wav"),
                            np.concatenate(decoded[c]), rate)

    lat = np.array(latencies) * 1e3
    # Wire-send → playout spans the jitter-buffer delay + the decoder's
    # async tick; admission → playout adds the encoder's async tick + the
    # 20 ms of audio accumulating before encode.
    budget_ticks = args.playout_delay + 2
    print(f"{ticks} ticks, {cap} callers over UDP loopback: "
          f"{sent} datagrams sent, {lost} dropped by the network")
    if args.red:
        print(f"red heals: {ingest.red_heals}")
    if pump is not None:
        print(f"native ingest: {pump.stats()}")
        pump.close()
    else:
        rx.close()
    tx.close()
    print(f"jitter buffer: {jb.stats()}")
    if args.adaptive is not None:
        print(f"adaptive delay: {jb.adapt_stats()}")
    if lat.size:
        pacing = (" (realtime pacing)" if args.realtime
                  else " (free-running: pipeline cost only)")
        print(f"wire-send→playout latency: mean {lat.mean():.1f} ms, "
              f"p95 {np.percentile(lat, 95):.1f} ms over {lat.size} hops"
              f"{pacing}; "
              f"admission→playout budget = {budget_ticks} ticks "
              f"({budget_ticks * 20} ms) end to end")
    print(f"decoded wavs in {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
