"""Example: a real conference call over UDP — N callers, rooms, reply
routing, mouth-to-ear audio both ways — the port of
examples/conference_call.py.

The MCU deployment story end to end, every hop real:

  caller mic tick → client EncoderServer (encode + pack)
    → one UDP uplink datagram per caller per 20 ms, each caller on their
      OWN socket (that socket's address is their identity to the bridge)
    → serve_main --mode bridge --echo reply (in another thread: native
      ingest pump → jitter buffer → decode on the card → per-room
      mix-minus-one → re-encode → native egress, downlink sent back to
      each caller's uplink source — no address configuration anywhere)
    → per-caller downlink datagrams → client DecoderServer (unpack +
      decode) → playout wavs in --out_dir

Rooms are consecutive groups of slots; even slots speak (the input
signal), odd slots are silent listeners, so each listener's downlink must
carry their roommate's speech and each speaker hears their silent
roommate (near-silence).  Reported: per-caller downlink RMS (the room
semantics, audibly) and ordinal uplink→downlink latency (wall clock from
sending this tick's uplink to draining the k-th downlink hop).  Exits 1
when the listeners' downlinks are near-silent.

The call is real-time paced on the 20 ms grid (a priming phase absorbs
the bridge's first-tick graph captures so the measured call never runs
mid-capture).  The bridge thread captures its CUDA graphs in this
process, so the client's uplink is encoded before the bridge starts and
its downlink decoded after the bridge stops: while the bridge runs, this
thread only moves datagrams.  Run from the repo root (on the card;
`main(argv, device="cpu")` runs the plain PyTorch versions):

    python -m lyra_tpu_torch.examples.conference_call --seconds 2 \
        --callers 4 --room_size 2 --model_path DIR
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import threading
import time

import numpy as np

from lyra_tpu_torch.examples import _common
from lyra_tpu_torch.tools import serve_main
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils import wav
from lyra_tpu_torch.utils.device import resolve

_HDR = 6  # 2 B slot + 4 B seq, big-endian


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default=None,
                   help="A 16 kHz wav (default: a seeded stand-in for "
                        "speech).")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--callers", type=int, default=4)
    p.add_argument("--room_size", type=int, default=2)
    p.add_argument("--bitrate", type=int, default=3200)
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "lyra_tpu_torch_conference"))
    _common.add_model_flag(p)
    args = p.parse_args(argv)
    _common.check_model_flag(p, args)
    n = args.callers
    if n % args.room_size:
        raise ValueError(f"{n} callers do not fill rooms of "
                         f"{args.room_size}")
    dev = resolve(device)

    # Client side: one batched encoder plays every caller's phone; even
    # slots speak the input (each at a different offset), odd slots are
    # silent listeners.
    enc = EncoderServer(n, model_path=args.model_path, bitrate=args.bitrate,
                        device=dev)
    enc.add_streams(range(n))
    dec = DecoderServer(n, model_path=args.model_path, device=dev)
    dec.add_streams(range(n))
    speech = _common.read_input(args.input, args.seconds + 1).samples
    hop = enc.hop_samples
    ticks = int(args.seconds * 50)

    # Pre-encode every caller's whole uplink before the call (a phone
    # encodes on its own silicon; here one process runs the bridge AND
    # all the phones, so the live loop must be pure datagram IO to hold
    # the 20 ms grid).  Streaming encoder state carries tick to tick, so
    # this is the exact packet sequence a live encoder would emit.
    uplinks = []
    for t in range(ticks):
        audio = np.zeros((n, hop), np.int16)
        for s_ in range(0, n, 2):  # even slots speak
            start = (t * hop + 1600 * s_) % max(1, len(speech) - hop)
            audio[s_] = speech[start: start + hop]
        uplinks.append(enc.tick_wire(audio))
    shape = uplinks[0][0].shape

    socks = []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.setblocking(False)
        socks.append(s)

    def send_tick(t, seq):
        pkts, sizes = uplinks[t]
        for slot in range(n):
            socks[slot].sendto(
                slot.to_bytes(2, "big") + seq.to_bytes(4, "big")
                + pkts[slot, : sizes[slot]].tobytes(), bridge_addr)

    def drain():
        down = np.zeros(shape, np.uint8)
        received = np.zeros(n, bool)
        dsz = np.zeros(n, np.int32)
        for slot in range(n):
            while True:
                try:
                    d = socks[slot].recvfrom(2048)[0]
                except BlockingIOError:
                    break
                payload = d[_HDR:]
                down[slot, : len(payload)] = np.frombuffer(payload, np.uint8)
                received[slot] = True
                dsz[slot] = len(payload)
        return down, received, dsz

    stop = threading.Event()
    ready = threading.Event()
    box = {}

    def bridge():
        try:
            box["rc"] = serve_main.main(
                ["--mode", "bridge", "--capacity", str(n),
                 "--room_size", str(args.room_size), "--seconds", "0",
                 "--model_path", args.model_path,
                 "--bitrate", str(args.bitrate), "--max_bitrate",
                 str(args.bitrate), "--playout_delay", "1",
                 "--report_every", "1e9", "--echo", "reply"],
                _on_ready=lambda port: (box.update(port=port), ready.set()),
                _stop=stop, device=dev)
        except BaseException as e:  # re-raised below
            box["error"] = e
            ready.set()

    sent_at = []
    got_hops = [0] * n
    latencies = []
    recorded = []  # (down, received, sizes) per tick, decoded after
    with _common.card_to_thread():
        bridge_th = threading.Thread(target=bridge, daemon=True)
        bridge_th.start()
        try:
            if not ready.wait(300) or "error" in box:
                raise RuntimeError("bridge never came up") from box.get(
                    "error")
            bridge_addr = ("127.0.0.1", box["port"])

            # Priming: pace the first uplink ticks (recycled) until
            # downlink flows from every caller — the bridge captures its
            # programs on its first real ticks, and a live call cannot
            # start mid-capture.
            primed = set()
            seq = 0
            t_next = time.perf_counter()
            deadline = time.perf_counter() + 300
            while len(primed) < n and time.perf_counter() < deadline:
                while time.perf_counter() < t_next:
                    time.sleep(0.001)
                t_next = max(t_next, time.perf_counter()) + 0.02
                send_tick(seq % ticks, seq)
                seq += 1
                _, received, _ = drain()
                primed.update(np.flatnonzero(received).tolist())
            if len(primed) < n:
                raise RuntimeError(f"downlink never reached callers "
                                   f"{sorted(set(range(n)) - primed)}")

            # The measured call: pure IO on the 20 ms grid — send tick
            # t's uplink, drain and record whatever downlink arrived.
            # Latency is ordinal (steady state both ways: hop k's drain
            # minus uplink k's send is the pipeline budget up to a
            # constant pacing offset).
            for t in range(ticks):
                while time.perf_counter() < t_next:
                    time.sleep(0.001)
                t_next = max(t_next, time.perf_counter()) + 0.02
                send_tick(t, seq)
                sent_at.append(time.perf_counter())
                seq += 1
                down, received, dsz = drain()
                now = time.perf_counter()
                for slot in np.flatnonzero(received):
                    k = got_hops[slot]
                    if k < len(sent_at):
                        latencies.append(now - sent_at[k])
                    got_hops[slot] += 1
                recorded.append((down, received, dsz))
        finally:
            stop.set()
            bridge_th.join(60)
            for s in socks:
                s.close()
    if "error" in box:
        raise RuntimeError("the bridge failed") from box["error"]

    # Decode the recorded downlink tick by tick (the same DecoderServer
    # streaming path a live client runs, just off the clock now).
    playout = [[] for _ in range(n)]
    for down, received, dsz in recorded:
        pcm = dec.tick_wire(down, received, dsz)
        for slot in np.flatnonzero(received):
            playout[slot].append(np.asarray(pcm[slot]))

    os.makedirs(args.out_dir, exist_ok=True)
    print(f"{ticks} ticks, {n} callers in rooms of {args.room_size} "
          f"over UDP loopback (reply-routed):")
    for slot in range(n):
        audio_out = (np.concatenate(playout[slot]) if playout[slot]
                     else np.zeros(1, np.int16))
        rms = float(np.sqrt(np.mean(audio_out.astype(np.float64) ** 2)))
        role = "speaker " if slot % 2 == 0 else "listener"
        wav.write_wav_int16(
            os.path.join(args.out_dir, f"caller{slot}_downlink.wav"),
            audio_out.astype(np.int16), 16000)
        print(f"  caller {slot} ({role}): {got_hops[slot]} downlink hops, "
              f"downlink RMS {rms:7.1f}")
    if latencies:
        lat = np.array(latencies) * 1e3
        print(f"uplink-send→downlink-drain latency (realtime-paced, "
              f"ordinal): mean {lat.mean():.1f} ms, "
              f"p95 {np.percentile(lat, 95):.1f} ms over {len(lat)} hops")
    print(f"wavs in {args.out_dir}")
    # The room semantics, audibly: listeners hear their speaking roommate.
    listeners = [np.sqrt(np.mean(np.concatenate(playout[s]).astype(
        np.float64) ** 2)) for s in range(1, n, 2) if playout[s]]
    if listeners and max(listeners) < 100:
        print("WARNING: listener downlinks are near-silent; "
              "room mixing did not deliver speech")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
