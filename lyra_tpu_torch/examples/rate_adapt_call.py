"""Example: congestion-responsive downlink bitrate — the set_bitrate
knob turned by a measuring controller, closed loop — the port of
examples/rate_adapt_call.py.

The serving stack exposes per-stream mid-call rate changes
(`serve_main --control` verb `set_bitrate`, reference:
lyra/lyra_encoder.cc:158-166) — this example is the loop an operator
closes around it:

  callers ── PCM uplink ──► encode host (starts everyone at 9.2 kbps)
                                 │ lyra packets
                                 ▼
                     constrained link (token bucket,
                     --link_bytes_per_s; overflow = drops)
                                 │
                                 ▼
         receivers count delivered/dropped per window
                                 │
         controller: aggregate link loss > --loss_threshold in a window
             → step the highest-rate streams down one rung
               (9200 → 6000 → 3200, per-stream
                HostControl.set_bitrate; takes effect next tick)

The bottleneck is SHARED, so the response must be shared too: a
token-bucket link drains in arrival order, which starves whichever
flows queue behind the others — per-stream loss says who lost the race,
not whose rate to cut (measured here: two slots at 0% while two sat at
~95% after stepping all the way down).  The controller therefore acts
on the aggregate and cuts the heaviest flows first, the
highest-rate-first analog of AIMD's multiplicative decrease.

With the default link budget the full fleet at 9.2 kbps oversubscribes
the link (~45% loss), 6 kbps still oversubscribes, and 3.2 kbps fits —
so the loop must walk every stream down to 3.2 kbps and the final
windows must be loss-free.  The example prints each window's per-stream
rates and the link loss and exits 0 only if the fleet converges to a
clean window (ADAPT OK).

This is codec-side congestion response in the DTX spirit — the encoder
emits fewer bits when the path cannot carry more, and quality degrades
gracefully (all three rates are the same model, reference:
lyra/README.md:16) — not a transport-protocol implementation: real
deployments read loss from RTCP receiver reports; here the receivers
are in-process so the same signal is measured directly.

The encode host is `serve_main --mode encode` in a thread of this
process; it captures its CUDA graphs there, so while it runs this thread
only moves datagrams and control requests.  Run from the repo root (on
the card; `main(argv, device="cpu")` runs the plain PyTorch versions):

    python -m lyra_tpu_torch.examples.rate_adapt_call --callers 4 \
        --seconds 8 --model_path DIR
"""

from __future__ import annotations

import argparse
import socket
import threading
import time

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.examples import _common
from lyra_tpu_torch.tools import serve_main
from lyra_tpu_torch.tools.fleet import HostControl
from lyra_tpu_torch.utils.device import resolve

_HDR = 6  # 2 B slot + 4 B seq, big-endian (the stack's wire header)
_RATES = (9200, 6000, 3200)  # step-down ladder


class _TokenBucketLink:
    """The constrained downlink: datagrams within the byte budget are
    delivered, the rest are drops — per-slot accounting for the
    controller's loss signal."""

    def __init__(self, n_slots: int, bytes_per_s: float):
        self._rate = bytes_per_s
        self._tokens = bytes_per_s * 0.04  # two ticks of burst
        self._burst = self._tokens
        self._t_last = time.monotonic()
        self.delivered = np.zeros(n_slots, np.int64)
        self.dropped = np.zeros(n_slots, np.int64)

    def offer(self, slot: int, n_bytes: int) -> bool:
        now = time.monotonic()
        self._tokens = min(self._burst,
                           self._tokens + (now - self._t_last) * self._rate)
        self._t_last = now
        if self._tokens >= n_bytes:
            self._tokens -= n_bytes
            self.delivered[slot] += 1
            return True
        self.dropped[slot] += 1
        return False

    def window_reset(self):
        d, x = self.delivered.copy(), self.dropped.copy()
        self.delivered[:] = 0
        self.dropped[:] = 0
        return d, x


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--callers", type=int, default=4)
    p.add_argument("--seconds", type=float, default=8.0,
                   help="Live-loop duration (after the first captures).")
    p.add_argument("--link_bytes_per_s", type=float, default=None,
                   help="Downlink budget; default sizes it so the fleet "
                        "fits at 3.2 kbps with ~15%% headroom but "
                        "oversubscribes at 6 and 9.2 kbps.")
    p.add_argument("--window_s", type=float, default=0.5,
                   help="Controller measurement window.")
    p.add_argument("--loss_threshold", type=float, default=0.05,
                   help="Per-window loss fraction that triggers a "
                        "step-down.")
    _common.add_model_flag(p)
    args = p.parse_args(argv)
    _common.check_model_flag(p, args)
    dev = resolve(device)
    cap = args.callers
    if args.link_bytes_per_s is None:
        # Per-stream demand = (header + packet) * 50/s.
        at_3200 = cap * 50 * (_HDR + config.packet_size(64))
        args.link_bytes_per_s = at_3200 * 1.15

    echo_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    echo_rx.bind(("127.0.0.1", 0))
    echo_rx.settimeout(0.02)
    ctl_port = _common.free_udp_port()

    box = {}
    ready = threading.Event()
    stop = threading.Event()

    def encode_host():
        try:
            box["rc"] = serve_main.main(
                ["--mode", "encode", "--capacity", str(cap),
                 "--seconds", "0", "--model_path", args.model_path,
                 "--bitrate", "9200", "--max_bitrate", "9200",
                 "--ingest", "python", "--report_every", "60",
                 "--echo", f"127.0.0.1:{echo_rx.getsockname()[1]}",
                 "--control", str(ctl_port)],
                _on_ready=lambda port: (box.update(port=port), ready.set()),
                _stop=stop, device=dev)
        except BaseException as e:  # re-raised below
            box["error"] = e
            ready.set()

    with _common.card_to_thread():
        host = threading.Thread(target=encode_host)
        host.start()
        ctl = HostControl(("127.0.0.1", ctl_port))
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        ok = False
        try:
            if not ready.wait(120) or "error" in box:
                raise RuntimeError("encode host never bound its port") from \
                    box.get("error")
            ctl.wait_ready(180)

            t = np.arange(320) / 16000.0
            hop = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
            rates = {s: _RATES[0] for s in range(cap)}
            link = _TokenBucketLink(cap, args.link_bytes_per_s)
            print(f"link budget {args.link_bytes_per_s:.0f} B/s; fleet "
                  f"demand {cap * 50 * (_HDR + config.packet_size(184))} B/s "
                  f"at 9.2 kbps, "
                  f"{cap * 50 * (_HDR + config.packet_size(64))} B/s at 3.2",
                  flush=True)

            # Prime every rung of the ladder: the encode host captures one
            # wire program per fleet-max bitrate (stream_server keyed graph
            # cache), so warm all three now — a mid-loop rate change must
            # swap programs, not stall the 20 ms grid on a capture.
            seq = 0
            for warm in _RATES[::-1]:
                for s in range(cap):
                    ctl.set_bitrate(s, warm)
                deadline = time.time() + 200
                want = _HDR + config.bitrate_to_packet_size(warm)
                primed = False
                while not primed and time.time() < deadline:
                    for s in range(cap):
                        tx.sendto(s.to_bytes(2, "big") + seq.to_bytes(4, "big")
                                  + hop.tobytes(), ("127.0.0.1", box["port"]))
                    seq += 1
                    try:
                        primed = len(echo_rx.recvfrom(4096)[0]) == want
                    except socket.timeout:
                        pass
                assert primed, f"no downlink at {warm} bps within the deadline"
            while True:  # stale warm-up packets must not count as traffic
                try:
                    echo_rx.recvfrom(4096)
                except socket.timeout:
                    break

            clean_windows = 0
            windows = []
            next_tick = time.monotonic()
            t_end = time.monotonic() + args.seconds
            next_window = time.monotonic() + args.window_s
            while time.monotonic() < t_end:
                while time.monotonic() < next_tick:
                    time.sleep(0.001)
                next_tick = max(next_tick, time.monotonic()) + 0.02
                for s in range(cap):
                    tx.sendto(s.to_bytes(2, "big") + seq.to_bytes(4, "big")
                              + hop.tobytes(), ("127.0.0.1", box["port"]))
                seq += 1
                # Drain the downlink through the constrained link.
                while True:
                    try:
                        dgram, _ = echo_rx.recvfrom(4096)
                    except socket.timeout:
                        break
                    slot = int.from_bytes(dgram[:2], "big")
                    if slot < cap:
                        link.offer(slot, len(dgram))

                if time.monotonic() < next_window:
                    continue
                next_window += args.window_s
                delivered, dropped = link.window_reset()
                total = int(delivered.sum() + dropped.sum())
                link_loss = dropped.sum() / max(total, 1)
                line = " ".join(f"s{s}:{rates[s]}" for s in range(cap))
                print(f"window: link loss {link_loss:.0%}  rates {line}",
                      flush=True)
                windows.append((dict(rates), float(link_loss)))
                if total == 0:
                    continue
                if link_loss > args.loss_threshold:
                    clean_windows = 0
                    # Shared bottleneck → shared response: cut the heaviest
                    # flows one rung (see the module docstring).
                    top = max(rates.values())
                    below = [r for r in _RATES if r < top]
                    if below:
                        for s in range(cap):
                            if rates[s] == top:
                                rates[s] = below[0]
                                ctl.set_bitrate(s, rates[s])
                else:
                    clean_windows += 1

            # Success = the loop converged: the fleet stepped down to the
            # fitting rate and the final window(s) are clean.
            if not windows:
                print("no measurement window completed — raise --seconds "
                      "above --window_s", flush=True)
                ok = False
            else:
                final_rates, final_loss = windows[-1]
                ok = (all(r == 3200 for r in final_rates.values())
                      and final_loss <= args.loss_threshold
                      and clean_windows >= 1)
                print(f"converged: {windows[0][1]:.0%} link loss at 9.2 kbps "
                      f"→ {final_loss:.1%} at 3.2 kbps over "
                      f"{len(windows)} windows", flush=True)
        finally:
            try:
                ctl.quit()
            except Exception:
                stop.set()
            host.join(timeout=120)
            ctl.close()
            tx.close()
            echo_rx.close()
    if "error" in box:
        raise RuntimeError("the encode host failed") from box["error"]
    print("ADAPT " + ("OK: the controller walked the fleet down to the "
                      "rate the link carries" if ok else
                      "FAILED: loss did not converge"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
