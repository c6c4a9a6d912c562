"""Batched offline transcoding: many files through one engine step — port
of lyra_tpu/tools/batch_transcode.py; each step is one CUDA-graph replay on
the card (`device=` names another device).

The reference CLIs (lyra/cli_example/encoder_main_lib.cc:43-133,
decoder_main_lib.cc:86-219) process one file at a time because the phone
codec is one interpreter per stream.  On an accelerator the natural
offline shape is the same as the serving shape: make the *files* the batch
axis.  All wavs of one sample rate are stacked into a
``[num_files, num_hops, hop]`` array,
one ``EncoderEngine``/``DecoderEngine`` advances every file by one 20 ms
frame per step, and per-file lengths are handled by trimming the padded
tail on the way out — short files simply carry dead rows for the last few
ticks (the engines' per-row state keeps them independent, so padding rows
cannot disturb real ones).

Usage:
  python -m lyra_tpu_torch.tools.batch_transcode --input_glob='dir/*.wav' \
      --output_dir=/tmp/out --bitrate=3200 [--mode=transcode|encode|decode]
      [--compute=float|bf16] [--enable_dtx]

``encode`` writes ``<stem>.lyra`` per input wav; ``decode`` expects
``.lyra`` inputs (requires --sample_rate for the output rate); ``transcode``
does encode+decode in lockstep and writes ``<stem>_decoded.wav``.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from lyra_tpu_torch import config, packet
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.utils import native, wav

log = logging.getLogger("lyra_tpu")


def _stack_padded(waves: Sequence[np.ndarray], hop: int
                  ) -> Tuple[np.ndarray, List[int]]:
    """Stack int16 sample vectors into [B, n_hops, hop]; returns per-file
    whole-hop counts (trailing partial hops are dropped, like the CLIs)."""
    hops = [len(w) // hop for w in waves]
    n = max(hops) if hops else 0
    out = np.zeros((len(waves), n, hop), np.float32)
    for i, w in enumerate(waves):
        m = hops[i] * hop
        out[i, : hops[i]] = np.asarray(w[:m], np.float32).reshape(-1, hop)
    return out, hops


def encode_batch(waves: Sequence[np.ndarray], sample_rate_hz: int,
                 bitrate: int, model_path: str = config.DEFAULT_MODEL_PATH,
                 enable_dtx: bool = False, compute: str = "float",
                 *, device=None) -> List[bytes]:
    """Encode many same-rate int16 waveforms → one `.lyra` byte stream each.

    Bit-identical to running the single-stream encoder per file (row
    independence is pinned by tests/test_torch_tools.py on the CPU and by
    chip_smoke.py on the card).
    """
    num_bits = config.bitrate_to_num_quantized_bits(bitrate)
    hop = config.num_samples_per_hop(sample_rate_hz)
    frames, hops = _stack_padded(waves, hop)
    enc = EncoderEngine(sample_rate_hz, model_path, enable_dtx=enable_dtx,
                        mode=compute, max_bitrate=bitrate, device=device)
    state = enc.init_state(len(waves))
    nq = np.full((len(waves),), num_bits // config.BITS_PER_QUANTIZER,
                 np.int32)

    streams = [bytearray() for _ in waves]
    start = time.monotonic()
    for t in range(frames.shape[1]):
        indices, is_noise, state = enc.step(state, frames[:, t], nq)
        indices, is_noise = indices.cpu().numpy(), is_noise.cpu().numpy()
        pkts = packet.pack_indices_batch(indices, num_bits)
        for i, h in enumerate(hops):
            if t < h:
                # DTX noise hops emit empty packets (lyra_encoder.cc:136-140);
                # offline that means zero bytes appended for this frame.
                if not is_noise[i]:
                    streams[i].extend(pkts[i].tobytes())
    _log_rate(start, sum(hops) * hop)
    return [bytes(s) for s in streams]


def decode_batch(streams: Sequence[bytes], sample_rate_hz: int, bitrate: int,
                 model_path: str = config.DEFAULT_MODEL_PATH,
                 compute: str = "float", seed: int = 0, *, device=None
                 ) -> List[np.ndarray]:
    """Decode many `.lyra` byte streams (one bitrate) → int16 samples each."""
    num_bits = config.bitrate_to_num_quantized_bits(bitrate)
    packet_size = config.bitrate_to_packet_size(bitrate)
    hop = config.num_samples_per_hop(sample_rate_hz)

    split: List[np.ndarray] = []
    hops = []
    for s in streams:
        if len(s) % packet_size:
            log.warning("Trimming %d trailing bytes not forming a whole "
                        "packet.", len(s) % packet_size)
            s = s[: len(s) - len(s) % packet_size]
        arr = np.frombuffer(s, np.uint8).reshape(-1, packet_size)
        split.append(arr)
        hops.append(arr.shape[0])
    n = max(hops) if hops else 0

    dec = DecoderEngine(sample_rate_hz, model_path, mode=compute,
                        max_bitrate=bitrate, device=device)
    state = dec.init_state(len(streams), seed=seed)
    num_stages = dec.rvq.num_stages
    outs = [np.zeros((h * hop,), np.int16) for h in hops]
    start = time.monotonic()
    for t in range(n):
        pkts = np.zeros((len(streams), packet_size), np.uint8)
        received = np.zeros((len(streams),), bool)
        for i, arr in enumerate(split):
            if t < arr.shape[0]:
                pkts[i] = arr[t]
                received[i] = True
        idx = packet.unpack_indices_batch(pkts, num_bits)
        padded = np.full((len(streams), num_stages), -1, np.int32)
        padded[:, : idx.shape[1]] = idx
        audio, _, state = dec.step(state, padded, received)
        audio = audio.cpu().numpy()
        for i, h in enumerate(hops):
            if t < h:
                outs[i][t * hop : (t + 1) * hop] = audio[i].astype(np.int16)
    _log_rate(start, sum(hops) * hop)
    return outs


def _log_rate(start: float, total_samples: int) -> None:
    elapsed = time.monotonic() - start
    if elapsed > 0:
        log.info("Samples per second : %.1f", total_samples / elapsed)


def _group_by_rate(paths: Sequence[str]) -> Dict[int, List[Tuple[str, np.ndarray]]]:
    groups: Dict[int, List[Tuple[str, np.ndarray]]] = {}
    for p in paths:
        try:
            data = wav.read_wav_int16(p)
        except (OSError, ValueError, EOFError) as e:
            log.error("Could not read %s: %s", p, e)
            continue
        if (not config.is_sample_rate_supported(data.sample_rate_hz)
                or data.num_channels != config.NUM_CHANNELS):
            log.error("Unsupported rate/channels in %s; skipping.", p)
            continue
        groups.setdefault(data.sample_rate_hz, []).append((p, data.samples))
    return groups


def _output_stems(paths: Sequence[str]) -> Dict[str, str]:
    """Unique output stem per input path.

    Basename stems alone would let data/spk1/utt.wav and data/spk2/utt.wav
    silently clobber each other's outputs; colliding stems are
    disambiguated by prefixing parent-directory components until unique.
    """
    stems = {p: os.path.splitext(os.path.basename(p))[0] for p in paths}
    depth = 1
    while True:
        counts: Dict[str, int] = {}
        for s in stems.values():
            counts[s] = counts.get(s, 0) + 1
        dupes = [p for p, s in stems.items() if counts[s] > 1]
        if not dupes:
            return stems
        for p in dupes:
            parts = os.path.normpath(os.path.abspath(p)).split(os.sep)
            # basename + `depth` parent components, joined with "_".
            take = parts[max(0, len(parts) - 1 - depth): -1]
            stem = "_".join([c for c in take if c] +
                            [os.path.splitext(parts[-1])[0]])
            stems[p] = stem
        depth += 1
        if depth > 64:  # identical paths can't happen (glob is a set)
            raise ValueError(f"cannot disambiguate output names: {dupes}")


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input_glob", required=True,
                    help="glob of input .wav (encode/transcode) or .lyra "
                         "(decode) files")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--bitrate", type=int, default=3200,
                    choices=config.SUPPORTED_BITRATES)
    ap.add_argument("--mode", default="transcode",
                    choices=("encode", "decode", "transcode"))
    ap.add_argument("--compute", default="float", choices=("float", "bf16"))
    ap.add_argument("--enable_dtx", action="store_true")
    ap.add_argument("--sample_rate", type=int, default=16000,
                    help="output rate for --mode=decode (.lyra has no header)")
    ap.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH)
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(args.input_glob))
    if not paths:
        log.error("No inputs match %s", args.input_glob)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    native.build()  # compile the wire codec now, not mid-batch
    stems = _output_stems(paths)

    if args.mode == "decode":
        streams, ok_paths = [], []
        for p in paths:
            try:
                with open(p, "rb") as f:
                    streams.append(f.read())
                ok_paths.append(p)
            except OSError as e:
                # Same skip-and-report contract as the encode modes.
                log.error("Could not read %s: %s", p, e)
        if not streams:
            return 1
        outs = decode_batch(streams, args.sample_rate, args.bitrate,
                            args.model_path, compute=args.compute,
                            device=device)
        for p, samples in zip(ok_paths, outs):
            wav.write_wav_int16(
                os.path.join(args.output_dir, f"{stems[p]}_decoded.wav"),
                samples, args.sample_rate, 1)
        return 0 if len(ok_paths) == len(paths) else 1

    groups = _group_by_rate(paths)
    processed = sum(len(items) for items in groups.values())
    for rate, items in sorted(groups.items()):
        waves = [s for _, s in items]
        encoded = encode_batch(waves, rate, args.bitrate, args.model_path,
                               enable_dtx=args.enable_dtx,
                               compute=args.compute, device=device)
        if args.mode == "encode":
            for (p, _), enc_bytes in zip(items, encoded):
                with open(os.path.join(args.output_dir, f"{stems[p]}.lyra"),
                          "wb") as f:
                    f.write(enc_bytes)
        else:  # transcode
            outs = decode_batch(encoded, rate, args.bitrate, args.model_path,
                                compute=args.compute, device=device)
            for (p, _), samples in zip(items, outs):
                wav.write_wav_int16(
                    os.path.join(args.output_dir, f"{stems[p]}_decoded.wav"),
                    samples, rate, 1)
    # Unreadable/unsupported inputs were logged and skipped; surface them in
    # the exit code so batch pipelines notice.
    return 0 if processed == len(paths) else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
