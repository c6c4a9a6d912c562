"""Decoder CLI (reference: lyra/cli_example/decoder_main.cc) — port of
lyra_tpu/tools/decoder_main.py, the same flags.  The codec runs on the card
(`main(argv, device=...)` names another device); the model directory is
--model_path or LYRA_TPU_MODEL_PATH.

Usage:
    python -m lyra_tpu_torch.tools.decoder_main --encoded_path=a.lyra \
        --output_dir=/tmp/out [--sample_rate_hz=16000] [--bitrate=3200] \
        [--packet_loss_rate=0.1 --average_burst_length=2] \
        [--fixed_packet_loss_pattern=0.5,1.5:0.2,0.2] \
        [--randomize_num_samples_requested] [--model_path=DIR]

Writes `<output_dir>/<stem><suffix>.wav`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from lyra_tpu_torch import config
from lyra_tpu_torch.tools import cli_lib
from lyra_tpu_torch.tools.packet_loss import PacketLossPattern


def main(argv=None, *, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--encoded_path", required=True,
                   help="Path to the .lyra packet stream to decode.")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_suffix", default="_decoded")
    p.add_argument("--sample_rate_hz", type=int, default=16000)
    p.add_argument("--bitrate", type=int, default=3200,
                   help="Bitrate the file was encoded at (sets packet size).")
    p.add_argument("--randomize_num_samples_requested", action="store_true",
                   help="Request random sample counts within each hop.")
    p.add_argument("--packet_loss_rate", type=float, default=0.0)
    p.add_argument("--average_burst_length", type=float, default=1.0)
    p.add_argument("--fixed_packet_loss_pattern", type=PacketLossPattern.parse,
                   default=PacketLossPattern([], []),
                   help="starts:durations in seconds, e.g. '0.5,1.5:0.2,0.2'. "
                        "Overrides the Gilbert model flags when non-empty.")
    p.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH)
    args = p.parse_args(argv)

    from lyra_tpu_torch.utils import native
    native.build()  # compile the wire codec up front, not mid-decode
    os.makedirs(args.output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.encoded_path))[0]
    output_path = os.path.join(args.output_dir,
                               stem + args.output_suffix + ".wav")
    ok = cli_lib.decode_file(
        args.encoded_path, output_path, args.sample_rate_hz, args.bitrate,
        args.randomize_num_samples_requested, args.packet_loss_rate,
        args.average_burst_length, args.fixed_packet_loss_pattern,
        args.model_path, device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
