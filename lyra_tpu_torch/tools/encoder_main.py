"""Encoder CLI (reference: lyra/cli_example/encoder_main.cc) — port of
lyra_tpu/tools/encoder_main.py, the same flags.  The codec runs on the card
(`main(argv, device=...)` names another device); the model directory is
--model_path or LYRA_TPU_MODEL_PATH.

Usage:
    python -m lyra_tpu_torch.tools.encoder_main --input_path=a.wav \
        --output_dir=/tmp/out --bitrate=3200 [--enable_dtx] \
        [--enable_preprocessing] [--model_path=DIR]

Writes `<output_dir>/<stem>.lyra` — the concatenated packet stream.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from lyra_tpu_torch import config
from lyra_tpu_torch.tools import cli_lib


def main(argv=None, *, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_path", required=True,
                   help="Complete path to the WAV file to be encoded.")
    p.add_argument("--output_dir", required=True,
                   help="Output dir for the encoded file (created if missing).")
    p.add_argument("--bitrate", type=int, default=3200,
                   help="Bitrate in bps: 3200, 6000 or 9200.")
    p.add_argument("--enable_preprocessing", action="store_true")
    p.add_argument("--enable_dtx", action="store_true",
                   help="Skip packets when noise is detected (DTX).")
    p.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH,
                   help="Directory containing the model weights.")
    args = p.parse_args(argv)

    from lyra_tpu_torch.utils import native
    native.build()  # compile the wire codec up front, not mid-encode
    os.makedirs(args.output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.input_path))[0]
    output_path = os.path.join(args.output_dir, stem + ".lyra")
    ok = cli_lib.encode_file(args.input_path, output_path, args.bitrate,
                             args.enable_preprocessing, args.enable_dtx,
                             args.model_path, device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
