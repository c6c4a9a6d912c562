"""Codec core: reference-parity facades and the batched lockstep engines."""

from lyra_tpu_torch.codec.decoder import LyraDecoder
from lyra_tpu_torch.codec.encoder import LyraEncoder
from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine

__all__ = ["LyraDecoder", "LyraEncoder", "DecoderEngine", "EncoderEngine"]
