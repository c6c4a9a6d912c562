# Frozen copy of the constants of lyra_tpu_torch/config.py at commit
# d33c86f8529266b8cfd7b29e220ae5f0401d98aa that the benchmark's plain reference needs.
"""Lyra v2 codec constants (the reference's own copy)."""

NUM_FEATURES = 64  # learned SoundStream features per 20 ms frame
NUM_MEL_BINS = 160  # log-mel bins used by noise estimator / CNG
OVERLAP_FACTOR = 2
FRAME_RATE = 50  # frames (packets) per second
INTERNAL_SAMPLE_RATE = 16000
BITS_PER_QUANTIZER = 4


def num_samples_per_hop(sample_rate_hz: int) -> int:
    """Samples in one 20 ms hop at `sample_rate_hz` (must divide evenly)."""
    if sample_rate_hz % FRAME_RATE != 0:
        raise ValueError(f"sample rate {sample_rate_hz} not divisible by {FRAME_RATE}")
    return sample_rate_hz // FRAME_RATE
