"""Reusable test doubles (reference: lyra/testing/ gmock mocks + fake).

The reference ships gmock mocks for every interface plus a
FakeGenerativeModel that returns constant samples while exercising the real
queue/cursor logic (reference: lyra/testing/mock_generative_model.h:33-50).
The functional analogs here are fake hop functions and stub components that
plug into the same seams (HopGenerator hop_fn, estimator/noise objects).
"""

from lyra_tpu_torch.testing.fakes import (
    ConstantHopFn,
    FakeNoiseEstimator,
    FakeRvq,
    make_fake_decoder,
)

__all__ = [
    "ConstantHopFn",
    "FakeNoiseEstimator",
    "FakeRvq",
    "make_fake_decoder",
]
