"""Feature estimators: conditioning features for packet-loss concealment.

Port of lyra_tpu/codec/feature_estimator.py.  An estimator is a trio of
functions over a `[B, num_features]` state tensor.
"""

from __future__ import annotations

import torch

from lyra_tpu_torch import config
from lyra_tpu_torch.utils.device import resolve


class ZeroFeatureEstimator:
    """Estimate() == zeros; Update() is ignored (the reference's estimator)."""

    def __init__(self, num_features: int = config.NUM_FEATURES, device=None):
        self.num_features = num_features
        self.device = resolve(device)

    def init_state(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((batch_size, self.num_features),
                           dtype=torch.float32, device=self.device)

    def update(self, state: torch.Tensor, features: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        del features, mask
        return state

    def estimate(self, state: torch.Tensor) -> torch.Tensor:
        return state


class LastFrameFeatureEstimator(ZeroFeatureEstimator):
    """Repeats the last received frame's features during concealment."""

    def update(self, state, features, mask):
        return torch.where(mask[:, None], features, state)


class DecayingFeatureEstimator(ZeroFeatureEstimator):
    """Geometrically fades the last received features during concealment."""

    def __init__(self, decay: float = 0.6,
                 num_features: int = config.NUM_FEATURES, device=None):
        super().__init__(num_features, device)
        self.decay = float(decay)

    def update(self, state, features, mask):
        return torch.where(mask[:, None], features, state * self.decay)
