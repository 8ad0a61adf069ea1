"""Self-calibrating bytes-per-token estimation (paper §2.1, Eq. 4–5).

Counterpart of the host-side ``EmaCalibrator`` in
``repro.core.calibration``; the batch (``CalibState``) kernels belong to the
fleet-simulator slice of the port.

Update rule (Eq. 4), per category k::

    c_obs = |r| / usage.prompt_tokens
    ĉ_k   ← β ĉ_k + (1-β) c_obs
    σ̂_k   ← β σ̂_k + (1-β) |c_obs − ĉ_k|

Conservative routing estimate (Eq. 5)::

    ĉ_k^route = ĉ_k − γ σ̂_k
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.categories import COLD_START_RATIO, NUM_CATEGORIES

DEFAULT_BETA = 0.95
DEFAULT_GAMMA = 1.0
_MIN_RATIO = 0.25  # bytes/token can't go below 1 byte / 4 tokens in practice


@dataclasses.dataclass
class EmaCalibrator:
    """Host-side per-category EMA calibrator (production dispatch path)."""

    num_categories: int = NUM_CATEGORIES
    beta: float = DEFAULT_BETA
    gamma: float = DEFAULT_GAMMA
    c0: float = COLD_START_RATIO

    def __post_init__(self) -> None:
        self.ratio = [self.c0] * self.num_categories
        self.sigma = [0.0] * self.num_categories
        self.count = [0] * self.num_categories

    # -- estimation ---------------------------------------------------------
    def conservative_ratio(self, category: int) -> float:
        """ĉ_k − γ σ̂_k, floored to a sane minimum (Eq. 5)."""
        c = self.ratio[category] - self.gamma * self.sigma[category]
        return max(c, _MIN_RATIO)

    def estimate_input_tokens(self, byte_len: int, category: int) -> int:
        """L_in = ceil(|r| / ĉ_k^route) (Eq. 3, input term)."""
        return math.ceil(byte_len / self.conservative_ratio(category))

    def estimate_total_budget(
        self, byte_len: int, max_output_tokens: int, category: int
    ) -> int:
        """L_total = L_in + L_out (Eq. 3)."""
        return self.estimate_input_tokens(byte_len, category) + max_output_tokens

    # -- feedback -----------------------------------------------------------
    def observe(self, byte_len: int, prompt_tokens: int, category: int) -> float:
        """OnResponse (Algorithm 1 lines 15–19). Returns c_obs.

        The first observation replaces the cold-start prior outright.
        """
        if prompt_tokens <= 0:
            return self.ratio[category]
        c_obs = byte_len / prompt_tokens
        b = self.beta if self.count[category] > 0 else 0.0
        self.ratio[category] = b * self.ratio[category] + (1.0 - b) * c_obs
        dev = abs(c_obs - self.ratio[category])
        self.sigma[category] = b * self.sigma[category] + (1.0 - b) * dev
        self.count[category] += 1
        return c_obs

    def snapshot(self) -> dict:
        return {
            "ratio": list(self.ratio),
            "sigma": list(self.sigma),
            "count": list(self.count),
        }
