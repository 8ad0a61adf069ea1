"""Self-calibrating bytes-per-token estimation (paper §2.1, Eq. 4–5).

Counterpart of ``repro.core.calibration``: the host-side
:class:`EmaCalibrator` and the batch functions on a :class:`CalibState` of
plain tensors (``update``, ``update_stream``, ``estimate_budget``), the
counterparts of the reference's ``jax_update``, ``jax_update_stream`` /
``_update_stream_kernel`` and ``jax_estimate_budget``. The batch functions
are float32 in the reference's op order, with the fused multiply-adds that
XLA contracts in its compiled fold and estimate (see
:mod:`repro_torch.core.fma`), so they are bit-identical to the compiled
reference.

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
from typing import NamedTuple

import torch

from repro_torch.core.categories import COLD_START_RATIO, NUM_CATEGORIES
from repro_torch.core.fma import fma32

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

    # -- batch feedback (vectorized simulator / trace re-routing) -----------
    def to_state(self) -> "CalibState":
        """Export the scalar EMA state as a float32 :class:`CalibState`."""
        return CalibState(
            ratio=torch.tensor(self.ratio, dtype=torch.float32),
            sigma=torch.tensor(self.sigma, dtype=torch.float32),
            count=torch.tensor(self.count, dtype=torch.int32),
        )

    def load_state(self, state: "CalibState") -> None:
        """Sync the scalar state back from a :class:`CalibState`."""
        self.ratio = [float(x) for x in state.ratio.tolist()]
        self.sigma = [float(x) for x in state.sigma.tolist()]
        self.count = [int(x) for x in state.count.tolist()]

    def observe_batch(self, byte_lens, prompt_tokens, categories) -> None:
        """Fold a whole observation stream through the EMA (Eq. 4) at once
        with :func:`update_stream`, then sync the scalar state back.

        The reference pads the stream to a fixed chunk so JAX compiles its
        scan once; rows with ``prompt_tokens=0`` are skipped by the fold, so
        the unpadded stream lands on the same state.
        """
        if len(byte_lens) == 0:
            return
        state = update_stream(
            self.to_state(),
            torch.as_tensor(byte_lens).to(torch.float32),
            torch.as_tensor(prompt_tokens).to(torch.float32),
            torch.as_tensor(categories).to(torch.int32),
            beta=float(self.beta),
        )
        self.load_state(state)


# ---------------------------------------------------------------------------
# Batch functions on plain tensors (vectorized studies / fused batch routing)
# ---------------------------------------------------------------------------


class CalibState(NamedTuple):
    """Per-category EMA state (counterpart of the reference's pytree)."""

    ratio: torch.Tensor  # (K,) float32 — ĉ_k
    sigma: torch.Tensor  # (K,) float32 — σ̂_k
    count: torch.Tensor  # (K,) int32


def init_state(
    num_categories: int = NUM_CATEGORIES, c0: float = COLD_START_RATIO
) -> CalibState:
    return CalibState(
        ratio=torch.full((num_categories,), c0, dtype=torch.float32),
        sigma=torch.zeros((num_categories,), dtype=torch.float32),
        count=torch.zeros((num_categories,), dtype=torch.int32),
    )


def update(
    state: CalibState,
    byte_len: torch.Tensor,
    prompt_tokens: torch.Tensor,
    category: torch.Tensor,
    *,
    beta: float = DEFAULT_BETA,
) -> CalibState:
    """One EMA update (Eq. 4) for a single observation (0-d tensors);
    counterpart of ``jax_update``. Returns a new state."""
    return update_stream(
        state,
        torch.as_tensor(byte_len).reshape(1),
        torch.as_tensor(prompt_tokens).reshape(1),
        torch.as_tensor(category).reshape(1),
        beta=beta,
    )


def update_stream(
    state: CalibState,
    byte_lens: torch.Tensor,
    prompt_tokens: torch.Tensor,
    categories: torch.Tensor,
    *,
    beta: float = DEFAULT_BETA,
) -> CalibState:
    """Fold a whole observation stream through the EMA, in order: the
    counterpart of ``jax_update_stream`` / ``_update_stream_kernel`` (a
    ``lax.scan`` of ``jax_update``), as a sequential float32 fold on CPU
    tensors. Returns a new state.

    Per valid row (``prompt_tokens > 0``; other rows change nothing) with
    ``c_obs = |r| / max(tokens, 1)`` and blend factor ``b`` (0 while the
    category's count is 0, so the first observation replaces the prior,
    ratio and sigma alike; β after)::

        ratio_k <- fma(b, ratio_k, (1 - b) * c_obs)
        sigma_k <- fma(b, sigma_k, (1 - b) * |c_obs - ratio_k|)

    which is ``b * x + (1 - b) * y`` with the first product fused into the
    add, as XLA contracts it in the compiled scan. Everything that does not
    depend on the carried ratio and sigma is computed for all rows at once.
    """
    f32 = torch.float32
    cats = categories.to(torch.int64)
    p = prompt_tokens.to(f32)
    valid = p > 0
    c_obs = byte_lens.to(f32) / torch.clamp(p, min=1.0)
    # b is 0 on each category's first valid row while its count is 0.
    k_valid = torch.where(valid, cats, -1)
    seen = torch.zeros(len(cats), dtype=torch.bool)
    for k in range(len(state.count)):
        rows = torch.nonzero(k_valid == k).flatten()
        if len(rows) and int(state.count[k]) == 0:
            seen[rows[0]] = True
    b = torch.where(seen, torch.zeros((), dtype=f32), torch.tensor(beta, dtype=f32))
    omb = 1.0 - b
    x = omb * c_obs
    ratio = list(state.ratio.clone().unbind(0))
    sigma = list(state.sigma.clone().unbind(0))
    rows = zip(
        cats.tolist(), valid.tolist(), b.unbind(0), omb.unbind(0),
        x.unbind(0), c_obs.unbind(0),
    )
    for k, ok, b_i, omb_i, x_i, c_i in rows:
        if ok:
            r = fma32(b_i, ratio[k], x_i)
            sigma[k] = fma32(b_i, sigma[k], omb_i * torch.abs(c_i - r))
            ratio[k] = r
    count = state.count + torch.bincount(
        cats[valid], minlength=len(state.count)
    ).to(torch.int32)
    return CalibState(
        ratio=torch.stack(ratio), sigma=torch.stack(sigma), count=count
    )


def conservative_ratio(
    state: CalibState, *, gamma: float = DEFAULT_GAMMA
) -> torch.Tensor:
    """(K,) vector of ĉ_k^route = max(ĉ_k − γ σ̂_k, floor) (Eq. 5),
    ``ĉ_k − γ σ̂_k`` rounded once as XLA's contraction does; counterpart
    of ``jax_conservative_ratio``."""
    g = torch.tensor(-gamma, dtype=torch.float32)
    return torch.clamp(fma32(g, state.sigma, state.ratio), min=_MIN_RATIO)


def estimate_budget(
    state: CalibState,
    byte_lens: torch.Tensor,
    max_output_tokens: torch.Tensor,
    categories: torch.Tensor,
    *,
    gamma: float = DEFAULT_GAMMA,
) -> torch.Tensor:
    """Vectorized Eq. 3 over a batch of requests → (N,) int32 L_total;
    counterpart of ``jax_estimate_budget`` (float32 L_in estimate)."""
    c_route = conservative_ratio(state, gamma=gamma)[categories.long()]
    l_in = torch.ceil(byte_lens.to(torch.float32) / c_route).to(torch.int32)
    return l_in + max_output_tokens.to(torch.int32)
