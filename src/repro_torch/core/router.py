"""Token-budget pool dispatch (paper §2.2, Algorithm 1), N-pool form.

Counterpart of ``repro.core.router``. The router never needs a tokenizer:
the byte length |r| plus the calibrated per-category ratio gives the
input-token estimate, and the request's own ``max_output_tokens`` cap gives
the output term.

Two paths:

* :class:`TokenBudgetRouter` — host-side production dispatch (scalar).
* :func:`route_batch` — routing of a whole request batch on tensors (the
  counterpart of ``jax_route_batch``), used by the vectorized fleet
  simulator; :func:`pool_ids` is the threshold search it shares with the
  torch DES tier's in-loop dispatch.
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.calibration import (
    DEFAULT_GAMMA,
    CalibState,
    EmaCalibrator,
    estimate_budget,
)
from repro_torch.core.pools import PoolSet, PoolState


@dataclasses.dataclass(frozen=True)
class Request:
    """A routing-layer view of one inference request."""

    request_id: int
    byte_len: int  # |r|: prompt byte length (observable pre-tokenization)
    max_output_tokens: int  # L_out cap from the API request
    category: int  # traffic category k
    arrival_time: float = 0.0
    # Ground truth, known only to the simulator/engine (never to the router):
    true_input_tokens: int = -1
    true_output_tokens: int = -1

    @property
    def true_total(self) -> int:
        return self.true_input_tokens + self.true_output_tokens


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    pool: str
    estimated_total: int
    spilled: bool
    conservative_ratio: float
    pool_index: int = -1  # index into the budget-ordered PoolSet


class TokenBudgetRouter:
    """Algorithm 1: token-budget pool dispatch with closed-loop calibration.

    Routes over a budget-ordered :class:`~repro_torch.core.pools.PoolSet`:
    the static target is a threshold search, the hard constraint escalates
    to the nearest feasible pool, and load-aware spillover redirects to the
    nearest non-overloaded pool that admits the budget. The two-pool
    ``(short, long, b_short=…)`` form builds the equivalent P=2 PoolSet.
    """

    def __init__(
        self,
        short: Optional[PoolState] = None,
        long: Optional[PoolState] = None,
        *,
        pools: Optional[PoolSet] = None,
        b_short: int = 8192,
        calibrator: Optional[EmaCalibrator] = None,
        spillover: bool = True,
    ) -> None:
        if pools is not None:
            if short is not None or long is not None:
                raise ValueError("pass either (short, long) or pools=, not both")
            self.pools = pools
        else:
            if short is None or long is None:
                raise ValueError("need a PoolSet or a (short, long) pool pair")
            if short.config.c_max > long.config.c_max:
                raise ValueError("short pool must have the smaller C_max")
            if b_short > short.config.c_max:
                raise ValueError(
                    f"B_short={b_short} exceeds short-pool C_max={short.config.c_max}"
                )
            self.pools = PoolSet([short, long], [b_short])
        self.calibrator = calibrator or EmaCalibrator()
        self.spillover = spillover
        self.routed = {name: 0 for name in self.pools.names}
        self.spill_count = 0
        # `_th` aliases the PoolSet's live threshold list, so threshold moves
        # stay visible to route().
        self._th = self.pools._thresholds
        self._states = self.pools.states
        self._names = self.pools.names

    # -- dispatch (Algorithm 1 lines 1–14) ----------------------------------
    def route(
        self, request: Request, blocked: Optional[frozenset] = None
    ) -> RouteDecision:
        """Eq. 3/5 budget estimate, threshold search, then the
        load-dependent tail when the target is blocked or overloaded."""
        c_star = self.calibrator.conservative_ratio(request.category)
        l_total = math.ceil(request.byte_len / c_star) + request.max_output_tokens
        idx = bisect_left(self._th, l_total)
        spilled = False
        state = self._states[idx]
        if (blocked is not None and idx in blocked) or (
            self.spillover
            and state.queue_depth > state.config.queue_limit * state.num_instances
        ):
            idx, spilled = self._finalize(idx, l_total, blocked)
        name = self._names[idx]
        self.routed[name] += 1
        return RouteDecision(name, l_total, spilled, c_star, pool_index=idx)

    def _finalize(
        self, idx: int, budget: int, blocked: Optional[frozenset] = None
    ) -> tuple[int, bool]:
        """Load-dependent tail of Algorithm 1 (lines 8–14), N-pool form:
        hard-constraint escalation, then spillover to the nearest healthy,
        non-overloaded pool that admits the budget; otherwise the request
        stays on its target."""
        idx = self.pools.first_feasible(idx, budget)
        unhealthy = blocked is not None and idx in blocked
        if not (unhealthy or (self.spillover and self.pools.states[idx].overloaded)):
            return idx, False
        for k in self.pools.spill_order(idx):
            if blocked is not None and k in blocked:
                continue
            alt = self.pools.states[k]
            if not alt.overloaded and alt.config.admits(budget):
                self.spill_count += 1
                return k, True
        return idx, False

    # -- feedback (Algorithm 1 lines 15–19) ---------------------------------
    def on_response(self, request: Request, prompt_tokens: int) -> None:
        self.calibrator.observe(request.byte_len, prompt_tokens, request.category)

    def on_response_batch(self, byte_lens, prompt_tokens, categories) -> None:
        """Epoch-batched feedback: fold many responses through the EMA at
        once (vectorized fleet backend / trace re-simulation)."""
        self.calibrator.observe_batch(byte_lens, prompt_tokens, categories)

    def route_decided(
        self, pool_id: int, budget: int, blocked: Optional[frozenset] = None
    ) -> str:
        """Finalize one batched decision against live pool state: the
        load-dependent tail of Algorithm 1 (hard-constraint escalation and
        spillover) for a static pool index from :meth:`route_batch`,
        updating the routed/spill counters like :meth:`route`. Returns the
        target pool name."""
        idx, _ = self._finalize(int(pool_id), int(budget), blocked)
        name = self.pools.names[idx]
        self.routed[name] += 1
        return name

    # -- batch dispatch (vectorized fleet backend) ---------------------------
    def route_batch(self, byte_lens, max_output_tokens, categories):
        """Route a whole arrival batch with :func:`route_batch`.

        Returns ``(pool_ids, budgets)`` as NumPy int32 arrays of length
        ``len(byte_lens)``; pool ids index the budget-ordered PoolSet
        (0 = smallest budget). The static decision uses the calibrator
        state as of the call; spillover and the routed/spill counters stay
        with the caller (:meth:`route_decided`). The reference pads the
        batch to a power of two for JAX's shape cache and slices the pad
        rows off; eager PyTorch needs no padding, so no pad row can reach
        the counters or the EMA feedback.
        """
        pools, budgets = route_batch(
            self.calibrator.to_state(),
            torch.as_tensor(np.asarray(byte_lens)).to(torch.int32),
            torch.as_tensor(np.asarray(max_output_tokens)).to(torch.int32),
            torch.as_tensor(np.asarray(categories)).to(torch.int32),
            thresholds=self.pools.thresholds,
            gamma=self.calibrator.gamma,
        )
        return pools.numpy(), budgets.numpy()

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        total = max(1, sum(self.routed.values()))
        out = {
            "routed": dict(self.routed),
            "fractions": {n: c / total for n, c in self.routed.items()},
            "spill_count": self.spill_count,
            "calibration": self.calibrator.snapshot(),
            "thresholds": [int(b) for b in self._th],
        }
        if len(self.pools) == 2:
            first, last = self.pools.names[0], self.pools.names[-1]
            out["routed_short"] = self.routed[first]
            out["routed_long"] = self.routed[last]
            out["short_fraction"] = self.routed[first] / total
        return out


# ---------------------------------------------------------------------------
# Batch routing on tensors
# ---------------------------------------------------------------------------

def pool_ids(thresholds: torch.Tensor, budgets: torch.Tensor) -> torch.Tensor:
    """Budget → pool-index dispatch: ``searchsorted`` over ``B_1 < … <
    B_{P-1}`` (Algorithm 1's static threshold search, left side), int32 ids
    into the budget-ordered pool family. Counterpart of ``jax_pool_ids``;
    shared by :func:`route_batch` and the torch DES tier's dispatch."""
    return torch.searchsorted(thresholds, budgets, right=False).to(torch.int32)


def route_batch(
    state: CalibState,
    byte_lens: torch.Tensor,
    max_output_tokens: torch.Tensor,
    categories: torch.Tensor,
    *,
    thresholds: Optional[Sequence[int]] = None,
    short_cmax: int = 8192,
    b_short: int = 8192,
    gamma: float = DEFAULT_GAMMA,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route a whole batch at once. Returns (pool_ids, estimated_budgets),
    both int32; counterpart of ``jax_route_batch``.

    The budget is Eq. 3 with the float32 L_in estimate of
    :func:`repro_torch.core.calibration.estimate_budget`; pool ids are
    ``searchsorted`` over ``thresholds`` (default: the two-pool boundary
    ``min(b_short, short_cmax)``). Spillover is a load-dependent runtime
    concern and is not part of the static decision.
    """
    if thresholds is None:
        thresholds = [min(b_short, short_cmax)]
    th = torch.as_tensor(np.asarray(thresholds, dtype=np.int32))
    budgets = estimate_budget(
        state, byte_lens, max_output_tokens, categories, gamma=gamma
    )
    return pool_ids(th, budgets), budgets
