"""Token-budget pool dispatch (paper §2.2, Algorithm 1), N-pool form.

Counterpart of the host-side router in ``repro.core.router``. The router
never needs a tokenizer: the byte length |r| plus the calibrated
per-category ratio gives the input-token estimate, and the request's own
``max_output_tokens`` cap gives the output term. The batch routing kernels
belong to the fleet-simulator slice of the port.
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left
from typing import Optional

from repro_torch.core.calibration import EmaCalibrator
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
