"""Pool configuration and fleet sizing (paper §2, §3, Table 1).

A *pool* is a set of identically-configured serving instances. The paper's
two-pool design (§8: "start with two pools") is the P=2 member of the
budget-ordered pool family modelled by :class:`PoolSet`: P pools sorted by
``C_max`` with routing thresholds ``B_1 < … < B_{P-1}``. The router, both
simulator backends, and the three-pool ablation all operate on a PoolSet.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Sequence

import numpy as np

#: vLLM-style fixed KV block size in tokens (paper §3, effect 3 / Appendix A).
KV_BLOCK_TOKENS = 16

#: Total KV block budget per instance used by the paper's dynamic pool
#: configuration (Appendix A): N_seq = min(128, floor(65536 / ceil(C_max/16))).
TOTAL_KV_BLOCKS = 65_536


def n_seq_for_cmax(
    c_max: int, *, max_slots: int = 128, total_blocks: int = TOTAL_KV_BLOCKS
) -> int:
    """Sequence slots for a given C_max under the fixed block budget.

    Paper Appendix A: ``N_seq = min(128, floor(65536 / ceil(B_short/16)))``.
    ``total_blocks`` scales with KV bytes/token (int8 KV doubles it).
    """
    blocks_per_seq = math.ceil(c_max / KV_BLOCK_TOKENS)
    return max(1, min(max_slots, total_blocks // blocks_per_seq))


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static configuration of one pool."""

    name: str
    c_max: int  # max_model_len for every instance in the pool
    n_seq: int  # concurrent sequence slots per instance
    batch_token_budget: int = 8192  # B_batch: max batched tokens per iteration
    queue_limit: int = 256  # spillover trigger: pending requests per instance
    headroom: float = 1.05  # β queuing-headroom factor for fleet sizing

    def admits(self, l_total: int) -> bool:
        """Hard constraint: can this pool ever serve a request of L_total?"""
        return l_total <= self.c_max


def short_pool(
    c_max: int = 8192, *, name: str = "short", headroom: float = 1.05
) -> PoolConfig:
    """The high-throughput short pool P_s (Table 1 row 2)."""
    return PoolConfig(
        name=name,
        c_max=c_max,
        n_seq=n_seq_for_cmax(c_max),
        batch_token_budget=16_384,
        headroom=headroom,
    )


def long_pool(
    c_max: int = 65_536, *, name: str = "long", headroom: float = 1.02
) -> PoolConfig:
    """The high-capacity long pool P_l (Table 1 row 3)."""
    return PoolConfig(
        name=name,
        c_max=c_max,
        n_seq=n_seq_for_cmax(c_max, max_slots=16),
        batch_token_budget=8192,
        headroom=headroom,
    )


def homogeneous_pool(c_max: int = 65_536, *, headroom: float = 1.08) -> PoolConfig:
    """Baseline: every instance provisioned for the worst case (Table 1 row 1)."""
    return PoolConfig(
        name="homogeneous",
        c_max=c_max,
        n_seq=n_seq_for_cmax(c_max, max_slots=16),
        batch_token_budget=8192,
        headroom=headroom,
    )


@dataclasses.dataclass
class PoolState:
    """Mutable per-pool dispatch state visible to the router (O(1) reads)."""

    config: PoolConfig
    num_instances: int = 1
    queue_depth: int = 0  # requests waiting across the pool
    active: int = 0  # requests currently being served

    @property
    def overloaded(self) -> bool:
        # Inlined in TokenBudgetRouter.route()'s spill pre-check (the
        # sub-µs dispatch path) — change both together.
        return self.queue_depth > self.config.queue_limit * self.num_instances

    @property
    def utilization_slots(self) -> float:
        cap = max(1, self.num_instances * self.config.n_seq)
        return self.active / cap


class PoolSet:
    """Budget-ordered pools ``P_1 … P_P`` with thresholds ``B_1 < … < B_{P-1}``.

    The routing rule of Algorithm 1, generalized to N pools: a request with
    estimated budget ``L`` statically targets the first pool ``k`` with
    ``L ≤ B_k`` (the last pool when ``L`` exceeds every threshold). Each
    threshold is bounded by its pool's context window (``B_k ≤ C_max,k``),
    so a static target below the last pool always admits the request.

    Pools are sorted by ``C_max`` at construction (stable, so equal-capacity
    pools keep caller order); ``thresholds`` stays a mutable array because
    the adaptive controller moves boundaries at runtime
    (:class:`repro_torch.core.adaptive.AdaptiveController`).
    """

    def __init__(
        self, states: Sequence["PoolState"], thresholds: Sequence[int]
    ) -> None:
        states = list(states)
        validate_pools([s.config for s in states])
        order = sorted(range(len(states)), key=lambda i: states[i].config.c_max)
        self.states: list[PoolState] = [states[i] for i in order]
        self.configs: list[PoolConfig] = [s.config for s in self.states]
        self.names: list[str] = [c.name for c in self.configs]
        if len(thresholds) != len(states) - 1:
            raise ValueError(
                f"{len(states)} pools need {len(states) - 1} thresholds, "
                f"got {len(thresholds)}"
            )
        # Plain int list for the O(1)/O(log P) scalar dispatch hot path
        # (bisect beats an np.searchsorted call by ~5× per request);
        # `thresholds` exposes the same values as an array for the batch
        # kernel and stays the mutation point for adaptive control.
        self._thresholds = [int(b) for b in thresholds]
        self._validate_thresholds()
        # Spillover candidate order per target pool, precomputed: by
        # distance from the target, larger-capacity neighbour preferred on
        # ties — the safer direction under the paper's asymmetric error
        # costs.
        p = len(self.states)
        self._spill_orders = [
            sorted(
                (k for k in range(p) if k != idx),
                key=lambda k: (abs(k - idx), -k),
            )
            for idx in range(p)
        ]

    def _validate_thresholds(self) -> None:
        th = self._thresholds
        if th and th[0] <= 0:
            raise ValueError(f"thresholds must be positive: {th}")
        if any(nxt <= prev for nxt, prev in zip(th[1:], th)):
            raise ValueError(f"thresholds must be strictly increasing: {th}")
        for k, b in enumerate(th):
            if b > self.configs[k].c_max:
                raise ValueError(
                    f"B_{k + 1}={b} exceeds pool "
                    f"{self.names[k]!r} C_max={self.configs[k].c_max}"
                )

    def __len__(self) -> int:
        return len(self.states)

    @property
    def thresholds(self) -> np.ndarray:
        """(P-1,) int64 boundaries, for the vectorized routing kernel."""
        return np.asarray(self._thresholds, dtype=np.int64)

    def set_threshold(self, k: int, value: int) -> None:
        """Move one boundary (adaptive control), re-validating the order."""
        old = self._thresholds[k]
        self._thresholds[k] = int(value)
        try:
            self._validate_thresholds()
        except ValueError:
            self._thresholds[k] = old
            raise

    def set_thresholds(self, values: Sequence[int]) -> None:
        """Replace the whole boundary vector atomically (adaptive control).

        Mutates the threshold list *in place* so live aliases (the router's
        hot-path view) observe the move; restores the previous vector when
        validation fails, so observers never see an invalid ordering.
        """
        if len(values) != len(self._thresholds):
            raise ValueError(
                f"expected {len(self._thresholds)} thresholds, got {len(values)}"
            )
        old = list(self._thresholds)
        self._thresholds[:] = [int(v) for v in values]
        try:
            self._validate_thresholds()
        except ValueError:
            self._thresholds[:] = old
            raise

    def static_pool(self, budget: int) -> int:
        """Threshold search: first pool index whose ``B_k`` covers ``budget``."""
        return bisect.bisect_left(self._thresholds, budget)

    def first_feasible(self, idx: int, budget: int) -> int:
        """Hard-constraint escalation: the nearest pool at or above ``idx``
        that admits ``budget`` (the last pool when none does)."""
        last = len(self.states) - 1
        while idx < last and not self.configs[idx].admits(budget):
            idx += 1
        return idx

    def spill_order(self, idx: int) -> list[int]:
        """Spillover candidates for a request targeting pool ``idx``."""
        return self._spill_orders[idx]


def fleet_instances(
    rate: float, mu_per_instance: float, headroom: float = 1.0
) -> int:
    """ceil(λ/μ × β) — analytical fleet size (paper Appendix A)."""
    if mu_per_instance <= 0:
        raise ValueError("throughput must be positive")
    return max(1, math.ceil(rate / mu_per_instance * headroom))


def dual_pool_fleet(
    rate: float,
    alpha: float,
    mu_short: float,
    mu_long: float,
    *,
    headroom_short: float = 1.05,
    headroom_long: float = 1.02,
) -> tuple[int, int]:
    """Corrected fleet formula (Eq. 8): G = αλ/μ_Ps + (1−α)λ/μ_Pl.

    Returns (short_instances, long_instances); either may be 0 when its
    traffic share is 0.
    """
    short = (
        fleet_instances(alpha * rate, mu_short, headroom_short) if alpha > 0 else 0
    )
    long_ = (
        fleet_instances((1.0 - alpha) * rate, mu_long, headroom_long)
        if alpha < 1.0
        else 0
    )
    return short, long_


def validate_pools(pools: Sequence[PoolConfig]) -> None:
    """Sanity checks shared by router and simulator."""
    if not pools:
        raise ValueError("need at least one pool")
    names = [p.name for p in pools]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate pool names: {names}")
    for p in pools:
        if p.c_max <= 0 or p.n_seq <= 0:
            raise ValueError(f"pool {p.name} has non-positive capacity")
