"""Analytical profiler: pool throughput + fleet sizing (Appendix A layer 2).

Computes the theoretical maximum throughput μ_max of each pool configuration
from a trace CDF (or an explicit request list) and the timing model, then
sizes fleets with the queuing-headroom factors β. This is the layer that
produces Table 1 (μ per pool), Table 2 (fleet sizes), Figure 6 (sensitivity
sweep) and the Table 5 projection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.pools import PoolConfig, n_seq_for_cmax
from repro_torch.core.router import Request
from repro_torch.sim.timing import TimingModel

#: Queuing-headroom factors β (Appendix A layer 2).
HEADROOM = {"homogeneous": 1.08, "short": 1.05, "long": 1.02}


@dataclasses.dataclass(frozen=True)
class PoolProfile:
    pool: str
    c_max: int
    n_seq: int
    mean_iters: float
    traffic_fraction: float  # share of requests this pool serves
    mu: float  # req/s per instance at full occupancy
    instances: int  # sized for `rate` with headroom


def mean_iterations(
    requests: Sequence[Request], timing: TimingModel
) -> float:
    if not requests:
        return 0.0
    total = sum(
        timing.iterations_for(r.true_input_tokens, r.true_output_tokens)
        for r in requests
    )
    return total / len(requests)


def profile_pool(
    name: str,
    requests: Sequence[Request],
    pool_requests: Sequence[Request],
    pool: PoolConfig,
    timing: TimingModel,
    rate: float,
    *,
    headroom: Optional[float] = None,
) -> PoolProfile:
    """Profile one pool over the subset of the trace routed to it."""
    frac = len(pool_requests) / max(1, len(requests))
    mean_iters = mean_iterations(pool_requests, timing)
    if mean_iters <= 0:
        return PoolProfile(name, pool.c_max, pool.n_seq, 0.0, 0.0, 0.0, 0)
    mu = timing.throughput(mean_iters, pool.n_seq)
    beta = pool.headroom if headroom is None else headroom
    instances = max(1, math.ceil(frac * rate / mu * beta))
    return PoolProfile(name, pool.c_max, pool.n_seq, mean_iters, frac, mu, instances)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Analytical fleet comparison: homogeneous vs token-budget dual pool."""

    trace: str
    rate: float
    b_short: int
    homogeneous: PoolProfile
    short: PoolProfile
    long: PoolProfile

    @property
    def g_homo(self) -> int:
        return self.homogeneous.instances

    @property
    def g_dual(self) -> int:
        return self.short.instances + self.long.instances

    @property
    def savings(self) -> float:
        return (self.g_homo - self.g_dual) / max(1, self.g_homo)

    @property
    def alpha(self) -> float:
        return self.short.traffic_fraction

    @property
    def rho(self) -> float:
        """Throughput gain ratio μ(C_S)/μ(C_H) for the closed-form model."""
        if self.homogeneous.mu <= 0:
            return 1.0
        return self.short.mu / self.homogeneous.mu


def split_by_budget(
    requests: Sequence[Request], b_short: int
) -> tuple[list[Request], list[Request]]:
    """Oracle split on the *true* total budget (analytical layer).

    The DES layer uses the router's calibrated estimates instead; at the
    analytical layer the paper splits on the trace's actual totals.
    """
    short = [r for r in requests if r.true_total <= b_short]
    long_ = [r for r in requests if r.true_total > b_short]
    return short, long_


def plan_fleet(
    trace_name: str,
    requests: Sequence[Request],
    timing: TimingModel,
    rate: float,
    *,
    b_short: int = 8192,
    c_homo: int = 65_536,
    homo_slots: int = 16,
    short_max_slots: int = 128,
    kv_block_budget_mult: float = 1.0,
) -> FleetPlan:
    """Analytical Table-2 computation for one trace and threshold.

    ``kv_block_budget_mult`` scales the KV block budget (e.g. 2.0 for an
    int8 KV cache, whose bytes/token halve).
    """
    from repro_torch.core.pools import TOTAL_KV_BLOCKS

    homo_pool = PoolConfig(
        name="homogeneous",
        c_max=c_homo,
        n_seq=homo_slots,
        headroom=HEADROOM["homogeneous"],
    )
    short_cfg = PoolConfig(
        name="short",
        c_max=max(b_short, 1),
        n_seq=n_seq_for_cmax(
            b_short,
            max_slots=short_max_slots,
            total_blocks=int(TOTAL_KV_BLOCKS * kv_block_budget_mult),
        ),
        headroom=HEADROOM["short"],
    )
    long_cfg = PoolConfig(
        name="long",
        c_max=c_homo,
        n_seq=homo_slots,
        headroom=HEADROOM["long"],
    )

    short_reqs, long_reqs = split_by_budget(requests, b_short)
    return FleetPlan(
        trace=trace_name,
        rate=rate,
        b_short=b_short,
        homogeneous=profile_pool(
            "homogeneous", requests, requests, homo_pool, timing, rate
        ),
        short=profile_pool("short", requests, short_reqs, short_cfg, timing, rate),
        long=profile_pool("long", requests, long_reqs, long_cfg, timing, rate),
    )


def sensitivity_sweep(
    trace_name: str,
    requests: Sequence[Request],
    timing: TimingModel,
    rate: float,
    thresholds: Sequence[int] = (2048, 4096, 8192, 16384, 32768),
) -> list[FleetPlan]:
    """Figure 6: savings vs B_short, with N_seq(B_short) from the block budget."""
    return [
        plan_fleet(trace_name, requests, timing, rate, b_short=b)
        for b in thresholds
    ]
