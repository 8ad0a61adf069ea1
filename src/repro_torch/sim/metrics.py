"""Latency / reliability metrics for the DES (paper Tables 2–3).

Two aggregation paths with identical semantics:

* :func:`summarize` — over a list of :class:`RequestRecord` objects, used by
  the scalar reference backend;
* :func:`summarize_columns` — over columnar NumPy arrays, used by the
  vectorized backend so a million-request run never materializes a million
  Python objects. Percentiles use the same nearest-rank definition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0,100]); 0.0 on empty input."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[rank]


@dataclasses.dataclass
class RequestRecord:
    """Per-request outcome recorded by the simulator."""

    request_id: int
    pool: str
    arrival: float
    first_token: float  # absolute time of first generated token
    finish: float
    output_tokens: int
    preemptions: int = 0
    truncated: bool = False
    rejected: bool = False

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        if self.output_tokens <= 1:
            return 0.0
        return (self.finish - self.first_token) / (self.output_tokens - 1)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """A latency service-level objective (paper §3: P99 targets).

    One shared definition threaded through the fleet simulator and the
    capacity-bisection benchmarks, replacing per-call-site hardcoded
    targets. The defaults are the paper's: P99 TTFT ≤ 2 s, P99 TPOT ≤ 80 ms.
    """

    ttft_p99: float = 2.0  # seconds
    tpot_p99: float = 0.080  # seconds per output token

    def met_by(self, summary: "SimSummary") -> bool:
        return (
            summary.ttft_p99 <= self.ttft_p99
            and summary.tpot_p99 <= self.tpot_p99
        )


#: The paper's SLO operating point (Tables 2–3).
PAPER_SLO = SLOTarget()


@dataclasses.dataclass
class SimSummary:
    """Aggregate metrics (after warm-up discard) for one simulation run."""

    name: str
    num_requests: int
    completed: int
    rejected: int
    truncated: int
    preemptions: int
    spills: int
    ttft_p50: float
    ttft_p99: float
    tpot_p50: float
    tpot_p99: float
    makespan: float
    throughput: float  # completed / makespan

    @property
    def success_rate(self) -> float:
        if self.num_requests == 0:
            return 1.0
        return self.completed / self.num_requests

    @property
    def error_rate(self) -> float:
        """(preemptions + rejections + truncations) / requests — the same
        composite the adaptive controller monitors (§8), post-warmup."""
        if self.num_requests == 0:
            return 0.0
        return (
            self.preemptions + self.rejected + self.truncated
        ) / self.num_requests

    def meets_slo(self, slo: SLOTarget = PAPER_SLO) -> bool:
        """Check this run against an :class:`SLOTarget` (default: paper's)."""
        return slo.met_by(self)


def summarize(
    name: str,
    records: Sequence[RequestRecord],
    *,
    warmup_frac: float = 0.20,
    total_spills: int = 0,
) -> SimSummary:
    """Aggregate with the paper's 20% warm-up discard (Appendix A)."""
    if not records:
        return SimSummary(name, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.0, 0.0)

    by_arrival = sorted(records, key=lambda r: r.arrival)
    cut = int(len(by_arrival) * warmup_frac)
    window = by_arrival[cut:]

    done = [r for r in window if not r.rejected]
    ttfts = [r.ttft for r in done]
    tpots = [r.tpot for r in done if r.output_tokens > 1]
    finish_times = [r.finish for r in done]
    start = window[0].arrival if window else 0.0
    makespan = (max(finish_times) - start) if finish_times else 0.0

    return SimSummary(
        name=name,
        num_requests=len(window),
        completed=len(done),
        rejected=sum(1 for r in window if r.rejected),
        truncated=sum(1 for r in window if r.truncated),
        preemptions=sum(r.preemptions for r in window),
        spills=total_spills,
        ttft_p50=percentile(ttfts, 50),
        ttft_p99=percentile(ttfts, 99),
        tpot_p50=percentile(tpots, 50),
        tpot_p99=percentile(tpots, 99),
        makespan=makespan,
        throughput=len(done) / makespan if makespan > 0 else 0.0,
    )


def _percentile_sorted(values: np.ndarray, q: float) -> float:
    """Nearest-rank percentile of an already-sorted array, matching
    :func:`percentile` exactly (sort once, index per quantile)."""
    n = len(values)
    if n == 0:
        return 0.0
    rank = max(0, min(n - 1, math.ceil(q / 100.0 * n) - 1))
    return float(values[rank])


def concat_record_columns(
    column_maps: Sequence[Mapping[str, np.ndarray]],
) -> dict[str, np.ndarray]:
    """Merge per-pool record columns into one fleet-level column map.

    Used by the fleet layer to aggregate any number of pools (the N-pool
    generalization has no fixed pool count) without materializing records.
    """
    if not column_maps:
        return {}
    return {
        key: np.concatenate([cols[key] for cols in column_maps])
        for key in column_maps[0]
    }


def summarize_columns(
    name: str,
    cols: Mapping[str, np.ndarray],
    *,
    warmup_frac: float = 0.20,
    total_spills: int = 0,
) -> SimSummary:
    """Columnar twin of :func:`summarize` (same 20% warm-up discard).

    ``cols`` holds one array per :class:`RequestRecord` field:
    ``request_id, arrival, first_token, finish, output_tokens, preemptions,
    truncated, rejected``.
    """
    n = len(cols["arrival"])
    if n == 0:
        return SimSummary(name, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.0, 0.0)

    order = np.argsort(cols["arrival"], kind="stable")
    window = order[int(n * warmup_frac) :]

    rejected = cols["rejected"][window]
    done = window[~rejected]
    ttfts = np.sort(cols["first_token"][done] - cols["arrival"][done])
    out = cols["output_tokens"][done]
    multi = out > 1
    tpots = np.sort(
        (cols["finish"][done] - cols["first_token"][done])[multi]
        / (out[multi] - 1)
    )
    start = float(cols["arrival"][window[0]]) if len(window) else 0.0
    makespan = (
        float(cols["finish"][done].max()) - start if len(done) else 0.0
    )

    return SimSummary(
        name=name,
        num_requests=len(window),
        completed=len(done),
        rejected=int(rejected.sum()),
        truncated=int(cols["truncated"][window].sum()),
        preemptions=int(cols["preemptions"][window].sum()),
        spills=total_spills,
        ttft_p50=_percentile_sorted(ttfts, 50),
        ttft_p99=_percentile_sorted(ttfts, 99),
        tpot_p50=_percentile_sorted(tpots, 50),
        tpot_p99=_percentile_sorted(tpots, 99),
        makespan=makespan,
        throughput=len(done) / makespan if makespan > 0 else 0.0,
    )
