"""Empirical total-token CDFs for the two evaluation traces (Appendix A).

The paper derives simplified bucketed CDFs from published summary statistics
(it does not ship raw logs):

* **Azure-Derived** [11]: 80% of requests below 2K total tokens, 92% below
  8K, long tail to 64K; output fraction ~N(0.10, 0.05).
* **LMSYS-Derived** [12]: mean L_in = 69.5, mean L_out = 214.5 (mean total
  ~284); output fraction ~N(0.75, 0.10); virtually nothing above 8K.

Sampling is inverse-CDF with *uniform interpolation inside each bucket*,
which (as the paper's Limitations section notes) produces slightly heavier
tails than the true distributions — we reproduce that artefact on purpose,
since the paper's Table 1/2 numbers depend on it.

Bucket masses below were tuned so the analytically-derived quantities match
the paper's reported values (Table 1):
  Azure:  E[iters]≈290 → μ_homo≈3.0; E[iters | ≤8K]≈104 → μ_short≈13.5;
          E[iters | >8K] → μ_long≈0.37; F(2048)=0.80; F(8192)≈0.92.
  LMSYS:  E[total]≈284 → μ_homo≈4.1, μ_short≈6.8; F(8192)=0.9993 (the tiny
          tail that makes Table 2's 8 long-pool instances).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketCDF:
    """Piecewise-uniform CDF over total token counts."""

    name: str
    edges: tuple[int, ...]  # bucket upper edges, ascending
    cum: tuple[float, ...]  # cumulative probability at each edge
    # Output-fraction split L_out/L_total ~ N(mu, sigma) clipped (Appendix A)
    out_frac_mu: float = 0.10
    out_frac_sigma: float = 0.05
    out_frac_clip: tuple[float, float] = (0.02, 0.95)

    def __post_init__(self) -> None:
        if len(self.edges) != len(self.cum):
            raise ValueError("edges and cum must align")
        if any(b <= a for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("edges must be strictly ascending")
        if any(b < a for a, b in zip(self.cum, self.cum[1:])):
            raise ValueError("cum must be non-decreasing")
        if abs(self.cum[-1] - 1.0) > 1e-9:
            raise ValueError("cum must end at 1.0")

    # -- CDF / inverse-CDF ---------------------------------------------------
    def cdf(self, x: float) -> float:
        """F(x) with uniform interpolation inside buckets."""
        if x <= 0:
            return 0.0
        lo_edge, lo_cum = 0, 0.0
        for edge, c in zip(self.edges, self.cum):
            if x <= edge:
                frac = (x - lo_edge) / (edge - lo_edge)
                return lo_cum + frac * (c - lo_cum)
            lo_edge, lo_cum = edge, c
        return 1.0

    def inverse(self, u: float) -> float:
        """F^{-1}(u) with uniform interpolation (Appendix A sampling)."""
        u = min(max(u, 0.0), 1.0)
        idx = bisect.bisect_left(self.cum, u)
        idx = min(idx, len(self.cum) - 1)
        lo_edge = 0 if idx == 0 else self.edges[idx - 1]
        lo_cum = 0.0 if idx == 0 else self.cum[idx - 1]
        hi_edge, hi_cum = self.edges[idx], self.cum[idx]
        if hi_cum <= lo_cum:
            return float(hi_edge)
        frac = (u - lo_cum) / (hi_cum - lo_cum)
        return lo_edge + frac * (hi_edge - lo_edge)

    def sample_totals(self, rng: np.random.Generator, n: int) -> np.ndarray:
        u = rng.uniform(size=n)
        totals = np.array([self.inverse(v) for v in u])
        return np.maximum(2, np.round(totals)).astype(np.int64)

    def sample_split(
        self, rng: np.random.Generator, totals: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Split totals into (L_in, L_out) via the clipped-normal fraction."""
        frac = rng.normal(self.out_frac_mu, self.out_frac_sigma, size=len(totals))
        frac = np.clip(frac, *self.out_frac_clip)
        l_out = np.maximum(1, np.round(totals * frac)).astype(np.int64)
        l_in = np.maximum(1, totals - l_out)
        return l_in, l_out

    # -- analytics (used by the profiler and Fig. 6) --------------------------
    def mean_total(self) -> float:
        m, lo_edge, lo_cum = 0.0, 0, 0.0
        for edge, c in zip(self.edges, self.cum):
            m += (c - lo_cum) * (lo_edge + edge) / 2.0
            lo_edge, lo_cum = edge, c
        return m

    def mean_total_conditional(self, lo: float, hi: float) -> float:
        """E[T | lo < T <= hi] under the piecewise-uniform density."""
        mass, acc = 0.0, 0.0
        prev_edge, prev_cum = 0, 0.0
        for edge, c in zip(self.edges, self.cum):
            a, b = max(prev_edge, lo), min(edge, hi)
            if b > a and edge > prev_edge:
                dens = (c - prev_cum) / (edge - prev_edge)
                mass += dens * (b - a)
                acc += dens * (b - a) * (a + b) / 2.0
            prev_edge, prev_cum = edge, c
        if mass <= 0:
            return 0.0
        return acc / mass

    def tail_mass(self, threshold: float) -> float:
        return 1.0 - self.cdf(threshold)

    @property
    def max_total(self) -> int:
        return self.edges[-1]


AZURE = BucketCDF(
    name="azure",
    edges=(64, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536),
    cum=(0.06, 0.2815, 0.4815, 0.6815, 0.8015, 0.8815, 0.917, 0.960, 0.987, 1.0),
    out_frac_mu=0.10,
    out_frac_sigma=0.05,
)

LMSYS = BucketCDF(
    name="lmsys",
    edges=(32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384),
    cum=(0.10, 0.30, 0.586, 0.786, 0.885, 0.952, 0.9860, 0.9970, 0.99935, 1.0),
    out_frac_mu=0.75,
    out_frac_sigma=0.10,
)

TRACES: dict[str, BucketCDF] = {"azure": AZURE, "lmsys": LMSYS}


def get_trace_cdf(name: str) -> BucketCDF:
    try:
        return TRACES[name]
    except KeyError:
        raise KeyError(f"unknown trace {name!r}; have {sorted(TRACES)}") from None


def describe(cdf: BucketCDF, thresholds: Sequence[int] = (2048, 8192)) -> dict:
    out = {
        "name": cdf.name,
        "mean_total": cdf.mean_total(),
        "max_total": cdf.max_total,
    }
    for t in thresholds:
        out[f"F({t})"] = cdf.cdf(t)
    return out
