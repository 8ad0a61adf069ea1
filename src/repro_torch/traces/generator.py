"""Synthetic trace generation (Appendix A "Trace generation").

Requests arrive as a Poisson process at rate λ. Total-token counts come from
the bucketed CDFs in :mod:`repro_torch.traces.cdf`; the input/output split is a
clipped normal. On top of the paper's recipe we synthesize the *routing
observables*: a traffic category and a prompt byte length
``|r| ≈ L_in · c_k`` with per-request noise, so the router's calibration
loop (which never sees token counts, only bytes and usage feedback) can be
evaluated end-to-end.

Nonstationary scenarios
-----------------------
Real fleets are not stationary Poisson (FleetOpt / inference-fleet-sim both
validate provisioning under bursts, diurnal cycles, and content drift), so
:class:`TraceSpec` carries three orthogonal scenario axes, all defaulting to
the paper's stationary recipe:

* **arrival-rate modulation** (``rate_profile``) — the trace becomes an
  inhomogeneous Poisson process with intensity ``λ·m(t)`` via the
  time-rescaling theorem: the stationary draw supplies unit-rate arrival
  times, which are mapped through the inverse cumulative intensity
  ``Λ⁻¹``. Profiles: ``"burst"`` (a ``rate_period``-second window at
  ``(1+A)·λ`` starting 40% into the nominal trace), ``"diurnal"``
  (sinusoidal ``1 + A·sin(2πt/period)``), and ``"step"`` (a permanent
  shift to ``(1+A)·λ`` at ``t = rate_period``).
* **category-mix drift** (``mix_drift``) — the per-request category
  distribution interpolates from the source trace's mix toward
  ``drift_trace``'s mix over the trace (0 = none, 1 = fully drifted by the
  final request).
* **bytes-per-token drift** (``bytes_drift``) — the true per-request
  bytes/token ratio scales by ``1 + bytes_drift·(i/n)``, modelling content
  drift *within* categories (the calibrator's EMA must chase it).

All three are implemented once, in :func:`generate_trace_columns`;
:func:`generate_trace` materializes the identical columns, so the two
entry points stay bit-identical for every scenario.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.categories import (
    BYTES_PER_TOKEN_STD,
    TRUE_BYTES_PER_TOKEN,
    Category,
)
from repro_torch.core.router import Request
from repro_torch.traces.cdf import BucketCDF, get_trace_cdf

#: Category mix per trace. Azure (enterprise API) is prose/code heavy;
#: LMSYS (chat arena) has a large non-English share.
CATEGORY_MIX: dict[str, dict[Category, float]] = {
    "azure": {
        Category.ENGLISH_PROSE: 0.55,
        Category.SOURCE_CODE: 0.25,
        Category.CJK_TEXT: 0.08,
        Category.MIXED_OTHER: 0.12,
    },
    "lmsys": {
        Category.ENGLISH_PROSE: 0.50,
        Category.SOURCE_CODE: 0.12,
        Category.CJK_TEXT: 0.22,
        Category.MIXED_OTHER: 0.16,
    },
}


#: Valid arrival-rate modulation profiles.
RATE_PROFILES = ("stationary", "burst", "diurnal", "step")

#: Burst window start, as a fraction of the nominal trace duration n/λ.
_BURST_START_FRAC = 0.4

#: Intensity floor for the diurnal trough (keeps Λ strictly increasing).
_RATE_FLOOR = 0.05


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Everything needed to regenerate a trace deterministically.

    The scenario fields (``rate_profile`` onward) default to the paper's
    strictly-stationary recipe; see the module docstring for the burst /
    diurnal / step arrival profiles and the two content-drift axes.
    """

    trace: str = "azure"
    num_requests: int = 10_000
    rate: float = 1000.0  # req/s Poisson arrival rate
    seed: int = 42
    cap_style: str = "exact"  # max_output_tokens: exact | padded | bucket
    # -- nonstationary scenario axes (defaults = stationary) ----------------
    rate_profile: str = "stationary"  # stationary | burst | diurnal | step
    rate_amplitude: float = 0.0  # A: modulation depth, ×rate
    rate_period: float = 60.0  # s: burst length / sine period / step time
    mix_drift: float = 0.0  # 0..1: category-mix drift toward drift_trace
    drift_trace: str = "lmsys"  # mix drifted toward over the trace
    bytes_drift: float = 0.0  # fractional bytes/token drift over the trace

    def validate(self) -> None:
        if self.rate_profile not in RATE_PROFILES:
            raise ValueError(
                f"unknown rate_profile {self.rate_profile!r}; "
                f"expected one of {RATE_PROFILES}"
            )
        if self.rate_profile == "diurnal":
            if not abs(self.rate_amplitude) < 1.0:
                raise ValueError(
                    f"diurnal amplitude must satisfy |A| < 1: {self.rate_amplitude}"
                )
        elif self.rate_profile != "stationary":
            if self.rate_amplitude <= -1.0:
                raise ValueError(
                    f"{self.rate_profile} amplitude must exceed -1: "
                    f"{self.rate_amplitude}"
                )
        if self.rate_profile != "stationary" and self.rate_period <= 0:
            raise ValueError(f"rate_period must be positive: {self.rate_period}")
        if not 0.0 <= self.mix_drift <= 1.0:
            raise ValueError(f"mix_drift must be in [0, 1]: {self.mix_drift}")
        if self.mix_drift > 0.0 and self.drift_trace not in CATEGORY_MIX:
            raise ValueError(f"unknown drift_trace {self.drift_trace!r}")
        if self.bytes_drift <= -1.0:
            raise ValueError(f"bytes_drift must exceed -1: {self.bytes_drift}")


def _warp_arrivals(spec: TraceSpec, stationary: np.ndarray) -> np.ndarray:
    """Inhomogeneous-Poisson arrivals by time rescaling.

    ``stationary`` are the constant-rate arrival times; ``v = stationary``
    is exactly the cumulative unit-rate operational time divided by λ, so
    the warped arrivals are ``t_i = Λ⁻¹(λ·v_i)`` with
    ``Λ(t) = λ·∫₀ᵗ m``. Burst and step invert Λ in closed form; diurnal
    interpolates the analytic Λ on a dense grid.
    """
    a = spec.rate_amplitude
    if spec.rate_profile == "stationary" or a == 0.0:
        return stationary
    v = stationary  # Λ(t_i)/λ in operational time
    if spec.rate_profile == "step":
        # m(t) = 1 + A for t ≥ t_s: Λ/λ = t + A·max(0, t−t_s)
        t_s = spec.rate_period
        return np.where(v <= t_s, v, t_s + (v - t_s) / (1.0 + a))
    if spec.rate_profile == "burst":
        # m(t) = 1 + A inside [t_b, t_b+L): Λ/λ = t + A·clip(t−t_b, 0, L)
        t_b = _BURST_START_FRAC * spec.num_requests / spec.rate
        length = spec.rate_period
        hi = t_b + (1.0 + a) * length  # Λ/λ at the burst's end
        return np.where(
            v <= t_b,
            v,
            np.where(v <= hi, t_b + (v - t_b) / (1.0 + a), v - a * length),
        )
    # diurnal: m(t) = max(1 + A·sin(2πt/T), floor); invert the analytic Λ
    # numerically (the floor only binds for |A| → 1).
    omega = 2.0 * np.pi / spec.rate_period
    m_min = max(1.0 - abs(a), _RATE_FLOOR)
    t_max = float(v[-1]) / m_min + spec.rate_period
    cells_per_period = 1024
    grid_n = int(
        min(2_000_000, max(4096, np.ceil(t_max / spec.rate_period) * cells_per_period))
    )
    ts = np.linspace(0.0, t_max, grid_n)
    lam_over_rate = ts + (a / omega) * (1.0 - np.cos(omega * ts))
    # Guard the floor case: enforce monotonicity before inverting.
    lam_over_rate = np.maximum.accumulate(lam_over_rate)
    return np.interp(v, lam_over_rate, ts)


def _mix_probs(trace: str, cats: np.ndarray) -> np.ndarray:
    """Category probabilities aligned to the ``cats`` id order."""
    mix = CATEGORY_MIX[trace]
    p = np.array([mix.get(Category(int(c)), 0.0) for c in cats], dtype=np.float64)
    return p / p.sum()


def _sample_categories(
    rng: np.random.Generator,
    trace: str,
    n: int,
    *,
    mix_drift: float = 0.0,
    drift_trace: str = "lmsys",
) -> np.ndarray:
    cats = np.array([int(k) for k in CATEGORY_MIX[trace]], dtype=np.int64)
    probs = _mix_probs(trace, cats)
    if mix_drift == 0.0:
        return rng.choice(cats, size=n, p=probs)
    # Per-request mix p_i = (1−w_i)·p_src + w_i·p_dst with w ramping from 0
    # to mix_drift across the trace: inverse-CDF sampling row-wise.
    dst = _mix_probs(drift_trace, cats)
    w = mix_drift * np.arange(n, dtype=np.float64) / max(1, n - 1)
    p_t = (1.0 - w[:, None]) * probs[None, :] + w[:, None] * dst[None, :]
    cum = np.cumsum(p_t, axis=1)
    u = rng.random(n)
    idx = np.minimum((u[:, None] > cum).sum(axis=1), len(cats) - 1)
    return cats[idx]


def _synth_bytes(
    rng: np.random.Generator,
    l_in: np.ndarray,
    cats: np.ndarray,
    *,
    bytes_drift: float = 0.0,
) -> np.ndarray:
    """|r| = L_in · c_true, with per-request ratio noise per category and an
    optional content-drift ramp of the true ratio across the trace."""
    c_mu = np.array([TRUE_BYTES_PER_TOKEN[Category(int(c))] for c in cats])
    c_sd = np.array([BYTES_PER_TOKEN_STD[Category(int(c))] for c in cats])
    c_req = np.maximum(0.5, rng.normal(c_mu, c_sd))
    if bytes_drift != 0.0:
        n = len(l_in)
        ramp = 1.0 + bytes_drift * np.arange(n, dtype=np.float64) / max(1, n - 1)
        c_req = np.maximum(0.5, c_req * ramp)
    return np.maximum(1, np.round(l_in * c_req)).astype(np.int64)


def _output_caps(
    rng: np.random.Generator, l_out: np.ndarray, style: str
) -> np.ndarray:
    """The API-level max_output_tokens cap the router sees.

    exact  — cap equals the realized output (paper's Table 2 setting);
    padded — users over-ask by 1–2× (robustness studies);
    bucket — round up to the next power of two ≥128 (UI presets).
    """
    if style == "exact":
        return l_out
    if style == "padded":
        return np.maximum(1, np.round(l_out * rng.uniform(1.0, 2.0, len(l_out)))).astype(
            np.int64
        )
    if style == "bucket":
        caps = 2 ** np.ceil(np.log2(np.maximum(l_out, 128)))
        return caps.astype(np.int64)
    raise ValueError(f"unknown cap style {style!r}")


@dataclasses.dataclass
class TraceColumns:
    """Struct-of-arrays trace: one NumPy array per :class:`Request` field.

    The native product of :func:`generate_trace_columns` and the native
    input of the vectorized fleet backend — a million-request trace is
    seven arrays, not a million Python objects. ``to_requests()`` /
    ``from_requests()`` adapt to the reference backend's object form.
    """

    request_id: np.ndarray  # (N,) int64
    byte_len: np.ndarray  # (N,) int64
    max_output_tokens: np.ndarray  # (N,) int64
    category: np.ndarray  # (N,) int64
    arrival_time: np.ndarray  # (N,) float64
    true_input_tokens: np.ndarray  # (N,) int64
    true_output_tokens: np.ndarray  # (N,) int64

    def __len__(self) -> int:
        return len(self.request_id)

    @property
    def true_total(self) -> np.ndarray:
        return self.true_input_tokens + self.true_output_tokens

    def head(self, n: int) -> "TraceColumns":
        """First ``n`` requests (views, no copy)."""
        return TraceColumns(
            **{
                f.name: getattr(self, f.name)[:n]
                for f in dataclasses.fields(self)
            }
        )

    def sorted_by_arrival(self) -> "TraceColumns":
        """Arrival-ordered view (no copy when already sorted, the normal
        case for generator output — arrivals are a cumulative sum)."""
        arr = self.arrival_time
        if len(arr) < 2 or bool((arr[1:] >= arr[:-1]).all()):
            return self
        order = np.argsort(arr, kind="stable")
        return TraceColumns(
            **{
                f.name: getattr(self, f.name)[order]
                for f in dataclasses.fields(self)
            }
        )

    def to_requests(self) -> list[Request]:
        """Materialize :class:`Request` objects (reference backend)."""
        return [
            Request(
                request_id=int(self.request_id[i]),
                byte_len=int(self.byte_len[i]),
                max_output_tokens=int(self.max_output_tokens[i]),
                category=int(self.category[i]),
                arrival_time=float(self.arrival_time[i]),
                true_input_tokens=int(self.true_input_tokens[i]),
                true_output_tokens=int(self.true_output_tokens[i]),
            )
            for i in range(len(self))
        ]

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "TraceColumns":
        """Columnarize an object-form trace (adapter, not the hot path)."""
        return cls(
            request_id=np.fromiter(
                (r.request_id for r in requests), np.int64, len(requests)
            ),
            byte_len=np.fromiter(
                (r.byte_len for r in requests), np.int64, len(requests)
            ),
            max_output_tokens=np.fromiter(
                (r.max_output_tokens for r in requests), np.int64, len(requests)
            ),
            category=np.fromiter(
                (r.category for r in requests), np.int64, len(requests)
            ),
            arrival_time=np.fromiter(
                (r.arrival_time for r in requests), np.float64, len(requests)
            ),
            true_input_tokens=np.fromiter(
                (r.true_input_tokens for r in requests), np.int64, len(requests)
            ),
            true_output_tokens=np.fromiter(
                (r.true_output_tokens for r in requests), np.int64, len(requests)
            ),
        )


def generate_trace_columns(spec: TraceSpec) -> TraceColumns:
    """Deterministic synthetic trace, columnar form (no Request objects).

    Draws from the RNG in exactly the order :func:`generate_trace` always
    has (arrival gaps, totals, split, categories, bytes, caps), so the two
    paths are bit-identical for the same spec.
    """
    spec.validate()
    cdf: BucketCDF = get_trace_cdf(spec.trace)
    rng = np.random.default_rng(spec.seed)
    n = spec.num_requests

    gaps = rng.exponential(1.0 / spec.rate, size=n)
    arrivals = _warp_arrivals(spec, np.cumsum(gaps))
    totals = cdf.sample_totals(rng, n)
    l_in, l_out = cdf.sample_split(rng, totals)
    cats = _sample_categories(
        rng, spec.trace, n,
        mix_drift=spec.mix_drift, drift_trace=spec.drift_trace,
    )
    byte_lens = _synth_bytes(rng, l_in, cats, bytes_drift=spec.bytes_drift)
    caps = _output_caps(rng, l_out, spec.cap_style)

    return TraceColumns(
        request_id=np.arange(n, dtype=np.int64),
        byte_len=byte_lens.astype(np.int64),
        max_output_tokens=caps.astype(np.int64),
        category=cats.astype(np.int64),
        arrival_time=arrivals.astype(np.float64),
        true_input_tokens=l_in.astype(np.int64),
        true_output_tokens=l_out.astype(np.int64),
    )


def generate_trace(spec: TraceSpec) -> list[Request]:
    """Deterministic synthetic trace of routing-layer requests (object form;
    :func:`generate_trace_columns` is the columnar native path)."""
    return generate_trace_columns(spec).to_requests()


def short_fraction(requests, b_short: int) -> float:
    """Empirical α = fraction of requests with true total ≤ B_short.

    Accepts either a Request sequence or a :class:`TraceColumns`.
    """
    if isinstance(requests, TraceColumns):
        if not len(requests):
            return 0.0
        return float((requests.true_total <= b_short).mean())
    if not requests:
        return 0.0
    hits = sum(1 for r in requests if r.true_total <= b_short)
    return hits / len(requests)
