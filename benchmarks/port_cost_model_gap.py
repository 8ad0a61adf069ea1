"""§4.2 "The long-pool bottleneck": Eq. 7 vs Eq. 8 vs simulation, on the PyTorch port.

The port of ``benchmarks/cost_model_gap.py``: the same rows and derived values,
through ``repro_torch`` only (no jax); host arithmetic, no device.

Paper: on Azure, Eq. 7 predicts α(1−1/ρ) = 0.92×0.75 ≈ 69% but realized
savings are 16.6% — a ~4× over-prediction, driven by μ_Pl ≈ 0.37 ≪ μ_homo.
On LMSYS (α≈1.00) the closed form is accurate (40% vs 38.5% realized).
"""

from __future__ import annotations

from benchmarks.common import emit, time_us
from repro_torch.core import closed_form_savings, corrected_savings
from repro_torch.sim import A100_LLAMA3_70B, plan_fleet
from repro_torch.traces import TraceSpec, generate_trace


def run(num_requests: int = 10_000, rate: float = 1000.0) -> dict:
    out = {}
    for trace in ("azure", "lmsys"):
        reqs = generate_trace(
            TraceSpec(trace=trace, num_requests=num_requests, rate=rate, seed=42)
        )
        plan = plan_fleet(trace, reqs, A100_LLAMA3_70B, rate)
        us = time_us(
            lambda: closed_form_savings(plan.alpha, plan.rho), repeats=100
        )
        eq7 = closed_form_savings(plan.alpha, plan.rho)
        eq8, g_homo, g_dual = corrected_savings(
            rate,
            plan.alpha,
            plan.short.mu,
            plan.long.mu if plan.long.mu > 0 else plan.homogeneous.mu,
            plan.homogeneous.mu,
            headroom_homo=1.08,
            headroom_short=1.05,
            headroom_long=1.02,
        )
        gap = eq7 / max(plan.savings, 1e-9)
        emit(
            f"cost_gap/{trace}",
            us,
            f"eq7={eq7:.3f};eq8={eq8:.3f};realized={plan.savings:.3f};"
            f"overprediction={gap:.2f}x;mu_long={plan.long.mu:.2f};"
            f"mu_homo={plan.homogeneous.mu:.2f}",
        )
        out[trace] = {"eq7": eq7, "eq8": eq8, "realized": plan.savings}
    return out


if __name__ == "__main__":
    run()
