"""Table 2: GPU instances and savings at 1,000 req/s (B_short=8192), on the PyTorch port.

The port of ``benchmarks/table2_cost.py``: the same rows and derived values,
through ``repro_torch`` only (no jax); host arithmetic, no device.

Paper: Azure homogeneous 361 → token-budget 301 (16.6%);
LMSYS 265 → 163 (38.5%). Also reports the closed-form (Eq. 7) prediction
and the corrected (Eq. 8) fleet to reproduce the §4.2 "cost model gap".
"""

from __future__ import annotations

from benchmarks.common import emit, time_us
from repro_torch.core import A100_80G, annual_savings, closed_form_savings
from repro_torch.sim import A100_LLAMA3_70B, plan_fleet
from repro_torch.traces import TraceSpec, generate_trace

TP = 2  # paper §4.1: tensor parallel = 2 → 2 GPUs per instance


def run(num_requests: int = 10_000, rate: float = 1000.0) -> dict:
    out = {}
    for trace in ("azure", "lmsys"):
        reqs = generate_trace(
            TraceSpec(trace=trace, num_requests=num_requests, rate=rate, seed=42)
        )
        us = time_us(
            lambda: plan_fleet(trace, reqs, A100_LLAMA3_70B, rate), repeats=3
        )
        plan = plan_fleet(trace, reqs, A100_LLAMA3_70B, rate)
        naive = closed_form_savings(plan.alpha, plan.rho)
        dollars = annual_savings(plan.g_homo, plan.g_dual, A100_80G, TP)
        emit(
            f"table2/{trace}",
            us,
            f"G_homo={plan.g_homo};G_short={plan.short.instances};"
            f"G_long={plan.long.instances};G_dual={plan.g_dual};"
            f"savings={plan.savings:.3f};eq7_predicts={naive:.3f};"
            f"annual_usd={dollars/1e6:.2f}M",
        )
        out[trace] = plan
    return out


if __name__ == "__main__":
    run()
