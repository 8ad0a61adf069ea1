"""Table 1: pool configurations and per-instance throughput μ, on the PyTorch port.

The port of ``benchmarks/table1_pools.py``: the same rows and derived values,
through ``repro_torch`` only (no jax); host arithmetic, no device.

Paper values (Azure trace, B_short=8192): homogeneous μ=3.0 / LMSYS 4.1;
short pool μ=13.5 / 6.8; long pool μ=0.4 (Azure). N_seq: 16 / 128 / 16.
"""

from __future__ import annotations

from benchmarks.common import emit, time_us
from repro_torch.sim import A100_LLAMA3_70B, plan_fleet
from repro_torch.traces import TraceSpec, generate_trace


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
        for prof in (plan.homogeneous, plan.short, plan.long):
            emit(
                f"table1/{trace}/{prof.pool}",
                us,
                f"n_seq={prof.n_seq};mu={prof.mu:.2f};iters={prof.mean_iters:.0f}",
            )
            out[f"{trace}/{prof.pool}"] = prof
    return out


if __name__ == "__main__":
    run()
