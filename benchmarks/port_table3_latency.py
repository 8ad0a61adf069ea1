"""Table 3 on the PyTorch port: TTFT/TPOT at 1,000 req/s (Azure trace),
fleet-level DES on the torch tier.

The port of ``benchmarks/table3_latency.py``, through ``repro_torch`` only
(no jax), with the same rows and fields. Both fleets run on
``FleetSim(backend="torch", device=...)``, whose decode-advance round is the
``sim_decode`` CUDA kernel on the GPU. The torch tier is the counterpart of
the reference's compiled ``jax`` tier: it folds calibration feedback in
arrival order and runs without spillover, so its numbers equal the
reference's ``jax`` tier with ``spillover=False``, not the reference's
default host run (spillover on).

Paper: homogeneous P50/P99 TTFT 0.02/0.91 s, TPOT 12/13 ms;
token-budget 0.09/1.60 s, 25/29 ms; both meet SLO (TTFT≤2s, TPOT≤80ms);
zero preemptions/rejections at designed sizes (§4.3).

Scale: by default a 1/5-scale fleet (200 req/s, 2,000 requests) whose
per-instance load matches the paper's operating point; ``--full`` runs
1,000 req/s and 10,000 requests.

    PYTHONPATH=src python -m benchmarks.port_table3_latency --device cuda

``--device`` defaults to ``cuda`` and raises without a GPU; pass ``cpu``
for the plain decode-advance round on the host.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

from benchmarks.common import emit
from repro_torch.core.pools import PoolConfig, n_seq_for_cmax
from repro_torch.sim import A100_LLAMA3_70B, plan_fleet, run_fleet
from repro_torch.traces import TraceSpec, generate_trace


def fleets(plan) -> dict:
    """Table 3's two fleets, sized by ``plan``: name -> pools."""
    homo_cfg = PoolConfig("homogeneous", 65_536, 16, headroom=1.08)
    short_cfg = PoolConfig(
        "short", 8192, n_seq_for_cmax(8192), batch_token_budget=16_384,
        headroom=1.05,
    )
    long_cfg = PoolConfig("long", 65_536, 16, headroom=1.02)
    return {
        "homogeneous": {"homogeneous": (homo_cfg, plan.homogeneous.instances)},
        "token-budget": {
            "short": (short_cfg, plan.short.instances),
            "long": (long_cfg, plan.long.instances),
        },
    }


def run(
    trace: str = "azure",
    *,
    full: bool = False,
    seed: int = 42,
    num_requests: Optional[int] = None,
    device: str = "cuda",
) -> dict:
    """Both fleets on the torch tier; ``num_requests`` cuts the trace at
    the scale's rate (tests)."""
    scale = 1.0 if full else 0.2
    rate = 1000.0 * scale
    n_req = int(10_000 * scale) if num_requests is None else num_requests
    reqs = generate_trace(
        TraceSpec(trace=trace, num_requests=n_req, rate=rate, seed=seed)
    )
    plan = plan_fleet(trace, reqs, A100_LLAMA3_70B, rate)

    out = {"plan": plan}
    for name, pools in fleets(plan).items():
        t0 = time.perf_counter()
        res = run_fleet(reqs, pools, A100_LLAMA3_70B, device=device)
        wall = time.perf_counter() - t0
        s = res.summary
        emit(
            f"table3/{trace}/{name}",
            wall * 1e6,
            f"ttft_p50={s.ttft_p50:.3f};ttft_p99={s.ttft_p99:.3f};"
            f"tpot_p50={s.tpot_p50*1e3:.1f}ms;tpot_p99={s.tpot_p99*1e3:.1f}ms;"
            f"preemptions={res.preemptions};rejections={res.rejections};"
            f"success={s.success_rate:.4f};meets_slo={s.meets_slo()}",
        )
        out[name.replace("-", "_")] = res
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="azure", choices=["azure", "lmsys"])
    ap.add_argument("--full", action="store_true",
                    help="1,000 req/s and 10,000 requests (default: 1/5 scale)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.trace, full=args.full, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
