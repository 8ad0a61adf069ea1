"""Figure 6 on the PyTorch port: savings vs B_short threshold sweep.

The port of ``benchmarks/fig6_sensitivity.py``, through ``repro_torch``
only (no jax), with the same row names and fields:

* :func:`run` — the paper's analytic sweep (planner arithmetic, resizes
  the short pool's ``C_max`` with each threshold), on the host.
* :func:`run_des` (``--des``) — DES validation of the routing-threshold
  axis at fixed capacity: one :func:`repro_torch.sim.run_fleet_grid` call
  runs every threshold lane as one batched run on ``--device`` (one
  ``sim_decode`` launch a round for all lanes) and reports goodput / P99
  TTFT / routed fraction per lane. As in the reference, this sweeps the
  routing boundary at a fixed short-pool ``C_max`` (the largest
  threshold).

    PYTHONPATH=src python -m benchmarks.port_fig6_sensitivity --des --device cuda

``--device`` defaults to ``cuda`` and raises without a GPU; pass ``cpu``
for the plain decode-advance round on the host.
"""

from __future__ import annotations

import argparse

import numpy as np

from benchmarks.common import emit, time_us
from repro_torch.core.pools import PoolConfig, n_seq_for_cmax
from repro_torch.sim import A100_LLAMA3_70B, run_fleet_grid, sensitivity_sweep
from repro_torch.traces import TraceSpec, generate_trace, generate_trace_columns

THRESHOLDS = (2048, 4096, 8192, 16_384, 32_768)


def run(num_requests: int = 10_000, rate: float = 1000.0) -> dict:
    out = {}
    for trace in ("azure", "lmsys"):
        reqs = generate_trace(
            TraceSpec(trace=trace, num_requests=num_requests, rate=rate, seed=42)
        )
        us = time_us(
            lambda: sensitivity_sweep(trace, reqs, A100_LLAMA3_70B, rate, THRESHOLDS),
            repeats=2,
        )
        plans = sensitivity_sweep(trace, reqs, A100_LLAMA3_70B, rate, THRESHOLDS)
        curve = {p.b_short: p.savings for p in plans}
        peak = max(curve.values())
        for p in plans:
            emit(
                f"fig6/{trace}/b{p.b_short}",
                us,
                f"savings={p.savings:.3f};alpha={p.alpha:.4f};"
                f"n_seq={p.short.n_seq};frac_of_peak="
                f"{p.savings/peak if peak > 0 else 0:.2f}",
            )
        out[trace] = curve
    return out


def des_pools(thresholds: tuple[int, ...] = THRESHOLDS) -> dict:
    """The reference's DES fleet: short pool at ``C_max = max(thresholds)``
    x 2 instances, long pool 65,536 x 1."""
    c_short = max(thresholds)
    return {
        "short": (PoolConfig("short", c_short, n_seq_for_cmax(c_short), headroom=1.05), 2),
        "long": (PoolConfig("long", 65_536, 16, headroom=1.02), 1),
    }


def run_des(
    num_requests: int = 2000,
    rate: float = 20.0,
    seed: int = 42,
    thresholds: tuple[int, ...] = THRESHOLDS,
    device: str = "cuda",
) -> dict:
    """Threshold sensitivity at DES fidelity: one batched grid per trace.

    Grid metrics are full-run (no warm-up discard), spillover off — the
    grid's documented semantics, as in the reference.
    """
    out = {}
    ths = [[int(b)] for b in thresholds]
    pools = des_pools(thresholds)
    for trace in ("azure", "lmsys"):
        cols = generate_trace_columns(
            TraceSpec(trace=trace, num_requests=num_requests, rate=rate, seed=seed)
        )
        us = time_us(
            lambda: run_fleet_grid(cols, pools, A100_LLAMA3_70B, thresholds=ths, device=device),
            repeats=2,
        )
        grid = run_fleet_grid(cols, pools, A100_LLAMA3_70B, thresholds=ths, device=device)
        goodput = grid.goodput()
        short_frac = grid.routed[:, 0] / np.maximum(grid.routed.sum(axis=1), 1)
        for i, b in enumerate(thresholds):
            emit(
                f"fig6/des/{trace}/b{b}",
                us,
                f"goodput={goodput[i]:.1f};ttft_p99={grid.ttft_p99[i]:.3f};"
                f"short_frac={short_frac[i]:.3f};completed={grid.completed[i]};"
                f"preempt={grid.preemptions[i]}",
            )
        out[trace] = {int(b): float(g) for b, g in zip(thresholds, goodput)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--des", action="store_true",
                    help="also run the DES-fidelity batched threshold grid")
    ap.add_argument("--requests", type=int, default=2000,
                    help="trace size for the DES grid (analytic sweep uses 10k)")
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="device of the DES grid (cuda or cpu)")
    args = ap.parse_args()
    run()
    if args.des:
        run_des(args.requests, args.rate, args.seed, device=args.device)


if __name__ == "__main__":
    main()
