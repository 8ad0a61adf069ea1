"""Table 5 / §4.7: Qwen3-235B-A22B on MI300X at 10,000 req/s, on the PyTorch port.

The port of ``benchmarks/table5_mi300x.py``: the same rows and derived values,
through ``repro_torch`` only (no jax); host arithmetic, no device.

Memory math (exact reproduction): 23.5 KB/token/GPU KV, 133.4 GB KV budget,
676 vs 169 concurrent sequences (4×).

Fleet projection: the paper's Table 5 is the *analytical* (Eq. 6/7) bound —
homogeneous 197 nodes → token-budget 137 nodes (30.5%), $15.4 M/yr at
$3.67/GPU-hr — computed with the full-mix throughput at both slot counts
(the paper itself notes "the formula provides an upper bound"). We
reproduce that bound, then ALSO apply the corrected fleet formula (Eq. 8)
with routed-traffic long-pool throughput — the paper's own §4.2 correction,
which it does not apply to Table 5 — and report both.
"""

from __future__ import annotations

import math

from benchmarks.common import emit, time_us
from repro_torch.core import MI300X, annual_cost, mi300x_case_study
from repro_torch.sim import TimingModel
from repro_torch.sim.profiler import mean_iterations, split_by_budget
from repro_torch.traces import TraceSpec, generate_trace

GPUS_PER_NODE = 8
PAPER_HOMO_NODES = 197  # paper's homogeneous operating point


def run(rate: float = 10_000.0, b_short: int = 8192) -> dict:
    # --- memory side (Eq. 1–2, exact) ---
    cs = mi300x_case_study()
    us = time_us(mi300x_case_study, repeats=10)
    emit(
        "table5/memory",
        us,
        f"kv_kb_per_tok_gpu={cs.kv_kb_per_token_per_gpu:.1f};"
        f"kv_budget_gb={cs.kv_budget_gb_per_gpu:.1f};"
        f"n_seq_8k={cs.n_seq_short};n_seq_32k={cs.n_seq_long};"
        f"ratio={cs.concurrency_ratio:.1f}",
    )

    # --- timing constants back-derived from the paper's operating point ---
    reqs = generate_trace(
        TraceSpec(trace="azure", num_requests=10_000, rate=rate, seed=42)
    )
    probe = TimingModel("probe", 1e-3, 0.0)
    mean_iters = mean_iterations(reqs, probe)
    mu_homo = rate / PAPER_HOMO_NODES
    t_iter_long = cs.n_seq_long / (mu_homo * mean_iters)
    # keep the A100 calibration's W:(H·n) split (8.0 : 0.65×16)
    w = 0.435 * t_iter_long
    h = 0.565 * t_iter_long / cs.n_seq_long
    timing = TimingModel("mi300x-qwen3-derived", w, h)

    # --- paper's analytical projection: Eq. 7 with full-mix throughputs ---
    mu_short_fullmix = timing.throughput(mean_iters, cs.n_seq_short)
    rho = mu_short_fullmix / mu_homo
    alpha = sum(1 for r in reqs if r.true_total <= b_short) / len(reqs)
    savings_eq7 = alpha * (1.0 - 1.0 / rho)
    nodes_dual_eq7 = math.ceil(PAPER_HOMO_NODES * (1.0 - savings_eq7))
    dollars = (
        annual_cost(PAPER_HOMO_NODES, MI300X, GPUS_PER_NODE)
        - annual_cost(nodes_dual_eq7, MI300X, GPUS_PER_NODE)
    )
    emit(
        "table5/fleet_eq7_paper",
        us,
        f"nodes_homo={PAPER_HOMO_NODES};nodes_dual={nodes_dual_eq7};"
        f"gpus_homo={PAPER_HOMO_NODES*GPUS_PER_NODE};"
        f"gpus_dual={nodes_dual_eq7*GPUS_PER_NODE};"
        f"savings={savings_eq7:.3f};annual_usd={dollars/1e6:.1f}M;"
        f"rho={rho:.2f};alpha={alpha:.3f}",
    )

    # --- corrected Eq. 8 with routed-traffic throughputs (our addition) ---
    short_reqs, long_reqs = split_by_budget(reqs, b_short)
    mu_short = timing.throughput(
        mean_iterations(short_reqs, probe), cs.n_seq_short
    )
    mu_long = timing.throughput(
        mean_iterations(long_reqs, probe), cs.n_seq_long
    )
    nodes_dual_eq8 = math.ceil(alpha * rate / mu_short) + math.ceil(
        (1 - alpha) * rate / mu_long
    )
    savings_eq8 = (PAPER_HOMO_NODES - nodes_dual_eq8) / PAPER_HOMO_NODES
    emit(
        "table5/fleet_eq8_corrected",
        us,
        f"nodes_dual={nodes_dual_eq8};savings={savings_eq8:.3f};"
        f"mu_short={mu_short:.1f};mu_long={mu_long:.2f};"
        f"note=eq7-is-upper-bound-per-paper-s4.7",
    )
    return {
        "case_study": cs,
        "nodes_dual_eq7": nodes_dual_eq7,
        "savings_eq7": savings_eq7,
        "nodes_dual_eq8": nodes_dual_eq8,
        "savings_eq8": savings_eq8,
    }


if __name__ == "__main__":
    run()
