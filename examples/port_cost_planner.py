"""Fleet cost planner on the PyTorch port: audit the savings opportunity
for YOUR workload before touching infrastructure (the paper's contribution
3).

    PYTHONPATH=src python examples/port_cost_planner.py \
        --trace azure --rate 1000 --b-short 8192

The port of ``examples/cost_planner.py``, through ``repro_torch`` only (no
jax); it prints the same lines.

Prints the closed-form estimate (Eq. 7), the corrected fleet (Eq. 8), the
threshold sensitivity curve, and dollar figures.
"""

import argparse

from repro_torch.core import A100_80G, annual_savings, closed_form_savings
from repro_torch.sim import A100_LLAMA3_70B, plan_fleet, sensitivity_sweep
from repro_torch.traces import TraceSpec, generate_trace


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="azure", choices=["azure", "lmsys"])
    ap.add_argument("--rate", type=float, default=1000.0)
    ap.add_argument("--b-short", type=int, default=8192)
    ap.add_argument("--gpus-per-instance", type=int, default=2)
    args = ap.parse_args()

    reqs = generate_trace(
        TraceSpec(trace=args.trace, num_requests=10_000, rate=args.rate, seed=42)
    )
    plan = plan_fleet(
        args.trace, reqs, A100_LLAMA3_70B, args.rate, b_short=args.b_short
    )

    print(f"=== {args.trace} @ {args.rate:.0f} req/s, B_short={args.b_short} ===")
    print(f"α (short fraction): {plan.alpha:.3f}   ρ (μ_s/μ_h): {plan.rho:.2f}")
    print(f"Eq. 7 (planning estimate): {closed_form_savings(plan.alpha, plan.rho):.1%}")
    print(
        f"Eq. 8 (corrected fleet):   {plan.savings:.1%}  "
        f"[{plan.g_homo} → {plan.g_dual} instances]"
    )
    print(
        f"  homogeneous: {plan.g_homo} × μ={plan.homogeneous.mu:.2f}\n"
        f"  short pool:  {plan.short.instances} × μ={plan.short.mu:.2f} "
        f"(N_seq={plan.short.n_seq})\n"
        f"  long pool:   {plan.long.instances} × μ={plan.long.mu:.2f}"
    )
    dollars = annual_savings(
        plan.g_homo, plan.g_dual, A100_80G, args.gpus_per_instance
    )
    print(f"annual savings @ ${A100_80G.cost_per_hour}/GPU-hr: ${dollars/1e6:.2f}M")

    print("\nthreshold sensitivity (Fig. 6):")
    for p in sensitivity_sweep(args.trace, reqs, A100_LLAMA3_70B, args.rate):
        bar = "#" * int(p.savings * 80)
        print(f"  B_short={p.b_short:>6}: {p.savings:6.1%} {bar}")
    print("\nguidance (§8): heavy tails → push B_short up; concentrated →")
    print("set it at the distribution's effective support. 8K–16K is forgiving.")


if __name__ == "__main__":
    main()
