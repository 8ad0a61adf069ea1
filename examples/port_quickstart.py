"""Quickstart on the PyTorch port: the paper's algorithm in 60 lines.

    PYTHONPATH=src python examples/port_quickstart.py

The port of ``examples/quickstart.py``, through ``repro_torch`` only (no
jax); it prints the same lines.

1. Estimate a request's token budget from bytes (no tokenizer).
2. Route it between right-sized pools (Algorithm 1).
3. Feed usage.prompt_tokens back → the EMA self-calibrates.
4. Predict fleet savings with the closed-form model (Eq. 7).
"""

import numpy as np

from repro_torch.core import (
    PoolState,
    Request,
    TokenBudgetRouter,
    closed_form_savings,
    long_pool,
    short_pool,
)


def main() -> None:
    # --- 1. two right-sized pools + the router ----------------------------
    router = TokenBudgetRouter(
        PoolState(config=short_pool(c_max=8192)),   # 128 concurrent seqs
        PoolState(config=long_pool(c_max=65_536)),  # 16 concurrent seqs
        b_short=8192,
    )

    # --- 2. route a mixed workload -----------------------------------------
    rng = np.random.default_rng(0)
    requests = [
        # (bytes, max_output_tokens, category, description)
        (1_800, 256, 0, "short chat turn"),
        (120_000, 512, 0, "long RAG context"),
        (900, 8_192, 0, "short prompt, BIG output cap"),
        (6_000, 128, 1, "code completion"),
        (4_000, 256, 2, "CJK text (2.0 bytes/token!)"),
    ]
    for i, (nbytes, max_out, cat, desc) in enumerate(requests):
        d = router.route(Request(i, nbytes, max_out, cat))
        print(f"  {desc:34s} → {d.pool:5s} (est. {d.estimated_total} tokens)")

    # --- 3. closed-loop calibration ----------------------------------------
    print("\ncalibrating CJK from usage.prompt_tokens feedback:")
    before = router.calibrator.conservative_ratio(2)
    for _ in range(50):
        tokens = int(rng.integers(200, 3000))
        router.on_response(
            Request(99, int(tokens * 2.01), 128, 2), prompt_tokens=tokens
        )
    after = router.calibrator.conservative_ratio(2)
    print(f"  bytes/token for CJK: {before:.2f} → {after:.2f} (true: 2.01)")

    # --- 4. audit your own fleet with the closed form -----------------------
    print("\nEq. 7 savings = α(1 − 1/ρ):")
    for alpha, rho in [(0.80, 4.0), (0.92, 4.5), (0.70, 2.0)]:
        print(
            f"  α={alpha:.2f}, ρ={rho:.1f} → "
            f"{closed_form_savings(alpha, rho):.0%} fewer GPUs"
        )
    print("\n(heavy tails need the corrected Eq. 8 — see examples/port_cost_planner.py)")


if __name__ == "__main__":
    main()
