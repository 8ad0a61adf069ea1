"""Two-pool serving entry point of the port (the paper's system, end to end).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --requests 40
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-235b-a22b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --device cpu

Builds a model (reduced widths unless ``--full-width``; any token-frontend
config: the dense family, the MoE family, the zamba2 hybrid or the xLSTM),
a short pool and a long pool, routes a synthetic workload through
Algorithm 1 with live EMA calibration, and prints per-pool outcomes and
router statistics. Runs on the GPU; ``--device cpu``
runs the plain PyTorch versions of the kernels. Counterpart of
``repro.launch.serve``; :func:`run_workload` drives any ``TwoPoolServer``
(an int8-KV model, say) with the same draw.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.categories import TRUE_BYTES_PER_TOKEN, Category
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving import SamplingParams, TwoPoolServer


def serve(
    arch: str = "yi-6b",
    *,
    requests: int = 40,
    short_cmax: int = 128,
    long_cmax: int = 512,
    short_slots: int = 8,
    long_slots: int = 2,
    seed: int = 0,
    temperature: float = 0.0,
    full_width: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Serve ``requests`` synthetic requests; returns the responses, the
    server's statistics, the wall time and the server itself."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full_width else get_config(arch).reduced()
    model = Model(cfg)
    params = model.init(0, device=dev)
    srv = TwoPoolServer(
        model,
        params,
        short_cmax=short_cmax,
        long_cmax=long_cmax,
        short_slots=short_slots,
        long_slots=long_slots,
        sampling=SamplingParams(temperature=temperature),
    )
    return run_workload(srv, requests=requests, seed=seed)


def run_workload(srv: TwoPoolServer, *, requests: int, seed: int = 0) -> dict:
    """Drive ``srv`` with the synthetic draw (prompts of 4 to short c_max/2
    tokens, ~10% asking for 0.6 of the long c_max in output) and print
    what ``serve`` prints."""
    cfg = srv.short_engine.model.cfg
    dev = srv.short_engine.device
    short_cmax, long_cmax = srv.short_engine.c_max, srv.long_engine.c_max
    rng = np.random.default_rng(seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(requests):
        cat = Category(int(rng.integers(0, 4)))
        n = int(rng.integers(4, short_cmax // 2))
        toks = [int(t) for t in rng.integers(0, cfg.vocab, n)]
        # ~10% are short-prompt/long-generation (the paper's hard case)
        mx = int(long_cmax * 0.6) if rng.random() < 0.1 else int(rng.integers(2, 12))
        nbytes = int(n * TRUE_BYTES_PER_TOKEN[cat] + rng.normal(0, 4))
        srv.submit(i, toks, max(1, nbytes), mx, category=int(cat))
        # interleave arrival with service (continuous batching)
        if i % 4 == 3:
            srv.step()
    srv.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    responses = srv.responses  # includes completions from interleaved steps

    stats = srv.stats()
    by_pool = {"short": 0, "long": 0}
    for r in responses:
        by_pool[r.pool] += 1
    print(f"[serve] {cfg.name} on {dev}: {len(responses)} responses in {wall:.2f}s")
    print(f"[serve] pool split: {by_pool}")
    print(f"[serve] router: {stats['router']['routed_short']} short, "
          f"{stats['router']['routed_long']} long, "
          f"{stats['router']['spill_count']} spills")
    cal = stats["router"]["calibration"]
    for cat in Category:
        true_c = TRUE_BYTES_PER_TOKEN[cat]
        print(
            f"[serve] calib {cat.name}: learned "
            f"{cal['ratio'][int(cat)]:.2f} (true {true_c:.2f}, "
            f"n={cal['count'][int(cat)]})"
        )
    return {
        "responses": responses,
        "stats": stats,
        "wall_s": wall,
        "by_pool": by_pool,
        "server": srv,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b",
                    help="a config of the dense family (yi-6b, granite-3-8b, granite-34b, "
                         "gemma-2b, llama3-70b), the MoE family (qwen3-235b-a22b, "
                         "llama4-scout-17b-a16e, llama4-maverick-400b-a17b), the hybrid "
                         "(zamba2-2.7b) or the xLSTM (xlstm-350m); qwen2-vl-7b and "
                         "musicgen-medium take embeddings, which the engine does not serve")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--short-cmax", type=int, default=128)
    ap.add_argument("--long-cmax", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published widths instead of .reduced()")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(
        args.arch,
        requests=args.requests,
        short_cmax=args.short_cmax,
        long_cmax=args.long_cmax,
        temperature=args.temperature,
        full_width=args.full_width,
        device=args.device,
    )


if __name__ == "__main__":
    main()
