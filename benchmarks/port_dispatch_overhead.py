"""§2.2 claim on the PyTorch port: dispatch is three comparisons + a
queue-depth lookup — O(1) with sub-microsecond overhead.

The port of ``benchmarks/dispatch_overhead.py``, through ``repro_torch``
only (no jax). Measures the host-side ``route()`` hot path and its
calibration feedback as the reference does, and in place of the
reference's ``jax_route_batch`` the port's batch routing
(:func:`repro_torch.core.route_batch`: the Eq. 3/5 estimate and the
threshold search on tensors) on ``--device``; that row is
``dispatch/torch_batch_per_req`` where the reference's is
``dispatch/jax_batch_per_req``.

    PYTHONPATH=src python -m benchmarks.port_dispatch_overhead --device cuda

``--device`` defaults to ``cuda`` and raises without a GPU; pass ``cpu``
to time the batch path on the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks.common import emit
from repro_torch.core import (
    CalibState,
    PoolState,
    Request,
    TokenBudgetRouter,
    init_state,
    long_pool,
    route_batch,
    short_pool,
)
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n: int = 100_000, device: str = "cuda") -> dict:
    dev = resolve_device(device)
    router = TokenBudgetRouter(
        PoolState(config=short_pool()), PoolState(config=long_pool())
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            request_id=i,
            byte_len=int(rng.integers(64, 64_000)),
            max_output_tokens=int(rng.integers(16, 4096)),
            category=int(rng.integers(0, 4)),
        )
        for i in range(n)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        router.route(r)
    dt = time.perf_counter() - t0
    us = dt / n * 1e6
    emit("dispatch/host_route", us, f"sub_microsecond={us < 1.0}")

    # calibration feedback path
    n_fb = min(n, 10_000)
    t0 = time.perf_counter()
    for r in reqs[:n_fb]:
        router.on_response(r, max(1, r.byte_len // 4))
    us_fb = (time.perf_counter() - t0) / n_fb * 1e6
    emit("dispatch/on_response", us_fb, f"sub_microsecond={us_fb < 1.0}")

    # batch path on the device
    st = CalibState(*(t.to(dev) for t in init_state()))

    def column(field: str) -> torch.Tensor:
        vals = np.asarray([getattr(r, field) for r in reqs], np.int32)
        return torch.as_tensor(vals).to(dev)

    bl, mo, ct = column("byte_len"), column("max_output_tokens"), column("category")
    route_batch(st, bl, mo, ct)  # warm-up (kernel loads, allocator)
    _sync(dev)
    t0 = time.perf_counter()
    pools, _ = route_batch(st, bl, mo, ct)
    _sync(dev)
    us_batch = (time.perf_counter() - t0) / n * 1e6
    emit("dispatch/torch_batch_per_req", us_batch, f"n={n}")
    return {"host_us": us, "batch_us": us_batch, "pools": pools}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.requests, device=args.device)


if __name__ == "__main__":
    main()
