"""End-to-end example on the PyTorch port: serve a model with batched
requests through the paper's two-pool system — the port's engines,
continuous batching, token-budget routing, live EMA calibration.

    PYTHONPATH=src python examples/port_serve_two_pools.py [--arch yi-6b] [--device cuda]

The port of ``examples/serve_two_pools.py`` over
:func:`repro_torch.launch.serve.serve` (reduced widths unless the serve
entry point is asked for full width). ``--device`` defaults to ``cuda``
and raises without a GPU; pass ``cpu`` for the plain kernels on the host.
"""

import argparse
from typing import Optional, Sequence

from repro_torch.launch.serve import serve


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve(args.arch, requests=args.requests, device=args.device)


if __name__ == "__main__":
    main()
