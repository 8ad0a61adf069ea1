"""Telemetry smoke on the PyTorch port: schema-valid exports and the
zero-perturbation guarantee, on the vectorized tier and on the torch tier.

The port of ``benchmarks/telemetry_smoke.py``, through ``repro_torch``
only (no jax). It drives a surge scenario (burst arrivals at 2× the
provisioned rate) twice:

* through the port's ``vectorized`` tier with full telemetry — windowed
  sampling plus event tracing — with the reference script's three checks:

  1. the exported telemetry JSON, events JSONL and Chrome trace all
     validate against the ``repro.obs`` schemas;
  2. the windowed deltas sum to the run's end-of-run counters;
  3. the ``SimSummary`` of a run with the registry and tracer installed is
     bit-identical to a run without any telemetry objects;

* through the torch tier on ``--device`` with windows only (the tier
  traces no events): the telemetry JSON validates, the windowed deltas sum
  to the end-of-run counters, and every record, the loop's rounds and its
  host syncs equal a run without telemetry.

    PYTHONPATH=src python -m benchmarks.port_telemetry_smoke --device cuda

``--device`` defaults to ``cuda`` and raises without a GPU; pass ``cpu``
for the plain decode-advance round on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from benchmarks.common import emit
from repro_torch.core.pools import PoolConfig, n_seq_for_cmax
from repro_torch.obs import (
    TelemetryConfig,
    validate_chrome_trace,
    validate_events_jsonl,
    validate_telemetry,
)
from repro_torch.obs.validate import check_window_deltas
from repro_torch.sim import A100_LLAMA3_70B, FleetSim
from repro_torch.sim.fleet import record_columns, same_records
from repro_torch.sim import torch_engine
from repro_torch.traces import TraceSpec, generate_trace_columns


def _surge_fleet(num_requests: int, rate: float, seed: int):
    cols = generate_trace_columns(
        TraceSpec(
            trace="azure",
            num_requests=num_requests,
            rate=rate,
            seed=seed,
            rate_profile="burst",
            rate_amplitude=2.0,
            rate_period=0.2 * num_requests / rate,
        )
    )
    pools = {
        "short": (
            PoolConfig(
                "short", 8192, n_seq_for_cmax(8192), queue_limit=64
            ),
            4,
        ),
        "long": (PoolConfig("long", 65_536, 16, queue_limit=64), 2),
    }
    return cols, pools


def _run(cols, pools, telemetry, *, window: int = 100, backend: str = "vectorized",
         device: str = "cuda"):
    kw = {"device": device} if backend == "torch" else {}
    sim = FleetSim(
        dict(pools),
        A100_LLAMA3_70B,
        b_short=8192,
        backend=backend,
        telemetry=telemetry,
        control_window=window,
        **kw,
    )
    return sim, sim.run(cols)


def run(num_requests: int = 1000, rate: float = 100.0, seed: int = 42) -> dict:
    """The reference script's three checks on the vectorized tier."""
    cols, pools = _surge_fleet(num_requests, rate, seed)

    t0 = time.perf_counter()
    _, res = _run(cols, pools, TelemetryConfig(window=100, events=True))
    wall = (time.perf_counter() - t0) * 1e6
    tel = res.telemetry

    # 1) Every export validates against its schema.
    validate_telemetry(tel.to_json())
    events = validate_events_jsonl(tel.events.to_jsonl())
    trace_doc = validate_chrome_trace(tel.events.to_chrome_trace())

    # 2) Windowed deltas reconcile with the end-of-run counters.
    check_window_deltas(tel, res)

    # 3) Zero perturbation: with telemetry fully off, the SimSummary is
    # bit-identical to a run that never constructed a registry or tracer.
    _, plain = _run(cols, pools, None)
    _, with_tel = _run(cols, pools, TelemetryConfig(window=100, events=True))
    a = dataclasses.asdict(plain.summary)
    b = dataclasses.asdict(with_tel.summary)
    if a != b:
        diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
        raise AssertionError(f"telemetry perturbed the simulation: {diff}")

    emit(
        "obs/telemetry_smoke/surge",
        wall,
        f"samples={tel.num_samples};events={len(events)};"
        f"trace_events={len(trace_doc['traceEvents'])};"
        f"dropped={tel.events.dropped};success={res.summary.success_rate:.4f}",
    )
    emit(
        "obs/telemetry_smoke/bit_identity",
        0.0,
        "summary_identical=1",
    )
    return {"result": res, "telemetry": tel}


def run_torch(num_requests: int = 1000, rate: float = 100.0, seed: int = 42,
              *, device: str = "cuda") -> dict:
    """The surge fleet on the torch tier with windows only: the export
    validates, the deltas reconcile, and the records, rounds and host syncs
    equal a run without telemetry."""
    cols, pools = _surge_fleet(num_requests, rate, seed)
    runs = {}
    for key, tel_cfg in (("tel", TelemetryConfig(window=100, events=False)), ("plain", None)):
        t0 = time.perf_counter()
        sim, res = _run(cols, pools, tel_cfg, backend="torch", device=device)
        wall = (time.perf_counter() - t0) * 1e6
        runs[key] = (sim, res, torch_engine.last_run_stats(), wall)
    (sim_t, res_t, st_t, wall), (sim_p, res_p, st_p, _) = runs["tel"], runs["plain"]
    tel = res_t.telemetry
    validate_telemetry(tel.to_json())
    check_window_deltas(tel, res_t)
    if not same_records(record_columns(sim_t), record_columns(sim_p)):
        raise AssertionError("telemetry changed the torch tier's records")
    for key in ("iters", "rounds", "host_syncs"):
        if st_t[key] != st_p[key]:
            raise AssertionError(f"telemetry changed the loop's {key}: {st_t} vs {st_p}")
    if dataclasses.asdict(res_t.summary) != dataclasses.asdict(res_p.summary):
        raise AssertionError("telemetry changed the torch tier's summary")
    t_sim = np.asarray(tel.column("t_sim"))
    emit(
        "obs/telemetry_smoke/torch",
        wall,
        f"samples={tel.num_samples};t_end={t_sim[-1]:.3f};rounds={st_t['rounds']};"
        f"host_syncs={st_t['host_syncs']};records_identical=1;"
        f"success={res_t.summary.success_rate:.4f}",
    )
    return {"result": res_t, "telemetry": tel, "stats": st_t}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--rate", type=float, default=None,
                    help="arrival rate (default: requests/10 → 10 s trace)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jsonl-out", default=None,
                    help="also write the events JSONL export to this path")
    ap.add_argument("--trace-out", default=None,
                    help="also write the Chrome trace export to this path")
    args = ap.parse_args()
    rate = args.rate if args.rate is not None else args.requests / 10.0
    out = run(args.requests, rate, args.seed)
    tel = out["telemetry"]
    if args.jsonl_out:
        with open(args.jsonl_out, "w") as f:
            f.write(tel.events.to_jsonl())
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(tel.events.to_chrome_trace())
    run_torch(args.requests, rate, args.seed, device=args.device)


if __name__ == "__main__":
    main()
