"""Windowed telemetry on the port's torch DES tier against the reference's.

``FleetSim(backend="torch", device="cpu", telemetry=TelemetryConfig(...))``
snapshots each window on the device and replays the snapshots into the host
``FleetTelemetry`` after the run, as the reference's compiled ``jax`` tier
does. Held here:

* the exact class (``TestJaxBackendEquivalence::
  test_telemetry_windows_identical`` of ``tests/test_vector_engine.py``:
  one pool of 4 x ``PoolConfig("p", 4096, 16)``, dyadic timing, 1,500
  Poisson requests at 250 req/s, seed 11, window 100): every column equals
  the reference's ``vectorized`` and ``jax`` tiers' bit for bit;
* routed fleets with an ``AdaptiveController`` in the loop, at P = 2 (the
  Table-2 fleet with its short pool cut to 30 %) and P = 3 (the 4K / 16K /
  64K topology with its smallest pool cut to 30 %), at a reduced n: the
  columns, the controller's history and the records equal the jax tier's;
* telemetry changes nothing: the records, ``iters``, ``rounds`` and
  ``host_syncs`` are the same with it on and off;
* event tracing is still refused on the torch tier.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import sim as R  # noqa: E402
from repro import traces as Rtraces  # noqa: E402
from repro.obs import TelemetryConfig as RTelemetry  # noqa: E402
from repro.sim import jax_engine  # noqa: E402
from repro_torch import sim as T  # noqa: E402
from repro_torch import traces as Ttraces  # noqa: E402
from repro_torch.obs import TelemetryConfig as TTelemetry  # noqa: E402
from repro_torch.obs import validate_telemetry  # noqa: E402
from repro_torch.sim import torch_engine  # noqa: E402
from test_torch_sim import (  # noqa: E402
    Rcore,
    Tcore,
    dyadic,
    poisson_trace,
    record_tuples,
    three_pool_topology,
)

PKG = {
    "jax": (R, Rcore, Rtraces, RTelemetry, jax_engine),
    "vectorized": (R, Rcore, Rtraces, RTelemetry, None),
    "torch": (T, Tcore, Ttraces, TTelemetry, torch_engine),
}


def assert_same_series(got, want):
    """Same sample count, same column set, every column equal bit for bit
    (NaN where the reference has NaN)."""
    assert got.num_samples == want.num_samples > 0
    assert set(got.columns) == set(want.columns)
    for name in want.columns:
        assert np.array_equal(got.column(name), want.column(name), equal_nan=True), name


def run_exact(tier, *, telemetry=True):
    pkg, core, _, tel_cls, engine = PKG[tier]
    cfg = core.PoolConfig("p", 4096, 16)
    kw = {"device": "cpu"} if tier == "torch" else {}
    sim = pkg.FleetSim(
        {"p": (cfg, 4)}, dyadic(pkg), backend=tier, coalesce_dt=0.0, control_window=100,
        telemetry=tel_cls(window=100, events=False) if telemetry else None, **kw,
    )
    res = sim.run(poisson_trace(core, 1500, 250.0, 11))
    return sim, res, engine.last_run_stats() if engine else None


class TestExactClassWindows:
    """The reference's ``test_telemetry_windows_identical`` with the torch
    tier beside the reference's two tiers."""

    @pytest.fixture(scope="class")
    def runs(self):
        out = {tier: run_exact(tier) for tier in ("vectorized", "jax", "torch")}
        out["torch_off"] = run_exact("torch", telemetry=False)
        return out

    @pytest.mark.parametrize("tier", ["vectorized", "jax"])
    def test_columns_equal_the_reference(self, runs, tier):
        assert_same_series(runs["torch"][1].telemetry, runs[tier][1].telemetry)

    def test_export_validates_and_deltas_sum(self, runs):
        res = runs["torch"][1]
        doc = validate_telemetry(res.telemetry.to_json())
        assert doc["num_samples"] == 1500 // 100 + 1
        for fam, total in (("preemptions", res.preemptions), ("rejections", res.rejections),
                           ("truncations", res.truncations)):
            assert sum(res.telemetry.columns[f"{fam}.p"]) == total, fam

    def test_on_and_off_run_the_same_loop(self, runs):
        (s_on, r_on, on), (s_off, r_off, off) = runs["torch"], runs["torch_off"]
        assert r_off.telemetry is None
        assert {k: on[k] for k in ("iters", "rounds", "host_syncs")} == {
            k: off[k] for k in ("iters", "rounds", "host_syncs")
        }
        assert record_tuples(r_on, s_on) == record_tuples(r_off, s_off)


def controlled_fleet(tier, n_pools, *, telemetry=True):
    """A routed fleet with the AIMD controller: its smallest pool cut to
    30 % of its sized instances, so boundaries move."""
    pkg, core, traces, tel_cls, engine = PKG[tier]
    n, rate = 800, 400.0
    trace = traces.generate_trace(
        traces.TraceSpec(trace="azure", num_requests=n, rate=rate, seed=42)
    )
    kw = {"device": "cpu"} if tier == "torch" else {}
    if n_pools == 3:
        pools, thresholds = three_pool_topology(pkg, core, trace, rate)
        kw["thresholds"] = thresholds
    else:
        plan = pkg.plan_fleet("azure", trace, pkg.A100_LLAMA3_70B, rate)
        pools = {
            "short": (core.PoolConfig("short", 8192, core.n_seq_for_cmax(8192), headroom=1.05,
                                      queue_limit=64), plan.short.instances),
            "long": (core.PoolConfig("long", 65_536, 16, headroom=1.02, queue_limit=64),
                     plan.long.instances),
        }
    first = min(pools, key=lambda k: pools[k][0].c_max)
    cfg, inst = pools[first]
    pools[first] = (cfg, max(1, int(inst * 0.3)))
    ctrl = core.AdaptiveController(b_min=512)
    sim = pkg.FleetSim(
        pools, pkg.A100_LLAMA3_70B, backend=tier, spillover=False, controller=ctrl,
        control_window=100, telemetry=tel_cls(window=100, events=False) if telemetry else None,
        **kw,
    )
    res = sim.run(trace)
    return sim, res, ctrl, engine.last_run_stats()


class TestControlledRoutedWindows:
    """Routed fleets with the controller in the loop: the jax tier and the
    torch tier sample the same windows, move the same boundaries and
    produce the same records."""

    @pytest.fixture(scope="class", params=[2, 3], ids=["P2", "P3"])
    def runs(self, request):
        return {
            "p": request.param,
            "jax": controlled_fleet("jax", request.param),
            "torch": controlled_fleet("torch", request.param),
            "torch_off": controlled_fleet("torch", request.param, telemetry=False),
        }

    def test_columns_equal_the_jax_tier(self, runs):
        got, want = runs["torch"][1].telemetry, runs["jax"][1].telemetry
        assert_same_series(got, want)
        assert sum(c.startswith("threshold.") for c in got.columns) == runs["p"] - 1
        validate_telemetry(got.to_json())

    def test_controller_history_equal_the_jax_tier(self, runs):
        tc, jc = runs["torch"][2], runs["jax"][2]
        assert tc.history, "the controller never moved a boundary"
        assert [dataclasses.astuple(m) for m in tc.history] == [
            dataclasses.astuple(m) for m in jc.history
        ]
        assert tc.thresholds == jc.thresholds
        # the last window's threshold columns are the final boundary vector
        tel = runs["torch"][1].telemetry
        assert [tel.column(f"threshold.{k}")[-1] for k in range(runs["p"] - 1)] == tc.thresholds

    def test_records_equal_the_jax_tier(self, runs):
        (js, jr, _, jst), (ts, tr, _, tst) = runs["jax"], runs["torch"]
        assert record_tuples(tr, ts) == record_tuples(jr, js)
        assert (tst["iters"], tst["rounds"]) == (jst["iters"], jst["rounds"])

    def test_on_and_off_run_the_same_loop(self, runs):
        (s_on, r_on, c_on, on), (s_off, r_off, c_off, off) = runs["torch"], runs["torch_off"]
        assert {k: on[k] for k in ("iters", "rounds", "host_syncs")} == {
            k: off[k] for k in ("iters", "rounds", "host_syncs")
        }
        assert record_tuples(r_on, s_on) == record_tuples(r_off, s_off)
        assert c_on.history == c_off.history


def test_event_tracing_still_refused():
    cfg = Tcore.PoolConfig("p", 4096, 16)
    with pytest.raises(ValueError, match="event tracing"):
        T.FleetSim({"p": (cfg, 2)}, dyadic(T), backend="torch", device="cpu",
                   telemetry=TTelemetry(window=64, events=True))


def test_port_telemetry_smoke_equals_the_reference():
    """``benchmarks/port_telemetry_smoke.py``: its vectorized-tier checks
    emit the reference script's rows (timing left out), and its torch-tier
    run on the CPU passes its own checks (export, deltas, records, rounds
    and host syncs equal to a run without telemetry)."""
    from benchmarks import common, port_telemetry_smoke, telemetry_smoke

    rows = {}
    for name, mod in (("ref", telemetry_smoke), ("port", port_telemetry_smoke)):
        common.reset_rows()
        mod.run(400, 40.0)
        rows[name] = [(n, d) for n, _, d in common._ROWS]
    common.reset_rows()
    assert rows["port"] == rows["ref"] and len(rows["ref"]) == 2
    out = port_telemetry_smoke.run_torch(400, 40.0, device="cpu")
    assert common._ROWS[-1][0] == "obs/telemetry_smoke/torch"
    common.reset_rows()
    assert out["telemetry"].num_samples == 400 // 100 + 1
