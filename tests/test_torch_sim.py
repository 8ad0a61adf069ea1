"""The port's fleet DES against the reference's.

The torch tier (``FleetSim(backend="torch", device="cpu")``, the plain
decode-advance round) is held against the reference's compiled ``jax`` tier:
bit-identical records and equal ``iters`` / ``rounds`` in the exact classes
(routerless single pool, ``coalesce_dt=0``, dyadic timing), in the routed
class (two pools, arrival-ordered calibration feedback, spillover off) and
with the adaptive controller in the loop. The port's host tiers are held
against the reference's where the reference's own tests say its tiers are
equal, and the Table-2 fleet plan and cost model against the reference's.

Mirrors ``TestExactEquivalence``, ``TestJaxBackendEquivalence``,
``TestCoalescedJumpEquivalence``, ``TestJaxRoutedTolerance`` and
``TestControllerInTheLoop`` of ``tests/test_vector_engine.py``, at the same
traces except where a smaller n keeps this file near two minutes, and adds
the three-pool topology and a ``TraceColumns``-fed fleet on the torch tier.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import sim as R  # noqa: E402
from repro import traces as Rtraces  # noqa: E402
from repro.core import adaptive as _ra, cost_model as Rcost, pools as _rp, router as _rr  # noqa: E402
from repro.sim import jax_engine  # noqa: E402
from repro_torch import sim as T  # noqa: E402
from repro_torch import traces as Ttraces  # noqa: E402
from repro_torch.core import adaptive as _ta, cost_model as Tcost, pools as _tp, router as _tr  # noqa: E402
from repro_torch.kernels.sim_decode import decode_advance  # noqa: E402
from repro_torch.sim import torch_engine  # noqa: E402


def _core(pools, router, adaptive):
    return SimpleNamespace(
        PoolConfig=pools.PoolConfig, n_seq_for_cmax=pools.n_seq_for_cmax,
        Request=router.Request, AdaptiveController=adaptive.AdaptiveController,
    )


Rcore, Tcore = _core(_rp, _rr, _ra), _core(_tp, _tr, _ta)

SUMMARY_FIELDS = (
    "num_requests", "completed", "rejected", "truncated", "preemptions",
    "ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99", "makespan",
)


def dyadic(pkg):
    return pkg.TimingModel("dyadic", w_base=2**-10, h_per_seq=2**-13, prefill_chunk=512)


def poisson_trace(core, n, rate, seed, *, l_in=(16, 3000), l_out=(1, 400)):
    """``tests/test_vector_engine.py``'s trace, as ``core.Request``s."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    return [
        core.Request(
            request_id=i,
            byte_len=int(rng.integers(4, 12_000)),
            max_output_tokens=int(rng.integers(*l_out)),
            category=int(rng.integers(0, 4)),
            arrival_time=float(arrivals[i]),
            true_input_tokens=int(rng.integers(*l_in)),
            true_output_tokens=int(rng.integers(*l_out)),
        )
        for i in range(n)
    ]


def record_tuples(result, sim):
    recs = result.records if result.records is not None else [
        r for p in sim.pools.values() for r in p.records
    ]
    return sorted(
        (r.request_id, r.arrival, r.first_token, r.finish, r.output_tokens,
         r.preemptions, r.truncated, r.rejected)
        for r in recs
    )


def run_single_pool(pkg, core, trace_args, cfg_args, instances, backend, *, total_blocks=None):
    trace = poisson_trace(core, *trace_args[:3], **trace_args[3])
    cfg = core.PoolConfig("p", *cfg_args)
    kw = {"device": "cpu"} if backend == "torch" else {}
    sim = pkg.FleetSim(
        {"p": (cfg, instances)}, dyadic(pkg), backend=backend, coalesce_dt=0.0, **kw
    )
    if total_blocks is not None:
        pool = sim.pools["p"]
        if backend == "reference":
            for inst in pool.instances:
                inst.total_blocks = total_blocks
                inst.blocks_free = total_blocks
        else:
            pool.total_blocks = total_blocks
            pool.blocks_free[:] = total_blocks
    res = sim.run(trace)
    return sim, res


#: name -> (trace args, pool config args, instances, total_blocks)
EXACT_CASES = {
    "basic": ((600, 220.0, 7, dict(l_in=(16, 1200), l_out=(1, 200))), (4096, 16), 3, None),
    "kv_pressure": ((500, 400.0, 3, dict(l_in=(16, 900), l_out=(1, 400))), (1024, 8), 3, 90),
    "submit_rejects": ((300, 200.0, 5, dict(l_in=(16, 2000), l_out=(1, 100))), (1024, 8), 2, None),
}


class TestTorchTierExact:
    """``TestJaxBackendEquivalence`` and ``TestCoalescedJumpEquivalence``:
    the torch tier against the reference's jax tier on the exact class."""

    @pytest.fixture(scope="class", params=list(EXACT_CASES))
    def runs(self, request):
        trace_args, cfg_args, inst, tb = EXACT_CASES[request.param]
        out = {"case": request.param}
        out["jax"] = run_single_pool(R, Rcore, trace_args, cfg_args, inst, "jax", total_blocks=tb)
        out["jax_stats"] = jax_engine.last_run_stats()
        before = decode_advance.launches
        out["torch"] = run_single_pool(T, Tcore, trace_args, cfg_args, inst, "torch", total_blocks=tb)
        out["torch_stats"] = torch_engine.last_run_stats()
        out["launches"] = decode_advance.launches - before
        out["n"] = trace_args[0]
        return out

    def test_records_bit_identical(self, runs):
        (js, jr), (ts, tr) = runs["jax"], runs["torch"]
        assert record_tuples(tr, ts) == record_tuples(jr, js)
        for f in SUMMARY_FIELDS:
            assert getattr(tr.summary, f) == getattr(jr.summary, f), f
        assert (tr.preemptions, tr.rejections, tr.truncations) == (
            jr.preemptions, jr.rejections, jr.truncations
        )

    def test_the_case_exercises_its_path(self, runs):
        _, res = runs["torch"]
        if runs["case"] == "kv_pressure":
            assert res.preemptions > 100
            assert res.summary.truncated > 50
        if runs["case"] == "submit_rejects":
            assert res.rejections > 0

    def test_iters_and_rounds_equal_the_jax_tier(self, runs):
        js, ts = runs["jax_stats"], runs["torch_stats"]
        assert ts["mode"] == "fleet" and ts["device"] == "cpu"
        assert (ts["iters"], ts["rounds"]) == (js["iters"], js["rounds"])
        assert 0 < ts["iters"] <= runs["n"] + 1
        assert ts["rounds"] >= ts["iters"]
        assert ts["host_syncs"] >= ts["rounds"]
        # coalesced jumps: rounds far below one round per generated token
        _, res = runs["torch"]
        total_tokens = sum(t[4] for t in record_tuples(res, runs["torch"][0]))
        if runs["case"] == "basic":
            assert ts["rounds"] < total_tokens / 5

    def test_cpu_run_launches_no_kernel(self, runs):
        assert runs["launches"] == 0


#: ``TestExactEquivalence``'s traces: (trace args, config args, instances,
#: total_blocks)
HOST_CASES = {
    "seeded": ((1500, 250.0, 11, {}), (4096, 16), 4, None),
    "kv_adversarial": ((600, 400.0, 3, dict(l_in=(16, 900), l_out=(50, 800))), (1024, 8), 3, 90),
    "rejections": ((300, 100.0, 5, dict(l_in=(16, 3000))), (1024, 8), 2, None),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_tiers_bit_identical_to_reference(case):
    """``TestExactEquivalence``: the port's scalar and vectorized tiers give
    the reference vectorized tier's records, summaries and counters."""
    trace_args, cfg_args, inst, tb = HOST_CASES[case]
    rs, rr = run_single_pool(R, Rcore, trace_args, cfg_args, inst, "vectorized", total_blocks=tb)
    expect = record_tuples(rr, rs)
    for backend in ("reference", "vectorized"):
        ts, tr = run_single_pool(T, Tcore, trace_args, cfg_args, inst, backend, total_blocks=tb)
        assert record_tuples(tr, ts) == expect, backend
        for f in SUMMARY_FIELDS:
            assert getattr(tr.summary, f) == getattr(rr.summary, f), (backend, f)
        assert (tr.preemptions, tr.rejections, tr.truncations) == (
            rr.preemptions, rr.rejections, rr.truncations
        ), backend


def two_pool_fleet(core, sim_pkg, trace, rate):
    plan = sim_pkg.plan_fleet("azure", trace, sim_pkg.A100_LLAMA3_70B, rate)
    return {
        "short": (
            core.PoolConfig("short", 8192, core.n_seq_for_cmax(8192), headroom=1.05),
            plan.short.instances,
        ),
        "long": (core.PoolConfig("long", 65_536, 16, headroom=1.02), plan.long.instances),
    }


def azure(traces_pkg, n, rate, seed=42):
    return traces_pkg.generate_trace(
        traces_pkg.TraceSpec(trace="azure", num_requests=n, rate=rate, seed=seed)
    )


class TestTorchTierRouted:
    """``TestJaxRoutedTolerance``: the routed two-pool fleet (Azure, A100
    timing, spillover off). The torch tier reproduces the jax tier's
    records; both stay within the reference's tolerances of the host
    tier."""

    N, RATE = 2000, 400.0

    @pytest.fixture(scope="class")
    def results(self):
        rtrace = azure(Rtraces, self.N, self.RATE)
        ttrace = azure(Ttraces, self.N, self.RATE)
        rpools = two_pool_fleet(Rcore, R, rtrace, self.RATE)
        tpools = two_pool_fleet(Tcore, T, ttrace, self.RATE)
        out = {}
        sim = R.FleetSim(rpools, R.A100_LLAMA3_70B, backend="jax", spillover=False)
        out["jax"] = (sim, sim.run(rtrace), jax_engine.last_run_stats())
        sim = T.FleetSim(tpools, T.A100_LLAMA3_70B, backend="torch", spillover=False, device="cpu")
        out["torch"] = (sim, sim.run(ttrace), torch_engine.last_run_stats())
        sim = T.FleetSim(tpools, T.A100_LLAMA3_70B, backend="vectorized", spillover=False)
        out["vectorized"] = (sim, sim.run(ttrace), None)
        return out

    def test_records_equal_the_jax_tier(self, results):
        (js, jr, jst), (ts, tr, tst) = results["jax"], results["torch"]
        assert record_tuples(tr, ts) == record_tuples(jr, js)
        assert (tst["iters"], tst["rounds"]) == (jst["iters"], jst["rounds"])
        assert tst["iters"] <= self.N + 1
        assert tr.router_stats["routed"] == jr.router_stats["routed"]
        assert tr.router_stats["calibration"] == jr.router_stats["calibration"]
        for f in SUMMARY_FIELDS:
            assert getattr(tr.summary, f) == getattr(jr.summary, f), f

    def test_completion_totals_close(self, results):
        vec, tr = results["vectorized"][1], results["torch"][1]
        assert tr.summary.num_requests == vec.summary.num_requests
        assert tr.summary.completed == pytest.approx(vec.summary.completed, rel=0.01)

    def test_latency_percentiles_close(self, results):
        vec, tr = results["vectorized"][1], results["torch"][1]
        assert tr.summary.ttft_p99 == pytest.approx(vec.summary.ttft_p99, rel=0.15)
        assert tr.summary.tpot_p99 == pytest.approx(vec.summary.tpot_p99, rel=0.15)

    def test_routing_fractions_close(self, results):
        vec, tr = results["vectorized"][1], results["torch"][1]
        for name, frac in vec.router_stats["fractions"].items():
            assert tr.router_stats["fractions"][name] == pytest.approx(frac, abs=0.02), name

    def test_every_request_accounted(self, results):
        for key in ("torch", "vectorized"):
            assert sum(results[key][1].router_stats["routed"].values()) == self.N, key


def three_pool_topology(pkg, core, trace, rate):
    """``tests/test_vector_engine.py``'s 4K / 16K / 64K pools, each sized by
    ``profile_pool`` for the requests whose true total falls in its band."""
    cfgs = (
        core.PoolConfig("p4k", 4096, core.n_seq_for_cmax(4096), headroom=1.05),
        core.PoolConfig("p16k", 16_384, core.n_seq_for_cmax(16_384), headroom=1.05),
        core.PoolConfig("p64k", 65_536, 16, headroom=1.02),
    )
    thresholds = [4096, 16_384]
    group = np.searchsorted(thresholds, [r.true_total for r in trace])
    pools = {}
    for k, cfg in enumerate(cfgs):
        members = [r for r, g in zip(trace, group) if g == k]
        prof = pkg.profile_pool(cfg.name, trace, members, cfg, pkg.A100_LLAMA3_70B, rate)
        pools[cfg.name] = (cfg, max(1, prof.instances))
    return pools, thresholds


class TestTorchTierMoreFleets:
    """Two routed fleets beyond ``TestTorchTierRouted``'s, each held bit for
    bit against the jax tier with equal iters and rounds: the three-pool
    4K / 16K / 64K topology (Azure, n = 1,500), and the two-pool Table-2
    fleet fed a ``TraceColumns`` trace instead of ``Request`` objects."""

    N, RATE = 1500, 400.0

    @pytest.fixture(scope="class", params=["three_pool", "columnar"])
    def runs(self, request):
        out = {"case": request.param}
        for name, pkg, core, traces, engine in (
            ("jax", R, Rcore, Rtraces, jax_engine), ("torch", T, Tcore, Ttraces, torch_engine)
        ):
            kw = {"device": "cpu"} if name == "torch" else {}
            spec = traces.TraceSpec(trace="azure", num_requests=self.N, rate=self.RATE, seed=42)
            if request.param == "three_pool":
                trace = traces.generate_trace(spec)
                pools, thresholds = three_pool_topology(pkg, core, trace, self.RATE)
                sim = pkg.FleetSim(pools, pkg.A100_LLAMA3_70B, thresholds=thresholds,
                                   backend=name, spillover=False, **kw)
            else:
                trace = traces.generate_trace_columns(spec)
                sim = pkg.FleetSim(two_pool_fleet(core, pkg, trace.to_requests(), self.RATE),
                                   pkg.A100_LLAMA3_70B, backend=name, spillover=False, **kw)
            out[name] = (sim, sim.run(trace), engine.last_run_stats())
        return out

    def test_records_and_counts_equal_the_jax_tier(self, runs):
        (js, jr, jst), (ts, tr, tst) = runs["jax"], runs["torch"]
        assert record_tuples(tr, ts) == record_tuples(jr, js)
        assert (tst["iters"], tst["rounds"]) == (jst["iters"], jst["rounds"])
        assert 0 < tst["iters"] <= self.N + 1
        assert tr.router_stats["routed"] == jr.router_stats["routed"]
        for f in SUMMARY_FIELDS:
            assert getattr(tr.summary, f) == getattr(jr.summary, f), f

    def test_every_pool_takes_requests(self, runs):
        routed = runs["torch"][1].router_stats["routed"]
        assert len(routed) == (3 if runs["case"] == "three_pool" else 2)
        assert all(v > 0 for v in routed.values()) and sum(routed.values()) == self.N


@pytest.mark.parametrize("spillover", [True, False])
def test_routed_vectorized_tier_bit_identical_to_reference(spillover):
    """The port's vectorized tier routes through the port's batch router and
    EMA fold, which are bit-identical to the reference's, so a routed fleet
    gives the reference vectorized tier's records."""
    n, rate = 1500, 400.0
    rtrace, ttrace = azure(Rtraces, n, rate, seed=3), azure(Ttraces, n, rate, seed=3)
    rsim = R.FleetSim(two_pool_fleet(Rcore, R, rtrace, rate), R.A100_LLAMA3_70B,
                      backend="vectorized", spillover=spillover)
    tsim = T.FleetSim(two_pool_fleet(Tcore, T, ttrace, rate), T.A100_LLAMA3_70B,
                      backend="vectorized", spillover=spillover)
    rres, tres = rsim.run(rtrace), tsim.run(ttrace)
    assert record_tuples(tres, tsim) == record_tuples(rres, rsim)
    assert tres.router_stats == rres.router_stats


class TestControllerInTheLoop:
    """``TestControllerInTheLoop`` on the device tiers: an undersized short
    pool with the AIMD controller. The torch tier's float32 controller
    mirror moves the boundary at the same windows to the same values as the
    jax tier's, so records, thresholds and histories are identical."""

    @pytest.fixture(scope="class")
    def incident(self):
        n, rate = 2500, 250.0
        out = {}
        for name, pkg, core, traces in (("jax", R, Rcore, Rtraces), ("torch", T, Tcore, Ttraces)):
            cols = traces.generate_trace_columns(
                traces.TraceSpec(trace="azure", num_requests=n, rate=rate, seed=42)
            )
            plan = pkg.plan_fleet("azure", cols.to_requests(), pkg.A100_LLAMA3_70B, rate)
            pools = {
                "short": (
                    core.PoolConfig("short", 8192, core.n_seq_for_cmax(8192),
                                    headroom=1.05, queue_limit=64),
                    max(1, int(plan.short.instances * 0.6)),
                ),
                "long": (
                    core.PoolConfig("long", 65_536, 16, headroom=1.02, queue_limit=64),
                    plan.long.instances,
                ),
            }
            ctrl = core.AdaptiveController(b_min=512)
            kw = {"device": "cpu"} if name == "torch" else {}
            sim = pkg.FleetSim(pools, pkg.A100_LLAMA3_70B, b_short=8192, backend=name,
                               controller=ctrl, control_window=200, **kw)
            out[name] = (sim, sim.run(cols), ctrl)
        return out

    def test_controller_fires(self, incident):
        _, _, ctrl = incident["torch"]
        assert ctrl.history
        assert 512 <= ctrl.thresholds[0] < 8192

    def test_history_and_thresholds_equal_the_jax_tier(self, incident):
        (_, jr, jc), (_, tr, tc) = incident["jax"], incident["torch"]
        assert [dataclasses.astuple(m) for m in tc.history] == [
            dataclasses.astuple(m) for m in jc.history
        ]
        assert tc.thresholds == jc.thresholds
        assert tr.router_stats["thresholds"] == jr.router_stats["thresholds"] == tc.thresholds

    def test_records_equal_the_jax_tier(self, incident):
        (js, jr, _), (ts, tr, _) = incident["jax"], incident["torch"]
        assert record_tuples(tr, ts) == record_tuples(jr, js)


class TestTorchTierRefuses:
    """What the torch tier does not model raises, as on the jax tier, and
    a CUDA device without a GPU raises instead of falling back."""

    CFG = Tcore.PoolConfig("p", 4096, 16)

    def test_fault_injection(self):
        inj = T.FaultInjector((T.FaultSpec("crash", "p", instance=0, t=0.5),))
        with pytest.raises(ValueError, match="fault injection"):
            T.FleetSim({"p": (self.CFG, 2)}, dyadic(T), backend="torch", device="cpu", injector=inj)

    def test_event_tracing(self):
        from repro_torch.obs import TelemetryConfig

        with pytest.raises(ValueError, match="event tracing"):
            T.FleetSim({"p": (self.CFG, 2)}, dyadic(T), backend="torch", device="cpu",
                       telemetry=TelemetryConfig(window=64, events=True))

    def test_windowed_telemetry(self):
        from repro_torch.obs import TelemetryConfig

        with pytest.raises(NotImplementedError, match="telemetry"):
            T.FleetSim({"p": (self.CFG, 2)}, dyadic(T), backend="torch", device="cpu",
                       telemetry=TelemetryConfig(window=64, events=False))

    def test_cuda_without_a_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.FleetSim({"p": (self.CFG, 2)}, dyadic(T), backend="torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_fleet([], {"p": (self.CFG, 2)}, dyadic(T), backend="torch", device="cuda")

    def test_default_is_the_torch_tier_on_cuda(self, monkeypatch):
        """A bare call names no backend and no device: it takes the torch
        tier on the card, so without a GPU it raises, never a host tier."""
        assert T.FleetSim({"p": (self.CFG, 2)}, dyadic(T), device="cpu").backend == "torch"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.FleetSim({"p": (self.CFG, 2)}, dyadic(T))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_fleet([], {"p": (self.CFG, 2)}, dyadic(T))

    def test_host_tiers_take_no_device(self):
        sim = T.FleetSim({"p": (self.CFG, 2)}, dyadic(T), backend="vectorized")
        assert sim.device is None


@pytest.mark.parametrize("trace", ["azure", "lmsys"])
def test_table2_plan_and_cost_model_equal_reference(trace):
    """Table 2 (1,000 req/s, B_short = 8192): fleet sizes, savings and the
    cost model's numbers equal the reference's."""
    n, rate = 10_000, 1000.0
    spec = dict(trace=trace, num_requests=n, rate=rate, seed=42)
    rp = R.plan_fleet(trace, Rtraces.generate_trace(Rtraces.TraceSpec(**spec)),
                      R.A100_LLAMA3_70B, rate)
    tp = T.plan_fleet(trace, Ttraces.generate_trace(Ttraces.TraceSpec(**spec)),
                      T.A100_LLAMA3_70B, rate)
    assert dataclasses.astuple(tp) == dataclasses.astuple(rp)
    assert (tp.g_homo, tp.g_dual, tp.savings, tp.alpha, tp.rho) == (
        rp.g_homo, rp.g_dual, rp.savings, rp.alpha, rp.rho
    )
    assert tp.savings > 0.1
    assert Tcost.closed_form_savings(tp.alpha, tp.rho) == Rcost.closed_form_savings(rp.alpha, rp.rho)
    assert Tcost.annual_savings(tp.g_homo, tp.g_dual, Tcost.A100_80G, 2) == Rcost.annual_savings(
        rp.g_homo, rp.g_dual, Rcost.A100_80G, 2
    )
    assert dataclasses.astuple(Tcost.mi300x_case_study()) == dataclasses.astuple(
        Rcost.mi300x_case_study()
    )
    assert not math.isnan(tp.rho)
