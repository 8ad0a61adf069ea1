"""The port's batched sensitivity grid (``repro_torch.sim.run_fleet_grid``)
against the reference's vmapped ``repro.sim.run_fleet_grid``, on the CPU.

The reference's ``TestFleetGrid`` fixture (Azure, n = 2,000 at 400 req/s,
``plan_fleet`` instances, thresholds 2048 / 4096 / 8192): every lane's
records are bit-identical to the reference grid's lane, the loop counts of
``last_run_stats()`` equal the reference's, integer metrics are equal and
float metrics agree to rtol 1e-12; the 8192 lane equals the port's own
single-lane ``FleetSim(backend="torch")`` run. The other grid axes, a
three-pool grid and the grid's host reads are in
``tests/test_torch_grid_axes.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import sim as R  # noqa: E402
from repro import traces as Rtraces  # noqa: E402
from repro.core import pools as Rpools  # noqa: E402
from repro.sim import jax_engine  # noqa: E402
from repro_torch import sim as T  # noqa: E402
from repro_torch import traces as Ttraces  # noqa: E402
from repro_torch.core import pools as Tpools  # noqa: E402
from repro_torch.kernels.sim_decode import decode_advance  # noqa: E402
from repro_torch.sim import torch_engine  # noqa: E402

N, RATE = 2000, 400.0
THRESHOLDS = [[2048], [4096], [8192]]
INT_METRICS = ("completed", "rejected", "truncated", "preemptions", "routed",
               "final_thresholds", "controller_moves")
FLOAT_METRICS = ("ttft_mean", "ttft_p50", "ttft_p99", "tpot_mean", "tpot_p99", "makespan")
COUNTS = ("mode", "n", "g", "iters", "rounds", "iters_total", "rounds_total")


def fleet(pkg, pools, trace):
    plan = pkg.plan_fleet("azure", trace, pkg.A100_LLAMA3_70B, RATE)
    return {
        "short": (pools.PoolConfig("short", 8192, pools.n_seq_for_cmax(8192), headroom=1.05),
                  plan.short.instances),
        "long": (pools.PoolConfig("long", 65_536, 16, headroom=1.02), plan.long.instances),
    }


def assert_grids_equal(got, want):
    """Records bit for bit (dtype and NaN-aware), integer metrics exactly,
    float metrics to rtol 1e-12."""
    assert got.pool_names == want.pool_names
    assert np.array_equal(got.thresholds, want.thresholds)
    assert np.array_equal(got.instances, want.instances)
    for f in INT_METRICS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in FLOAT_METRICS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, err_msg=f)
    assert (got.records is None) == (want.records is None)
    if want.records is not None:
        assert set(got.records) == set(want.records)
        for k, v in want.records.items():
            assert got.records[k].dtype == v.dtype, k
            assert got.records[k].shape == v.shape, k
            assert np.array_equal(got.records[k], v, equal_nan=True), k


@pytest.fixture(scope="module")
def grids():
    rtrace = Rtraces.generate_trace(Rtraces.TraceSpec(trace="azure", num_requests=N,
                                                      rate=RATE, seed=42))
    ttrace = Ttraces.generate_trace(Ttraces.TraceSpec(trace="azure", num_requests=N,
                                                      rate=RATE, seed=42))
    ref = R.run_fleet_grid(rtrace, fleet(R, Rpools, rtrace), R.A100_LLAMA3_70B,
                           thresholds=THRESHOLDS, return_records=True)
    ref_stats = jax_engine.last_run_stats()
    tpools = fleet(T, Tpools, ttrace)
    before = decode_advance.launches
    port = T.run_fleet_grid(ttrace, tpools, T.A100_LLAMA3_70B, thresholds=THRESHOLDS,
                            return_records=True, device="cpu")
    port_stats = torch_engine.last_run_stats()
    launches = decode_advance.launches - before
    return dict(ttrace=ttrace, tpools=tpools, ref=ref, ref_stats=ref_stats, port=port,
                port_stats=port_stats, launches=launches)


def test_every_lane_equals_the_reference_grid(grids):
    assert len(grids["port"]) == len(THRESHOLDS)
    assert_grids_equal(grids["port"], grids["ref"])


def test_loop_counts_equal_the_reference(grids):
    ps, rs = grids["port_stats"], grids["ref_stats"]
    assert {k: ps[k] for k in COUNTS} == {k: rs[k] for k in COUNTS}
    assert ps["mode"] == "grid" and ps["device"] == "cpu" and ps["g"] == 3
    # one unconditional round per outer iteration, as the reference
    assert ps["rounds"] == ps["iters"] and ps["rounds_total"] == ps["iters_total"]
    assert ps["host_syncs"] >= ps["rounds"]


def test_lane_equals_the_single_lane_torch_tier(grids):
    """Lane k = 2 (threshold 8192, FleetSim's default boundary) is the
    port's own single-lane run of the same fleet."""
    sim = T.FleetSim(dict(grids["tpools"]), T.A100_LLAMA3_70B, backend="torch",
                     device="cpu", spillover=False)
    res = sim.run(grids["ttrace"])
    k = 2
    single = {}
    for p in sim.pools.values():
        a = p.record_arrays()
        for j, rid in enumerate(a["request_id"]):
            single[int(rid)] = (a["first_token"][j], a["finish"][j], int(a["output_tokens"][j]),
                                int(a["preemptions"][j]), bool(a["truncated"][j]),
                                bool(a["rejected"][j]))
    trace = grids["ttrace"]
    order = np.argsort([r.arrival_time for r in trace], kind="stable")
    ids = np.array([r.request_id for r in trace])[order]
    rec = grids["port"].records
    for j, rid in enumerate(ids):
        got = (rec["first"][k, j], rec["finish"][k, j], int(rec["out"][k, j]),
               int(rec["pre"][k, j]), bool(rec["trunc"][k, j]), bool(rec["rej"][k, j]))
        assert got == single[int(rid)], rid
    assert int(grids["port"].routed[k, 0]) == res.router_stats["routed"]["short"]
    assert int(grids["port"].preemptions[k]) == res.preemptions


def test_threshold_axis_is_monotone_in_routing(grids):
    grid = grids["port"]
    assert (np.diff(grid.routed[:, 0]) >= 0).all()
    assert (grid.routed.sum(axis=1) == N).all()
    assert (grid.goodput() > 0).all()


def test_cpu_grid_launches_no_kernel(grids):
    assert grids["launches"] == 0
