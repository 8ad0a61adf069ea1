"""The port's ``run_fleet_grid`` over its other axes, against the
reference's, on the CPU: an instances axis whose smaller lanes run padded
with dead instances, a gains axis mixing uncontrolled and controlled lanes,
a three-pool grid (4K / 16K / 64K), the reference's dyadic grid and its
interleaved record modes, a bad axis length, the grid's host reads
against the single-lane run's, and ``benchmarks/port_fig6_sensitivity.py``
against ``benchmarks/fig6_sensitivity.py``. Every comparison with the
reference is bit for bit on the records, exact on the loop counts and
integer metrics, and to rtol 1e-12 on float metrics
(``assert_grids_equal``).
"""

import sys
from pathlib import Path

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
from repro_torch.core.router import Request  # noqa: E402
from repro_torch.sim import torch_engine  # noqa: E402
from test_torch_grid import COUNTS, assert_grids_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmarks package

SIDES = ((R, Rpools, Rtraces, jax_engine, {}), (T, Tpools, Ttraces, torch_engine, {"device": "cpu"}))


def azure(traces, n, rate, seed=42):
    return traces.generate_trace_columns(
        traces.TraceSpec(trace="azure", num_requests=n, rate=rate, seed=seed)
    )


def both(make_args, **grid_kw):
    """Run one grid through the reference and the port; returns
    ``(ref, ref_stats), (port, port_stats)``."""
    out = []
    for pkg, pools, traces, engine, kw in SIDES:
        trace, fleet, timing = make_args(pkg, pools, traces)
        grid = pkg.run_fleet_grid(trace, fleet, timing, **grid_kw, **kw)
        out.append((grid, engine.last_run_stats()))
    return out


def assert_same_run(ref, port):
    (rg, rs), (tg, ts) = ref, port
    assert_grids_equal(tg, rg)
    assert {k: ts[k] for k in COUNTS} == {k: rs[k] for k in COUNTS}


def small_fleet(pkg, pools, traces):
    """Azure at 400 req/s on a fixed short / long fleet (4 x 8192 and
    6 x 65,536), small enough that the short pool queues."""
    return azure(traces, 800, 400.0), {
        "short": (pools.PoolConfig("short", 8192, pools.n_seq_for_cmax(8192), headroom=1.05), 4),
        "long": (pools.PoolConfig("long", 65_536, 16, headroom=1.02), 6),
    }, pkg.A100_LLAMA3_70B


def test_instances_axis_with_dead_lanes():
    """Lanes of 4, 2 and 1 short instances share one run padded to 4: the
    dead instances never take a request."""
    ref, port = both(small_fleet, thresholds=[[4096]], instances=[[4, 6], [2, 6], [1, 3]],
                     return_records=True)
    assert_same_run(ref, port)
    grid = port[0]
    assert grid.completed[2] <= grid.completed[0]
    assert (grid.routed.sum(axis=1) == 800).all()


def test_gains_axis_mixes_uncontrolled_and_controlled_lanes():
    """Uncontrolled lanes never move; controlled lanes move at the same
    windows to the same thresholds as the reference's."""
    gains = [None, {"decrease_factor": 0.5}, {"decrease_factor": 0.5, "b_min": 2048},
             {"increase_step": 1024, "error_rate_hi": 0.01}]
    ref, port = both(small_fleet, thresholds=[[8192], [8192], [8192], [4096]],
                     instances=[[2, 6]], gains=gains, control_window=100, return_records=True)
    assert_same_run(ref, port)
    grid = port[0]
    assert grid.controller_moves[0] == 0 and (grid.final_thresholds[0] == 8192).all()
    assert grid.controller_moves[1:].sum() > 0
    assert (512 <= grid.final_thresholds[1:]).all() and (grid.final_thresholds <= 8192).all()


def three_pools(pkg, pools, traces):
    """The 4K / 16K / 64K ladder of ``beyond_paper_threepool``."""
    return azure(traces, 600, 300.0, seed=7), {
        "short": (pools.PoolConfig("short", 4096, pools.n_seq_for_cmax(4096), headroom=1.05), 3),
        "mid": (pools.PoolConfig("mid", 16_384, pools.n_seq_for_cmax(16_384), headroom=1.05), 2),
        "long": (pools.PoolConfig("long", 65_536, 16, headroom=1.02), 3),
    }, pkg.A100_LLAMA3_70B


def test_three_pool_grid():
    ref, port = both(three_pools, thresholds=[[4096, 16_384], [2048, 16_384], [4096, 8192]],
                     return_records=True)
    assert_same_run(ref, port)
    grid = port[0]
    assert grid.routed.shape == (3, 3) and (grid.routed > 0).all()
    assert grid.pool_names == ("short", "mid", "long")


def dyadic_requests(n, rate, seed, *, l_in, l_out):
    """``tests/test_vector_engine.py``'s ``poisson_trace``, as the port's
    requests."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    return [
        Request(request_id=i, byte_len=int(rng.integers(4, 12_000)),
                max_output_tokens=int(rng.integers(*l_out)), category=int(rng.integers(0, 4)),
                arrival_time=float(arrivals[i]), true_input_tokens=int(rng.integers(*l_in)),
                true_output_tokens=int(rng.integers(*l_out)))
        for i in range(n)
    ]


def dyadic_fleet(pkg, pools, traces):
    """``TestCoalescedJumpEquivalence.test_grid_iters_bounded``'s grid:
    dyadic timing, 2048 / 8192 pools of 8 slots, two instances each."""
    trace = dyadic_requests(300, 220.0, 3, l_in=(16, 1200), l_out=(1, 150))
    return trace, {
        "short": (pools.PoolConfig("short", 2048, 8), 2),
        "long": (pools.PoolConfig("long", 8192, 8), 2),
    }, pkg.TimingModel("dyadic", w_base=2**-10, h_per_seq=2**-13, prefill_chunk=512)


def test_dyadic_grid_counts_and_the_single_lane_bound():
    """The reference's dyadic grid: equal records and counts. A grid lane
    runs one round per outer iteration, so its ``iters`` is its round
    count and passes n + 1; the single-lane run, through the same loop
    with its nested sweep, keeps ``iters <= n + 1``."""
    ref, port = both(dyadic_fleet, thresholds=[[512], [1536]], return_records=True)
    assert_same_run(ref, port)
    ps = port[1]
    assert ps["rounds"] == ps["iters"] and ps["rounds_total"] <= 2 * ps["rounds"]
    trace, fleet, timing = dyadic_fleet(T, Tpools, Ttraces)
    sim = T.FleetSim(fleet, timing, b_short=1536, backend="torch", device="cpu",
                     spillover=False, coalesce_dt=0.0)
    sim.run(trace)
    single = torch_engine.last_run_stats()
    assert single["mode"] == "fleet" and 0 < single["iters"] <= len(trace) + 1
    assert single["rounds"] >= single["iters"]


def test_interleaved_record_modes():
    """``TestDonatedBufferParity.test_interleaved_grid_record_modes``: runs
    with and without records, interleaved, agree."""
    trace, fleet, timing = dyadic_fleet(T, Tpools, Ttraces)

    def grid(return_records):
        return T.run_fleet_grid(trace, fleet, timing, thresholds=[[512], [1536]],
                                return_records=return_records, device="cpu")

    with_rec, summary_only, again = grid(True), grid(False), grid(True)
    assert summary_only.records is None
    assert (with_rec.completed == summary_only.completed).all()
    assert np.array_equal(with_rec.ttft_p99, summary_only.ttft_p99)
    assert_grids_equal(again, with_rec)


def test_bad_axis_length_raises():
    trace, fleet, timing = dyadic_fleet(T, Tpools, Ttraces)
    with pytest.raises(ValueError, match="grid axis"):
        T.run_fleet_grid(trace, fleet, timing, thresholds=[[512], [1024]],
                         gains=[None, None, None], device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        T.run_fleet_grid([], fleet, timing, device="cpu")


def test_grid_reads_the_host_once_for_all_lanes():
    """Each drain wave, admission wave and round is one read for every
    lane: four lanes take fewer reads than four single-lane runs."""
    trace, fleet, timing = dyadic_fleet(T, Tpools, Ttraces)
    T.run_fleet_grid(trace, fleet, timing, thresholds=[[512], [1024], [1536], [2048]],
                     device="cpu")
    grid = torch_engine.last_run_stats()
    sim = T.FleetSim(fleet, timing, b_short=1536, backend="torch", device="cpu",
                     spillover=False, coalesce_dt=0.0)
    sim.run(trace)
    single = torch_engine.last_run_stats()
    assert grid["g"] == 4 and grid["host_syncs"] < 4 * single["host_syncs"]


def test_cuda_without_a_gpu_raises(monkeypatch):
    """The default device is the card; without one the grid raises instead
    of falling back to the CPU."""
    trace, fleet, timing = dyadic_fleet(T, Tpools, Ttraces)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_fleet_grid(trace, fleet, timing)


def test_port_fig6_des_equals_the_reference(monkeypatch):
    """Both benchmarks' ``run_des`` at n = 300: the grids they build agree
    (goodput, P99 TTFT and short fraction to rtol 1e-12; completions and
    preemptions equal), and so do their emitted rows."""
    from benchmarks import common, fig6_sensitivity, port_fig6_sensitivity

    grids = {}
    for name, mod in (("ref", fig6_sensitivity), ("port", port_fig6_sensitivity)):
        seen = grids.setdefault(name, [])
        inner = mod.run_fleet_grid

        def spy(*args, _inner=inner, _seen=seen, **kw):
            out = _inner(*args, **kw)
            _seen.append(out)
            return out

        monkeypatch.setattr(mod, "run_fleet_grid", spy)
    common.reset_rows()
    ref = fig6_sensitivity.run_des(300)
    ref_rows = [(name, derived) for name, _, derived in common._ROWS]
    common.reset_rows()
    port = port_fig6_sensitivity.run_des(300, device="cpu")
    port_rows = [(name, derived) for name, _, derived in common._ROWS]
    assert port_rows == ref_rows and len(port_rows) == 10
    assert set(port) == set(ref) == {"azure", "lmsys"}
    for trace in ref:
        np.testing.assert_allclose(list(port[trace].values()), list(ref[trace].values()),
                                   rtol=1e-12)
    assert len(grids["ref"]) == len(grids["port"]) == 8  # per trace: warm-up, 2 timed, 1 kept
    for rg, tg in zip(grids["ref"], grids["port"]):
        for f in ("goodput", "ttft_p99", "short_frac"):
            want, got = (
                (g.routed[:, 0] / np.maximum(g.routed.sum(axis=1), 1)) if f == "short_frac"
                else (g.goodput() if f == "goodput" else g.ttft_p99)
                for g in (rg, tg)
            )
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=f)
        assert np.array_equal(tg.completed, rg.completed)
        assert np.array_equal(tg.preemptions, rg.preemptions)
