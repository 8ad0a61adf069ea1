"""The paper's tables, the package surface and the examples on the port.

Each ``benchmarks/port_*.py`` script is held against its reference script
on the CPU: the same row names and derived strings (the timing column left
out, and the measured microseconds of the dispatch rows). Table 3 runs its
fleets through the port's torch tier on ``device="cpu"`` at a reduced n and
is held against the reference's ``jax`` tier with ``spillover=False``,
field for field. ``examples/port_quickstart.py`` and
``examples/port_cost_planner.py`` print what the reference's examples
print, ``examples/port_serve_two_pools.py`` answers every request, every
public name of ``repro.core`` / ``sim`` / ``obs`` / ``traces`` has its
counterpart, and the router's P = 2 views behave as
``tests/test_router.py`` expects of the reference's.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import repro.core  # noqa: E402
import repro.obs  # noqa: E402
import repro.sim  # noqa: E402
import repro.traces  # noqa: E402
import repro_torch.core  # noqa: E402
import repro_torch.obs  # noqa: E402
import repro_torch.sim  # noqa: E402
import repro_torch.traces  # noqa: E402
from benchmarks import (  # noqa: E402
    common,
    cost_model_gap,
    dispatch_overhead,
    port_cost_model_gap,
    port_dispatch_overhead,
    port_table1_pools,
    port_table2_cost,
    port_table3_latency,
    port_table4_calibration,
    port_table5_mi300x,
    table1_pools,
    table2_cost,
    table4_calibration,
    table5_mi300x,
)
from repro.core import PoolConfig as RPoolConfig, n_seq_for_cmax  # noqa: E402
from repro.traces import TraceSpec, generate_trace  # noqa: E402
from repro_torch.core import PoolState, Request, TokenBudgetRouter, long_pool, short_pool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: The reference's ``jax_*`` names and the port's plain-named counterparts.
JAX_NAMES = {
    "jax_estimate_budget": "estimate_budget",
    "jax_update": "update",
    "jax_update_stream": "update_stream",
    "jax_route_batch": "route_batch",
}
#: Row names the port gives where the reference names jax.
ROW_NAMES = {"dispatch/jax_batch_per_req": "dispatch/torch_batch_per_req"}


def rows_of(fn, *args, **kw) -> list[tuple[str, str]]:
    common.reset_rows()
    fn(*args, **kw)
    rows = [(name, derived) for name, _, derived in common._ROWS]
    common.reset_rows()
    return rows


@pytest.mark.parametrize(
    "ref, port",
    [
        (table1_pools, port_table1_pools),
        (table2_cost, port_table2_cost),
        (table4_calibration, port_table4_calibration),
        (table5_mi300x, port_table5_mi300x),
        (cost_model_gap, port_cost_model_gap),
    ],
    ids=["table1", "table2", "table4", "table5", "cost_model_gap"],
)
def test_table_rows_equal_the_reference(monkeypatch, ref, port):
    """The same row names and derived strings; ``time_us`` (the timing
    column only) is stubbed on both sides."""
    for mod in (ref, port):
        monkeypatch.setattr(mod, "time_us", lambda fn, **kw: 0.0)
    want = rows_of(ref.run)
    assert want and rows_of(port.run) == want


def test_dispatch_overhead_rows_equal_the_reference():
    """The same rows in the same order, the batch row renamed; the derived
    values that are not read off a clock (``n``) equal."""
    n = 2000
    want = rows_of(dispatch_overhead.run, n)
    got = rows_of(port_dispatch_overhead.run, n, device="cpu")
    assert [name for name, _ in got] == [ROW_NAMES.get(name, name) for name, _ in want]
    assert got[-1][1] == want[-1][1] == f"n={n}"
    for (_, g), (_, w) in zip(got[:-1], want[:-1]):
        assert g.split("=")[0] == w.split("=")[0] == "sub_microsecond"


def test_dispatch_overhead_batch_routes_like_the_host():
    """The batch path's pool ids are the host router's decisions (no load,
    no feedback between them)."""
    n = 500
    out = port_dispatch_overhead.run(n, device="cpu")
    router = TokenBudgetRouter(PoolState(config=short_pool()), PoolState(config=long_pool()),
                               spillover=False)
    rng = np.random.default_rng(0)
    want = [
        router.route(Request(i, int(rng.integers(64, 64_000)), int(rng.integers(16, 4096)),
                             int(rng.integers(0, 4)))).pool_index
        for i in range(n)
    ]
    assert out["pools"].tolist() == want


TABLE3_N = 600


@pytest.fixture(scope="module")
def table3():
    """The port's Table 3 at n = 600 (1/5 scale's rate) on the CPU, and the
    reference's fleets on its jax tier (spillover off) and its default host
    tier (spillover on)."""
    common.reset_rows()
    port = port_table3_latency.run(num_requests=TABLE3_N, device="cpu")
    port_rows = [name for name, _, _ in common._ROWS]
    common.reset_rows()
    reqs = generate_trace(TraceSpec(trace="azure", num_requests=TABLE3_N, rate=200.0, seed=42))
    plan = repro.sim.plan_fleet("azure", reqs, repro.sim.A100_LLAMA3_70B, 200.0)
    fleets = {
        "homogeneous": {"homogeneous": (
            RPoolConfig("homogeneous", 65_536, 16, headroom=1.08), plan.homogeneous.instances)},
        "token_budget": {
            "short": (RPoolConfig("short", 8192, n_seq_for_cmax(8192), batch_token_budget=16_384,
                                  headroom=1.05), plan.short.instances),
            "long": (RPoolConfig("long", 65_536, 16, headroom=1.02), plan.long.instances),
        },
    }
    ref = {}
    for name, pools in fleets.items():
        ref[name] = {
            "jax": repro.sim.run_fleet(reqs, pools, repro.sim.A100_LLAMA3_70B, backend="jax",
                                       spillover=False),
            "host": repro.sim.run_fleet(reqs, pools, repro.sim.A100_LLAMA3_70B),
        }
    return {"port": port, "rows": port_rows, "ref": ref, "plan": plan}


#: SimSummary fields where the reference's default host run (scalar tier,
#: spillover on, float64 without the compiled tier's fused multiply-adds)
#: differs from its jax tier at n = 600: the latency percentiles and the
#: makespan in their last bits, and one truncation in the routed fleet.
HOST_DIFFERS = {
    "homogeneous": {"ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99", "makespan", "throughput"},
    "token_budget": {"ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99", "makespan", "throughput",
                     "truncated"},
}


@pytest.mark.parametrize("fleet", ["homogeneous", "token_budget"])
def test_table3_equals_the_reference_jax_tier(table3, fleet):
    got = dataclasses.asdict(table3["port"][fleet].summary)
    assert got == dataclasses.asdict(table3["ref"][fleet]["jax"].summary)
    assert table3["port"]["plan"].g_dual == table3["plan"].g_dual
    assert table3["rows"] == ["table3/azure/homogeneous", "table3/azure/token-budget"]


@pytest.mark.parametrize("fleet", ["homogeneous", "token_budget"])
def test_table3_host_run_differs_in_named_fields(table3, fleet):
    jx = dataclasses.asdict(table3["ref"][fleet]["jax"].summary)
    host = dataclasses.asdict(table3["ref"][fleet]["host"].summary)
    assert {k for k in jx if jx[k] != host[k]} == HOST_DIFFERS[fleet]
    for k in HOST_DIFFERS[fleet]:
        assert host[k] == pytest.approx(jx[k], rel=0.05, abs=1), k


def run_script(path: str, *args: str, reference: bool = False, threads: int = 0) -> str:
    """A script's stdout; the reference's run with R1's alias set first;
    ``threads`` caps the CPU threads of its math libraries (the test run's
    other workers share the cores)."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    if threads:
        env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
    if reference:
        code = (
            "import sys, runpy, jax, jax.experimental\n"
            "if not hasattr(jax.experimental, 'enable_x64'):\n"
            "    jax.experimental.enable_x64 = jax.enable_x64\n"
            "sys.argv = sys.argv[1:]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n"
        )
        cmd = [sys.executable, "-c", code, path, *args]
    else:
        cmd = [sys.executable, path, *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("name", ["quickstart", "cost_planner"])
def test_example_prints_what_the_reference_prints(name):
    want = run_script(f"examples/{name}.py", reference=True)
    got = run_script(f"examples/port_{name}.py")
    assert want.strip()
    assert got == want.replace("examples/cost_planner.py", "examples/port_cost_planner.py")


def test_train_example_trains_and_checkpoints(tmp_path):
    """``examples/port_train_small.py --steps 2 --device cpu``: two steps
    of the 100M model at its own batches (8 x 256), a finite final loss,
    its last step checkpointed. It runs on one thread (41 s alone on an
    8-core host, 70 s at four steps, 200 s at four steps beside the test
    run's other workers): with torch's default of a thread per core, there,
    four steps ran past the subprocess's 300 s limit."""
    out = run_script("examples/port_train_small.py", "--steps", "2", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path), threads=1)
    assert "[train] step 0: loss" in out
    final = float(out.split("[example] final loss:")[1].split()[0])
    assert np.isfinite(final)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]


def test_serve_example_answers_every_request(capsys):
    spec = importlib.util.spec_from_file_location(
        "port_serve_two_pools", ROOT / "examples" / "port_serve_two_pools.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--requests", "4"])
    assert sorted(r.request_id for r in out["responses"]) == list(range(4))
    assert all(r.output_tokens for r in out["responses"])
    assert sum(out["by_pool"].values()) == 4
    assert "[serve] pool split" in capsys.readouterr().out


@pytest.mark.parametrize(
    "ref, port",
    [(repro.core, repro_torch.core), (repro.sim, repro_torch.sim),
     (repro.obs, repro_torch.obs), (repro.traces, repro_torch.traces)],
    ids=["core", "sim", "obs", "traces"],
)
def test_every_public_name_has_its_counterpart(ref, port):
    want = [JAX_NAMES.get(name, name) for name in ref.__all__]
    missing = [name for name in want if not hasattr(port, name)]
    assert missing == []
    # the port's list follows the reference's order and adds only pool_ids
    assert [n for n in port.__all__ if n != "pool_ids"] == want
    from_star: dict = {}
    exec(f"from {port.__name__} import *", from_star)
    assert set(want) <= set(from_star)


def make_router(b_short=8192, spillover=True, queue_limit=4):
    s_cfg = dataclasses.replace(short_pool(), queue_limit=queue_limit)
    return TokenBudgetRouter(
        PoolState(config=s_cfg), PoolState(config=long_pool()),
        b_short=b_short, spillover=spillover,
    )


class TestRouterViews:
    """``tests/test_router.py``'s uses of ``short``, ``long`` and
    ``b_short`` on the port's router."""

    def test_spillover_redirects_on_overload(self):
        r = make_router(queue_limit=2)
        r.short.queue_depth = 100  # overloaded
        d = r.route(Request(0, byte_len=400, max_output_tokens=16, category=0))
        assert d.pool == "long" and d.spilled

    def test_no_spillover_when_disabled(self):
        r = make_router(queue_limit=2, spillover=False)
        r.short.queue_depth = 100
        d = r.route(Request(0, byte_len=400, max_output_tokens=16, category=0))
        assert d.pool == "short"

    def test_spillover_respects_hard_constraint(self):
        r = make_router(queue_limit=2)
        r.long.queue_depth = 10_000
        d = r.route(Request(0, byte_len=200_000, max_output_tokens=8192, category=0))
        assert d.pool == "long"

    def test_b_short_view_and_setter(self):
        r = make_router(b_short=4096, spillover=False)
        assert r.b_short == 4096 and r.short is r.pools.states[0] and r.long is r.pools.states[-1]
        req = Request(0, byte_len=4 * 5000, max_output_tokens=100, category=0)  # est. 5100
        assert r.route(req).pool == "long"
        r.b_short = 8192
        assert r.b_short == 8192 and list(r.pools.thresholds) == [8192]
        assert r.route(req).pool == "short"
        with pytest.raises(ValueError):
            r.b_short = 100_000  # past the short pool's C_max
        assert r.b_short == 8192
