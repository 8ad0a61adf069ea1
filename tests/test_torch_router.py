"""The port's batch routing (``route_batch``, ``pool_ids``) against the
reference's ``jax_route_batch`` / ``jax_pool_ids``, and against its own
scalar ``route()``.

Mirrors ``tests/test_router_parity.py`` for P in {2, 3, 4} pools at every
exact threshold boundary (``B_k``, ``B_k ± 1``, and budgets beyond the
largest ``C_max``). Port and reference batch paths are bit-identical
(both float32 L_in estimates); the scalar path estimates in float64, so it
may differ from either by one token, as the reference's contract says.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import router as rrouter  # noqa: E402
from repro.core.calibration import EmaCalibrator as RCal  # noqa: E402
from repro_torch.core.calibration import EmaCalibrator  # noqa: E402
from repro_torch.core.pools import PoolConfig, PoolSet, PoolState, n_seq_for_cmax  # noqa: E402
from repro_torch.core.router import Request, TokenBudgetRouter, pool_ids  # noqa: E402

TOPOLOGIES = {
    2: ((8192, 65_536), (8192,)),
    3: ((4096, 16_384, 65_536), (4096, 16_384)),
    4: ((2048, 8192, 16_384, 65_536), (2048, 8192, 16_384)),
}
NUM_CATEGORIES = 4


def make_router(n_pools: int, calibrator=None) -> TokenBudgetRouter:
    c_maxs, thresholds = TOPOLOGIES[n_pools]
    states = [
        PoolState(config=PoolConfig(f"pool{k}", c, n_seq_for_cmax(c, max_slots=64)))
        for k, c in enumerate(c_maxs)
    ]
    return TokenBudgetRouter(
        pools=PoolSet(states, thresholds), calibrator=calibrator, spillover=False
    )


def boundary_requests(router: TokenBudgetRouter) -> list[Request]:
    """Requests whose estimated budgets land exactly on every boundary
    (``byte_len=1`` estimates one input token at any sane ratio)."""
    largest_cmax = router.pools.configs[-1].c_max
    targets = sorted(
        {t for b in router.pools.thresholds for t in (int(b) - 1, int(b), int(b) + 1)}
        | {2, largest_cmax, largest_cmax + 1, 4 * largest_cmax}
    )
    return [
        Request(request_id=i, byte_len=1, max_output_tokens=t - 1, category=cat)
        for i, (t, cat) in enumerate(
            (t, cat) for t in targets for cat in range(NUM_CATEGORIES)
        )
    ]


def warmed_calibrators(seed: int = 0):
    """The same observation stream through the port's and the reference's
    scalar calibrators (identical float64 state)."""
    port, ref = EmaCalibrator(), RCal()
    rng = np.random.default_rng(seed)
    true_ratio = {0: 4.4, 1: 3.1, 2: 2.0, 3: 3.6}
    for _ in range(80):
        cat = int(rng.integers(0, NUM_CATEGORIES))
        tokens = int(rng.integers(100, 4000))
        noisy = tokens * (true_ratio[cat] + rng.normal(0, 0.3))
        for c in (port, ref):
            c.observe(max(1, int(noisy)), tokens, cat)
    return port, ref


def reference_batch(ref_cal, thresholds, requests):
    ids, budgets = rrouter.jax_route_batch(
        ref_cal.to_state(),
        jnp.asarray([r.byte_len for r in requests], jnp.int32),
        jnp.asarray([r.max_output_tokens for r in requests], jnp.int32),
        jnp.asarray([r.category for r in requests], jnp.int32),
        thresholds=list(thresholds),
        gamma=ref_cal.gamma,
    )
    return np.asarray(ids), np.asarray(budgets)


@pytest.mark.parametrize("n_pools", [2, 3, 4])
class TestStaticParity:
    def assert_parity(self, router, ref_cal, requests, *, exact=True):
        pool_idx, budgets = router.route_batch(
            [r.byte_len for r in requests],
            [r.max_output_tokens for r in requests],
            [r.category for r in requests],
        )
        ref_ids, ref_budgets = reference_batch(ref_cal, router.pools.thresholds, requests)
        assert pool_idx.dtype == budgets.dtype == np.int32
        assert np.array_equal(pool_idx, ref_ids)
        assert np.array_equal(budgets, ref_budgets)
        thresholds = router.pools.thresholds
        for i, r in enumerate(requests):
            d = router.route(r)
            if exact:
                assert d.estimated_total == int(budgets[i]), f"req {i}"
            else:
                assert abs(d.estimated_total - int(budgets[i])) <= 1, f"req {i}"
            lo, hi = sorted((d.estimated_total, int(budgets[i])))
            if not np.any((thresholds >= lo) & (thresholds < hi)):
                assert d.pool_index == int(pool_idx[i]), f"req {i}"

    def test_boundary_budgets_cold(self, n_pools):
        router = make_router(n_pools)
        self.assert_parity(router, RCal(), boundary_requests(router))

    def test_boundary_budgets_warmed(self, n_pools):
        port, ref = warmed_calibrators()
        router = make_router(n_pools, calibrator=port)
        self.assert_parity(router, ref, boundary_requests(router))

    def test_random_requests_warmed(self, n_pools):
        port, ref = warmed_calibrators(7)
        router = make_router(n_pools, calibrator=port)
        rng = np.random.default_rng(n_pools)
        requests = [
            Request(
                request_id=i,
                byte_len=int(rng.integers(1, 400_000)),
                max_output_tokens=int(rng.integers(1, 40_000)),
                category=int(rng.integers(0, NUM_CATEGORIES)),
            )
            for i in range(300)
        ]
        self.assert_parity(router, ref, requests, exact=False)

    def test_pool_ids_at_exact_thresholds(self, n_pools):
        _, thresholds = TOPOLOGIES[n_pools]
        budgets = np.asarray(
            sorted({t for b in thresholds for t in (b - 1, b, b + 1)} | {0, 1 << 20}), np.int32
        )
        got = pool_ids(torch.tensor(thresholds, dtype=torch.int32), torch.tensor(budgets))
        ref = np.asarray(rrouter.jax_pool_ids(jnp.asarray(thresholds, jnp.int32), jnp.asarray(budgets)))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)

    def test_beyond_largest_cmax_goes_last_pool(self, n_pools):
        router = make_router(n_pools)
        big = 4 * router.pools.configs[-1].c_max
        d = router.route(Request(0, byte_len=1, max_output_tokens=big, category=0))
        ids, _ = router.route_batch([1], [big], [0])
        assert d.pool_index == int(ids[0]) == n_pools - 1


class TestBatchCounters:
    def test_output_has_input_length(self):
        router = make_router(3)
        for n in (1, 5, 37, 100, 1000):
            ids, budgets = router.route_batch([100] * n, [64] * n, [0] * n)
            assert len(ids) == len(budgets) == n

    def test_prefix_of_a_batch_routes_like_the_batch(self):
        port, _ = warmed_calibrators(3)
        router = make_router(3, calibrator=port)
        rng = np.random.default_rng(11)
        byte_lens = rng.integers(1, 200_000, size=256)
        caps = rng.integers(1, 30_000, size=256)
        cats = rng.integers(0, NUM_CATEGORIES, size=256)
        full_ids, full_budgets = router.route_batch(byte_lens, caps, cats)
        for n in (37, 100, 255):
            ids, budgets = router.route_batch(byte_lens[:n], caps[:n], cats[:n])
            np.testing.assert_array_equal(ids, full_ids[:n])
            np.testing.assert_array_equal(budgets, full_budgets[:n])

    def test_counters_count_each_decision_once(self):
        router = make_router(3)
        n = 37
        ids, budgets = router.route_batch([100] * n, [64] * n, [0] * n)
        for pid, budget in zip(ids, budgets):
            router.route_decided(int(pid), int(budget))
        assert sum(router.routed.values()) == n

    def test_feedback_batch_matches_reference(self):
        port, ref = EmaCalibrator(), RCal()
        rng = np.random.default_rng(5)
        cols = (rng.integers(10, 9000, 500), rng.integers(1, 3000, 500), rng.integers(0, 4, 500))
        make_router(2, calibrator=port).on_response_batch(*cols)
        ref.observe_batch(*cols)
        assert (port.ratio, port.sigma, port.count) == (ref.ratio, ref.sigma, ref.count)

    def test_fleet_ragged_final_epoch_counts_exact(self):
        """A vectorized fleet whose trace does not fill its final routing
        epoch routes exactly len(trace) requests."""
        from repro_torch.sim.fleet import FleetSim
        from repro_torch.sim.timing import TimingModel
        from repro_torch.traces import TraceSpec, generate_trace_columns

        cols = generate_trace_columns(
            TraceSpec(trace="azure", num_requests=100, rate=200.0, seed=5)
        )
        cfgs = {
            "short": (PoolConfig("short", 8192, 32), 2),
            "long": (PoolConfig("long", 65_536, 8), 2),
        }
        timing = TimingModel("fast", w_base=1e-3, h_per_seq=1e-4, prefill_chunk=512)
        sim = FleetSim(cfgs, timing, backend="vectorized")
        res = sim.run(cols)
        assert sum(sim.router.routed.values()) == len(cols)
        assert res.summary.num_requests == len(cols) - int(len(cols) * 0.2)
        assert sum(sim.router.calibrator.count) <= len(cols)
