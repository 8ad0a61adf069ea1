"""The port's batch EMA calibration (float32, on tensors) against the
reference's ``jax_update`` / ``jax_update_stream`` / ``_update_stream_kernel``
and ``jax_estimate_budget`` / ``_estimate_budget_kernel``.

Mirrors ``tests/test_calibration_parity.py``. Where that file holds the JAX
fold against the scalar calibrator within float32 tolerance, this one holds
the port's fold against the JAX fold bit for bit (the port reproduces the
multiply-adds XLA fuses in the compiled scan), and against the port's own
scalar calibrator within the same tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import calibration as R  # noqa: E402
from repro_torch.core import calibration as T  # noqa: E402
from repro_torch.core.categories import NUM_CATEGORIES  # noqa: E402

F32_RTOL = 1e-5
F32_ATOL = 1e-6


def ref_stream(obs, state=None):
    return R.jax_update_stream(
        R.init_state() if state is None else state,
        jnp.array([o[0] for o in obs], jnp.float32),
        jnp.array([o[1] for o in obs], jnp.float32),
        jnp.array([o[2] for o in obs], jnp.int32),
    )


def port_stream(obs, state=None):
    return T.update_stream(
        T.init_state() if state is None else state,
        torch.tensor([o[0] for o in obs], dtype=torch.float32),
        torch.tensor([o[1] for o in obs], dtype=torch.float32),
        torch.tensor([o[2] for o in obs], dtype=torch.int32),
    )


def assert_same_state(port, ref):
    for name in ("ratio", "sigma", "count"):
        got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), (name, got, want)


def random_obs(seed, n, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 10_000, n)
    tokens[rng.random(n) < zero_frac] = 0
    return [
        (int(rng.integers(100, 50_000)), int(t), int(rng.integers(0, NUM_CATEGORIES)))
        for t in tokens
    ]


class TestColdStartParity:
    @pytest.mark.parametrize("category", range(NUM_CATEGORIES))
    def test_first_sample_per_category(self, category):
        obs = [(3000, 1000, category)]  # c_obs = 3.0
        state = port_stream(obs)
        assert float(state.ratio[category]) == 3.0
        assert float(state.sigma[category]) == 0.0
        assert_same_state(state, ref_stream(obs))

    @pytest.mark.parametrize("category", range(NUM_CATEGORIES))
    def test_second_sample_per_category(self, category):
        obs = [(3000, 1000, category), (5000, 1000, category)]
        state = port_stream(obs)
        assert float(state.sigma[category]) > 0.0
        assert_same_state(state, ref_stream(obs))

    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_interleaved_categories_from_cold(self, seed):
        obs = random_obs(seed, 400)
        state = port_stream(obs)
        assert_same_state(state, ref_stream(obs))
        # the scalar calibrator (float64) within float32 tolerance, as the
        # reference's own parity test holds its JAX fold
        cal = T.EmaCalibrator()
        for b, p, k in obs:
            cal.observe(b, p, k)
        np.testing.assert_allclose(state.ratio.numpy(), np.asarray(cal.ratio, np.float32), rtol=1e-4)
        np.testing.assert_allclose(
            state.sigma.numpy(), np.asarray(cal.sigma, np.float32), rtol=1e-3, atol=1e-5
        )

    def test_fold_matches_the_cached_kernel_from_a_warm_state(self):
        """A warm, non-cold state through the cached per-chunk kernel that
        the compiled DES's budget precompute uses."""
        ratio = np.asarray([3.1, 2.2, 4.4, 1.7], np.float32)
        sigma = np.asarray([0.3, 0.0, 5.0, 0.1], np.float32)
        count = np.asarray([3, 0, 0, 7], np.int32)
        obs = random_obs(11, 256, zero_frac=0.1)
        ref = R._update_stream_kernel(256, 0.95)(
            R.CalibState(jnp.asarray(ratio), jnp.asarray(sigma), jnp.asarray(count)),
            jnp.asarray([o[0] for o in obs], jnp.float32),
            jnp.asarray([o[1] for o in obs], jnp.float32),
            jnp.asarray([o[2] for o in obs], jnp.int32),
        )
        port = port_stream(
            obs, T.CalibState(torch.tensor(ratio), torch.tensor(sigma), torch.tensor(count))
        )
        assert_same_state(port, ref)

    def test_sigma_prior_replaced_at_count_zero(self):
        state = T.init_state()
        state.sigma[1] = 5.0  # stale prior, count still 0
        ref_state = R.CalibState(
            ratio=R.init_state().ratio,
            sigma=R.init_state().sigma.at[1].set(5.0),
            count=R.init_state().count,
        )
        port = T.update(state, torch.tensor(3000.0), torch.tensor(1000.0), torch.tensor(1))
        ref = R.jax_update(ref_state, jnp.float32(3000.0), jnp.float32(1000.0), jnp.int32(1))
        assert float(port.sigma[1]) == 0.0
        assert float(state.sigma[1]) == 5.0  # update returns a new state
        assert_same_state(port, ref)

    def test_observe_batch_syncs_scalar_state(self):
        """observe_batch (the vectorized backend's epoch sync) lands on the
        reference's observe_batch state bit for bit (the reference pads to
        a 4096-row chunk; the port folds the rows as they are)."""
        obs = random_obs(11, 300)
        cols = ([o[0] for o in obs], [o[1] for o in obs], [o[2] for o in obs])
        port, ref = T.EmaCalibrator(), R.EmaCalibrator()
        port.observe_batch(*cols)
        ref.observe_batch(*cols)
        assert port.ratio == ref.ratio
        assert port.sigma == ref.sigma
        assert port.count == ref.count

    def test_padding_rows_are_inert(self):
        state = T.update(T.init_state(), torch.tensor(1000.0), torch.tensor(0.0), torch.tensor(0))
        assert int(state.count[0]) == 0
        assert torch.equal(state.ratio, T.init_state().ratio)
        assert torch.equal(state.sigma, T.init_state().sigma)

    def test_state_roundtrip(self):
        cal = T.EmaCalibrator()
        cal.observe(3000, 1000, 2)
        state = cal.to_state()
        assert state.ratio.dtype == torch.float32 and state.count.dtype == torch.int32
        other = T.EmaCalibrator()
        other.load_state(state)
        assert other.count == cal.count
        assert other.ratio == [float(np.float32(r)) for r in cal.ratio]


class TestEstimateParity:
    @pytest.mark.parametrize("gamma", [1.0, 0.7, 1.3, 2.5])
    def test_estimate_budget_bit_identical(self, gamma):
        """Eq. 3 with the float32 L_in estimate; ``ratio - gamma*sigma`` is
        one fused multiply-add in the compiled reference."""
        rng = np.random.default_rng(int(gamma * 10))
        ratio = rng.uniform(1.0, 5.0, NUM_CATEGORIES).astype(np.float32)
        sigma = rng.uniform(0.0, 1.0, NUM_CATEGORIES).astype(np.float32)
        count = np.ones(NUM_CATEGORIES, np.int32)
        n = 4096
        bl = rng.integers(1, 400_000, n).astype(np.int32)
        mo = rng.integers(1, 40_000, n).astype(np.int32)
        ca = rng.integers(0, NUM_CATEGORIES, n).astype(np.int32)
        ref = np.asarray(R._estimate_budget_kernel(n, gamma)(
            R.CalibState(jnp.asarray(ratio), jnp.asarray(sigma), jnp.asarray(count)),
            jnp.asarray(bl), jnp.asarray(mo), jnp.asarray(ca),
        ))
        got = T.estimate_budget(
            T.CalibState(torch.tensor(ratio), torch.tensor(sigma), torch.tensor(count)),
            torch.tensor(bl), torch.tensor(mo), torch.tensor(ca), gamma=gamma,
        ).numpy()
        assert got.dtype == ref.dtype == np.int32
        assert np.array_equal(got, ref)
