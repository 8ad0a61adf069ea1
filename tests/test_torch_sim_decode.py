"""The port's DES decode-advance round (plain PyTorch version on the CPU)
against the reference's jnp oracle and its Pallas kernel in interpret mode.

Mirrors ``tests/test_kernels.py``'s sim_decode tests, plus stacked pools
with different ``c_max``, idle rows, ``t_limit = inf``, rows whose KV growth
overflows their free blocks, and non-dyadic timing. Every comparison is bit
for bit (NaN-aware on ``ft``).

The reference's compiled tier runs the pass under ``jax.jit``, where XLA
contracts ``w + h*nact`` and ``now + k*t_it`` into fused multiply-adds; the
port does the same. With dyadic timing constants those products are exact,
so the eager oracle agrees too; with the A100 constants only the compiled
reference does, and the eager oracle differs in ``end``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro.kernels.sim_decode import (  # noqa: E402
    decode_advance_jnp,
    decode_advance_pallas,
)
from repro_torch.kernels.sim_decode import (  # noqa: E402
    OUTPUTS,
    decode_advance,
    decode_advance_plain,
    random_state,
)

DYADIC = dict(w=2**-10, h=2**-13, chunk=512)
A100 = dict(w=8.0e-3, h=0.65e-3, chunk=512)
ARGS = ("busy", "now", "nact", "free", "occ", "pre", "sq", "inp", "gen", "rem", "blk", "ft", "tr")


def reference(state, timing, fn):
    """Run a reference function pool by pool (its c_max is per call) and
    stack the outputs as numpy arrays."""
    c_max = state["c_max"].tolist()
    t_lim = float(state["t_limit"])
    outs = []
    with jax.experimental.enable_x64():
        for p, cm in enumerate(c_max):
            args = [state[k][p].numpy() for k in ARGS]
            out = fn(t_lim, *args, c_max=cm, **timing)
            outs.append({k: np.asarray(v) for k, v in out.items()})
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def plain(state, timing):
    out = decode_advance_plain(
        state["t_limit"], *(state[k] for k in ARGS), state["c_max"], **timing
    )
    return {k: v.numpy() for k, v in out.items()}


def assert_bit_identical(got, expect):
    assert set(got) == set(expect) == set(OUTPUTS)
    for k in OUTPUTS:
        assert got[k].dtype == expect[k].dtype, k
        assert np.array_equal(got[k], expect[k], equal_nan=True), k


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plain_matches_jnp_and_pallas(seed):
    """The reference test's shapes (one pool, 3 rows of 8 slots)."""
    state = random_state(seed, [2048], 3, 8)
    got = plain(state, DYADIC)
    assert_bit_identical(got, reference(state, DYADIC, decode_advance_jnp))
    assert_bit_identical(got, reference(state, DYADIC, decode_advance_pallas))


@pytest.mark.parametrize("t_limit", [None, float("inf")])
@pytest.mark.parametrize("seed", [2, 3])
def test_stacked_pools_match_per_pool_reference(seed, t_limit):
    """Three pools with different c_max in one call; idle rows, rows with
    no free blocks and slots near c_max are all present."""
    state = random_state(seed, [1024, 2048, 4096], 6, 16, t_limit=t_limit)
    assert (~state["busy"] & (state["nact"] > 0)).any()  # idle rows
    assert (state["busy"] & (state["free"] == 0)).any()  # growth overflow
    got = plain(state, DYADIC)
    assert got["trunc_new"].any()  # truncation at c_max happens
    assert (got["k"] == 1).any() and (got["k"] > 1).any()
    assert_bit_identical(got, reference(state, DYADIC, decode_advance_jnp))
    assert_bit_identical(got, reference(state, DYADIC, decode_advance_pallas))


@pytest.mark.parametrize("seed", [4, 5])
def test_fused_multiply_adds_match_compiled_reference(seed):
    """Non-dyadic (A100) timing: bit-identical to the jitted oracle and the
    Pallas kernel, which XLA compiles with fused multiply-adds."""
    state = random_state(seed, [2048, 8192], 64, 16, t_limit=float("inf"))
    # long jumps (no prefill, long outputs, ample blocks), so k*t_it rounds
    state["pre"].zero_()
    state["rem"] += 400 * state["occ"].to(torch.int32)
    state["free"].fill_(1 << 20)
    got = plain(state, A100)
    assert (got["k"] > 100).any()
    jitted = functools.partial(jax.jit, static_argnames=("w", "h", "chunk", "c_max"))
    assert_bit_identical(got, reference(state, A100, jitted(decode_advance_jnp)))
    assert_bit_identical(got, reference(state, A100, decode_advance_pallas))
    eager = reference(state, A100, decode_advance_jnp)
    assert not np.array_equal(got["end"], eager["end"])  # two roundings differ


def test_idle_instances_are_inert():
    """Idle rows complete and truncate nothing (the engine consumes those
    outputs unmasked)."""
    state = random_state(3, [2048], 3, 8)
    state["busy"].zero_()
    state["now"].zero_()
    out = plain(state, DYADIC)
    assert not out["comp"].any()
    assert not out["trunc_new"].any()
    assert np.array_equal(out["pre"], state["pre"].numpy())


def test_wrapper_runs_the_plain_version_on_cpu():
    state = random_state(6, [1024, 4096], 4, 8)
    before = decode_advance.launches
    out = decode_advance(state["t_limit"], *(state[k] for k in ARGS), state["c_max"], **A100)
    assert decode_advance.launches == before  # no kernel launch on the CPU
    assert_bit_identical({k: v.numpy() for k, v in out.items()}, plain(state, A100))


def reference_lanes(state, timing, fn):
    """A reference function ``jax.vmap``-ed over the grid lanes, as the
    reference's ``run_fleet_grid`` runs it (one time limit a lane), pool by
    pool (its c_max is per call); outputs stacked to ``(G, P, ...)``."""
    t_lim = state["t_limit"].numpy()
    outs = []
    with jax.experimental.enable_x64():
        for p, cm in enumerate(state["c_max"].tolist()):
            args = [state[k][:, p].numpy() for k in ARGS]
            lanes = jax.vmap(functools.partial(fn, c_max=cm, **timing))
            out = lanes(t_lim, *args)
            outs.append({k: np.asarray(v) for k, v in out.items()})
    return {k: np.stack([o[k] for o in outs], axis=1) for k in outs[0]}


@pytest.mark.parametrize("t_limit", [None, [1.9, float("inf"), 2.6]])
@pytest.mark.parametrize("seed", [8, 9])
def test_lanes_match_vmapped_reference(seed, t_limit):
    """(G, P, I, S) = (3, 2, 3, 5) with a different time limit in each lane
    (one lane at +inf in the second case): bit-identical to ``jax.vmap`` of
    the Pallas kernel in interpret mode and of the jnp oracle."""
    state = random_state(seed, [1024, 4096], 3, 5, t_limit=t_limit, lanes=3)
    assert state["occ"].shape == (3, 2, 3, 5) and state["t_limit"].shape == (3,)
    assert len(set(state["t_limit"].tolist())) == 3
    got = plain(state, DYADIC)
    assert (got["k"] == 1).any() and (got["k"] > 1).any()
    assert_bit_identical(got, reference_lanes(state, DYADIC, decode_advance_jnp))
    assert_bit_identical(got, reference_lanes(state, DYADIC, decode_advance_pallas))


def test_lanes_are_independent():
    """Each lane of a (G, P, I, S) call is the one-lane call on that lane's
    slots and time limit."""
    state = random_state(10, [2048, 8192], 4, 6, lanes=3)
    got = plain(state, A100)
    for g in range(3):
        lane = {k: (v if k == "c_max" else v[g]) for k, v in state.items()}
        one = plain(lane, A100)
        for k in OUTPUTS:
            assert np.array_equal(got[k][g], one[k], equal_nan=True), (g, k)
