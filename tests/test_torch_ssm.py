"""The port's SSD chunk scan and Mamba-2 block against the reference, on the
CPU (the port's plain versions; the reference's Pallas kernel in interpret
mode, as its own tests run it).

Tolerances: the reference's own (``tests/test_kernels.py::SSD_CASES``):
5e-5 to 1e-4 in f32, where the two packages differ only in summation order
and chunk length; 6e-2 in bf16, where the reference's ``ops.ssd_scan``
folds dt into x in bf16 and the port folds it in f32. Block-level bf16
comparisons allow BF16_ULPS ulps of bf16 at the output's scale, as
``tests/test_torch_models.py`` does.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import params as jparams_lib  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32, BF16 = jnp.float32, jnp.bfloat16

SSD_CASES = [
    # (B, L, H, P, N, chunk, dtype, tol) — tests/test_kernels.py::SSD_CASES
    (2, 128, 4, 32, 16, 32, F32, 5e-5),
    (1, 256, 2, 64, 64, 128, F32, 1e-4),
    (2, 64, 8, 16, 32, 64, F32, 5e-5),
    (2, 128, 4, 32, 16, 32, BF16, 6e-2),
]
BF16_ULPS = 4


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def to_torch(x):
    return params_from_numpy(np.asarray(x), device="cpu")


def bf16_tol(ref_out) -> float:
    top = float(np.abs(as_np(ref_out)).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def ssd_inputs(seed, B, L, H, P, N, dtype):
    """The reference test's draws: x, B, C normal in ``dtype``, dt in
    [0.01, 0.2], A in -[0.5, 2]."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, L, H, P)).astype(np.float32)).astype(dtype)
    dt = jnp.asarray(rng.uniform(0.01, 0.2, (B, L, H)), F32)
    a = -jnp.asarray(rng.uniform(0.5, 2.0, (H,)), F32)
    bm = jnp.asarray(rng.normal(size=(B, L, N)).astype(np.float32)).astype(dtype)
    cm = jnp.asarray(rng.normal(size=(B, L, N)).astype(np.float32)).astype(dtype)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_plain_matches_pallas_kernel(case):
    """The kernel's plain version against the TPU kernel (interpret mode) on
    the same pre-folded inputs."""
    B, L, H, P, N, chunk, dtype, tol = case
    x, dt, a, bm, cm = ssd_inputs(3, B, L, H, P, N, dtype)
    xh = jnp.swapaxes(x * dt[..., None].astype(x.dtype), 1, 2)
    log_a = jnp.swapaxes(a[None, None, :] * dt, 1, 2)
    y, s = ssd_scan_pallas(xh, log_a, bm, cm, chunk=chunk, interpret=True)
    ty, ts = ssd_scan_plain(*(to_torch(t) for t in (xh, log_a, bm, cm)))
    assert ty.dtype == to_torch(xh).dtype and ts.dtype == torch.float32
    np.testing.assert_allclose(as_np(ty), as_np(y), atol=tol)
    np.testing.assert_allclose(as_np(ts), as_np(s), atol=max(tol, 1e-4))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ops_ssd_scan_matches_reference(case):
    """The port's ``ops.ssd_scan`` (dt folded in f32) against the
    reference's ``ops.ssd_scan`` (interpret mode) and its sequential oracle
    ``ref.ssd_scan_ref``."""
    B, L, H, P, N, chunk, dtype, tol = case
    x, dt, a, bm, cm = ssd_inputs(3, B, L, H, P, N, dtype)
    before = ssd_scan.launches
    ty, ts = ops.ssd_scan(*(to_torch(t) for t in (x, dt, a, bm, cm)))
    assert ssd_scan.launches == before  # CPU tensors run the plain version
    y, s = jops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, interpret=True)
    y_ref, s_ref = ref.ssd_scan_ref(x, dt, a, bm, cm)
    for want_y, want_s in ((y, s), (y_ref, s_ref)):
        np.testing.assert_allclose(as_np(ty), as_np(want_y), atol=tol)
        np.testing.assert_allclose(as_np(ts), as_np(want_s), atol=max(tol, 1e-4))


def stepwise(x, dt, a, bm, cm, s0):
    """The port's decode recurrence ``ssd_step`` over every position, from
    state ``s0``; B and C ``(B, L, G, N)``."""
    ys, s = [], s0
    for t in range(x.shape[1]):
        y, s = tssm.ssd_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], s)
        ys.append(y)
    return torch.stack(ys, 1), s


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_reference(case):
    """The reference model's ``ssd_chunked``: from a zero state against the
    port's prefill scan ``ops.ssd_scan``, from a carried state against the
    port's decode recurrence ``ssd_step`` run over the sequence."""
    B, L, H, P, N, chunk, dtype, tol = case
    x, dt, a, bm, cm = ssd_inputs(3, B, L, H, P, N, dtype)
    rng = np.random.default_rng(4)
    s0 = jnp.asarray(rng.normal(size=(B, H, P, N)), F32)
    tx, tdt, ta, tb, tc = (to_torch(t) for t in (x, dt, a, bm, cm))
    y, s = jssm.ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=chunk)
    ty, ts = ops.ssd_scan(tx, tdt, ta, tb, tc)
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(as_np(ty), as_np(y), atol=tol)
    np.testing.assert_allclose(as_np(ts), as_np(s), atol=max(tol, 1e-4))
    y, s = jssm.ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=chunk,
                            initial_state=s0)
    ty, ts = stepwise(tx, tdt, ta, tb[:, :, None], tc[:, :, None], to_torch(s0))
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(as_np(ty), as_np(y), atol=tol)
    np.testing.assert_allclose(as_np(ts), as_np(s), atol=max(tol, 1e-4))


def test_ssd_chunked_groups_match_reference():
    """Two groups of heads, each with its own B and C: the reference's
    ``ssd_chunked`` against the port's ``ssd_step``, which maps each head to
    its group (the served model has one group)."""
    rng = np.random.default_rng(6)
    B, L, H, P, G, N = 2, 64, 4, 8, 2, 16
    x = jnp.asarray(rng.normal(size=(B, L, H, P)), F32)
    dt = jnp.asarray(rng.uniform(0.01, 0.2, (B, L, H)), F32)
    a = -jnp.asarray(rng.uniform(0.5, 2.0, (H,)), F32)
    bm = jnp.asarray(rng.normal(size=(B, L, G, N)), F32)
    cm = jnp.asarray(rng.normal(size=(B, L, G, N)), F32)
    y, s = jssm.ssd_chunked(x, dt, a, bm, cm, chunk=16)
    ty, ts = stepwise(*(to_torch(t) for t in (x, dt, a, bm, cm)), torch.zeros(B, H, P, N))
    np.testing.assert_allclose(as_np(ty), as_np(y), atol=5e-5)
    np.testing.assert_allclose(as_np(ts), as_np(s), atol=1e-4)


@pytest.mark.parametrize("length", [1, 37, 200])
def test_ragged_length_matches_sequential_oracle(length):
    """Lengths the reference's chunked scan refuses (L > 128 and not a
    multiple of 128, or not a multiple of its chunk): the port pads the tail
    chunk with x = 0, log_a = 0 and agrees with the sequential recurrence,
    as its decode recurrence does."""
    x, dt, a, bm, cm = ssd_inputs(5, 1, length, 3, 16, 8, F32)
    y_ref, s_ref = ref.ssd_scan_ref(x, dt, a, bm, cm)
    tx, tdt, ta, tb, tc = (to_torch(t) for t in (x, dt, a, bm, cm))
    ty, ts = ops.ssd_scan(tx, tdt, ta, tb, tc)
    np.testing.assert_allclose(as_np(ty), as_np(y_ref), atol=5e-5)
    np.testing.assert_allclose(as_np(ts), as_np(s_ref), atol=1e-4)
    ty, ts = stepwise(tx, tdt, ta, tb[:, :, None], tc[:, :, None], torch.zeros(1, 3, 16, 8))
    np.testing.assert_allclose(as_np(ty), as_np(y_ref), atol=5e-5)
    np.testing.assert_allclose(as_np(ts), as_np(s_ref), atol=1e-4)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(7)
    B, H, P, N = 3, 4, 8, 16
    x = jnp.asarray(rng.normal(size=(B, H, P)), F32)
    dt = jnp.asarray(rng.uniform(0.01, 0.2, (B, H)), F32)
    a = -jnp.asarray(rng.uniform(0.5, 2.0, (H,)), F32)
    bm = jnp.asarray(rng.normal(size=(B, 1, N)), F32)
    cm = jnp.asarray(rng.normal(size=(B, 1, N)), F32)
    s0 = jnp.asarray(rng.normal(size=(B, H, P, N)), F32)
    y, s = jssm.ssd_step(x, dt, a, bm, cm, s0)
    ty, ts = tssm.ssd_step(*(to_torch(t) for t in (x, dt, a, bm, cm, s0)))
    np.testing.assert_allclose(as_np(ty), as_np(y), atol=1e-5)
    np.testing.assert_allclose(as_np(ts), as_np(s), atol=1e-5)


# ---------------------------------------------------------------------------
# The Mamba-2 block
# ---------------------------------------------------------------------------

D_MODEL, D_INNER, N_HEADS, HEAD_DIM, D_STATE, D_CONV = 64, 128, 4, 32, 16, 4


def block_params(dtype):
    """The reference's block parameters (a_log, dt_bias and norm drawn so
    the test reaches them; the reference initializes them to constants),
    weights in ``dtype``."""
    defs = jssm.mamba2_param_defs(D_MODEL, D_INNER, N_HEADS, D_STATE, D_CONV)
    p = dict(jparams_lib.init_params(defs, jax.random.key(1)))
    rng = np.random.default_rng(8)
    p["a_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, N_HEADS), F32)
    p["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5, N_HEADS), F32)
    p["norm"] = jnp.asarray(rng.normal(0.0, 0.1, D_INNER), F32)
    p = jax.tree.map(lambda t: t.astype(dtype) if t.dtype == BF16 else t, p)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


KW = dict(n_heads=N_HEADS, head_dim=HEAD_DIM, d_state=D_STATE)
# the reference's block compiled once per input shape (eager op-by-op
# dispatch costs seconds)
j_block = jax.jit(functools.partial(jssm.mamba2_block, **KW))
j_decode = jax.jit(functools.partial(jssm.mamba2_decode_step, **KW))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_mamba2_block_matches_reference(dtype):
    jp, tp = block_params(dtype)
    x = jnp.asarray(np.random.default_rng(9).normal(size=(2, 64, D_MODEL)), F32).astype(dtype)
    out, st = j_block(x, jp)
    tout, tst = tssm.mamba2_block(to_torch(x), tp, **KW)
    assert tout.dtype == to_torch(x).dtype
    tol = 1e-4 if dtype == F32 else bf16_tol(out)
    np.testing.assert_allclose(as_np(tout), as_np(out), atol=tol)
    np.testing.assert_allclose(as_np(tst["conv"]), as_np(st["conv"]),
                               atol=1e-5 if dtype == F32 else bf16_tol(st["conv"]))
    np.testing.assert_allclose(as_np(tst["ssd"]), as_np(st["ssd"]),
                               atol=1e-4 if dtype == F32 else bf16_tol(st["ssd"]))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_mamba2_decode_step_matches_reference(dtype):
    """One token from a carried state: the reference runs ``ssd_chunked``
    with chunk=1, the port the recurrence ``ssd_step``."""
    jp, tp = block_params(dtype)
    rng = np.random.default_rng(10)
    x = jnp.asarray(rng.normal(size=(3, 1, D_MODEL)), F32).astype(dtype)
    state = {
        "conv": jnp.asarray(rng.normal(size=(3, D_CONV - 1, D_INNER + 2 * D_STATE)), F32).astype(dtype),
        "ssd": jnp.asarray(rng.normal(size=(3, N_HEADS, HEAD_DIM, D_STATE)), F32),
    }
    out, st = j_decode(x, jp, state)
    tout, tst = tssm.mamba2_decode_step(
        to_torch(x), tp, {k: to_torch(v) for k, v in state.items()}, **KW
    )
    tol = 1e-4 if dtype == F32 else bf16_tol(out)
    np.testing.assert_allclose(as_np(tout), as_np(out), atol=tol)
    np.testing.assert_allclose(as_np(tst["conv"]), as_np(st["conv"]),
                               atol=1e-5 if dtype == F32 else bf16_tol(st["conv"]))
    np.testing.assert_allclose(as_np(tst["ssd"]), as_np(st["ssd"]),
                               atol=1e-4 if dtype == F32 else bf16_tol(st["ssd"]))


def test_prefill_state_continues_like_the_whole_prompt():
    """The block over a prompt, then decode steps from its state, equals the
    block over the longer prompt (the port's prefill kernel path and its
    decode recurrence agree)."""
    _, tp = block_params(F32)
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(1, 40, D_MODEL)).astype(np.float32))
    whole, _ = tssm.mamba2_block(x, tp, **KW)
    out, st = tssm.mamba2_block(x[:, :33], tp, **KW)
    steps = [out]
    for t in range(33, 40):
        o, st = tssm.mamba2_decode_step(x[:, t : t + 1], tp, st, **KW)
        steps.append(o)
    np.testing.assert_allclose(as_np(torch.cat(steps, 1)), as_np(whole), atol=1e-4)
