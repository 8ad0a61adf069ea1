"""The port's xLSTM (xlstm-350m) against the reference, on the CPU.

The cells first: ``mlstm_chunked`` (one chunk and two, from zeros and from
a given state), a ragged length the reference refuses (L = 200 with chunk
128; the port pads the last chunk exactly, ROADMAP.md C) against the
reference at a chunk that divides it and against its ``mlstm_step`` token
by token, a forget gate strong enough that the decay above a chunk's
diagonal overflows f32, and ``slstm_scan`` from its own initial state and
from a given one. Then xlstm-350m reduced (2 groups of one mLSTM and one
sLSTM block) with the reference's parameters carried by
``params_from_numpy``: forward, prefill (logits and every state leaf) and
one decode step from a random state, in f32 and bf16; decode continuing a
prefill equals the prefill of one more token; both packages'
``TwoPoolServer`` token for token; and a 200-token prompt served by the
port against a forward over the same tokens.

About the parameters: the reference's fan-in rule makes the mLSTM's q·k
and the sLSTM's gate preactivations large at random init (the sLSTM's
(d, heads, head_dim) gate projections are scaled by the head count, as
attention's ``w_q`` is: preactivations of std ~5.6 at reduced widths, ~16
at full). Then the exponential gates and the mLSTM's normalizer max(|n·q|,
1), a signed sum near 0, turn a one-ulp difference in a bf16 input into a
different state: measured at reduced widths, untempered, 37 bf16 ulps on
the sLSTM's h after a 48-token prefill against 4 at most for each block fed
the same input; at full width a bf16 decode step reads 0.30 relative L2 off
a forward, and 7e-5 in f32 (the port's own readings, on the CPU).
``reference_params`` therefore scales the mLSTM's ``w_q``/``w_k`` and the
sLSTM's ``w_z``/``w_i``/``w_f``/``w_o`` by 0.1, in the reference's own tree
before both packages see it, as ``tests/test_torch_models.py`` does for
attention.

Tolerances are ``tests/test_torch_models.py``'s: f32 1e-4 on states and
1e-3 on logits (the two packages sum the same products in other orders);
bf16 4 ulps at the tensor's scale. The mLSTM's matrix state C sums gated
outer products whose gates reach e^5, so the f32 cell comparisons are
relative as well (1e-4 of each value, on top of 1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import ShapeCell as JaxShapeCell  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serving import SlotKVCache as JaxSlotKVCache  # noqa: E402
from repro.serving import TwoPoolServer as JaxTwoPoolServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.serving import SlotKVCache, TwoPoolServer  # noqa: E402
from test_torch_models import (  # noqa: E402
    F32_ATTN,
    F32_LOGITS,
    as_np,
    bf16_tol,
    reference_params,
)

ARCH = "xlstm-350m"
F32_STATE = F32_ATTN
DTYPES = [(jnp.float32, F32_STATE, F32_LOGITS), (jnp.bfloat16, None, None)]
DTYPE_IDS = ["f32", "bf16"]
B, H, DK = 2, 4, 16


def cell_inputs(length: int, seed: int):
    """q, k, v (B, L, H, DK), the gates' preactivations (B, L, H) and an
    initial (C, n), f32 numpy."""
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(B, length, H, DK)).astype(np.float32) for _ in range(3)]
    i_pre = rng.normal(0.0, 2.0, (B, length, H)).astype(np.float32)
    f_pre = rng.normal(2.0, 1.5, (B, length, H)).astype(np.float32)
    c0 = rng.normal(size=(B, H, DK, DK)).astype(np.float32)
    n0 = rng.normal(size=(B, H, DK)).astype(np.float32)
    return qkv, i_pre, f_pre, (c0, n0)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("length", [64, 256])
def test_mlstm_chunked_matches_reference(length, with_state):
    qkv, i_pre, f_pre, st = cell_inputs(length, seed=length)
    init = st if with_state else None
    jh, (jc, jn) = jx.mlstm_chunked(
        *map(jnp.asarray, qkv), jnp.asarray(i_pre), jnp.asarray(f_pre), chunk=128,
        initial_state=None if init is None else tuple(map(jnp.asarray, init)),
    )
    th, (tc, tn) = tx.mlstm_chunked(
        *map(torch.from_numpy, qkv), torch.from_numpy(i_pre), torch.from_numpy(f_pre),
        chunk=128, initial_state=None if init is None else tuple(map(torch.from_numpy, init)),
    )
    assert th.shape == jh.shape and tc.dtype == torch.float32
    for got, want in ((th, jh), (tc, jc), (tn, jn)):
        close(got, want, F32_STATE)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_mlstm_ragged_length(with_state):
    """L = 200 with chunk 128: the reference raises; the port pads its last
    chunk and equals the reference at chunk 8 (which divides 200) and the
    reference's one-token step applied 200 times."""
    length = 200
    qkv, i_pre, f_pre, st = cell_inputs(length, seed=7)
    jargs = (*map(jnp.asarray, qkv), jnp.asarray(i_pre), jnp.asarray(f_pre))
    jinit = tuple(map(jnp.asarray, st)) if with_state else None
    with pytest.raises(ValueError, match="must divide"):
        jx.mlstm_chunked(*jargs, chunk=128)
    th, (tc, tn) = tx.mlstm_chunked(
        *map(torch.from_numpy, qkv), torch.from_numpy(i_pre), torch.from_numpy(f_pre),
        initial_state=tuple(map(torch.from_numpy, st)) if with_state else None,
    )
    jh, (jc, jn) = jx.mlstm_chunked(*jargs, chunk=8, initial_state=jinit)
    for got, want in ((th, jh), (tc, jc), (tn, jn)):
        close(got, want, F32_STATE)

    step = jax.jit(jx.mlstm_step)
    state = jinit or (jnp.zeros((B, H, DK, DK)), jnp.zeros((B, H, DK)))
    hs = []
    for t in range(length):
        h, state = step(*(a[:, t] for a in jargs), state)
        hs.append(h)
    close(th, jnp.stack(hs, axis=1), F32_STATE)
    close(tc, state[0], F32_STATE)
    close(tn, state[1], F32_STATE)


def test_mlstm_decay_overflow_stays_masked():
    """A forget gate near 0 makes exp(cum_t - cum_j) above a chunk's
    diagonal overflow f32 (exponents ~1e4); masked before the exp, as the
    reference's ``where`` does, it leaves no inf or NaN."""
    qkv, i_pre, _, _ = cell_inputs(128, seed=3)
    f_pre = np.full((B, 128, H), -120.0, np.float32)
    jh, (jc, _) = jx.mlstm_chunked(
        *map(jnp.asarray, qkv), jnp.asarray(i_pre), jnp.asarray(f_pre))
    th, (tc, _) = tx.mlstm_chunked(
        *map(torch.from_numpy, qkv), torch.from_numpy(i_pre), torch.from_numpy(f_pre))
    assert torch.isfinite(th).all() and torch.isfinite(tc).all()
    close(th, jh, F32_STATE)
    close(tc, jc, F32_STATE)


@pytest.mark.parametrize("with_state", [False, True], ids=["own_init", "state"])
def test_slstm_scan_matches_reference(with_state):
    rng = np.random.default_rng(11)
    length, d = 32, 16
    pres = [rng.normal(size=(B, length, H, d)).astype(np.float32) for _ in range(4)]
    recs = [rng.normal(0.0, 0.25, (H, d, d)).astype(np.float32) for _ in range(4)]
    st = (rng.normal(size=(B, H, d)), rng.uniform(0.5, 2.0, (B, H, d)),
          rng.normal(size=(B, H, d)), rng.normal(size=(B, H, d)))
    st = tuple(a.astype(np.float32) for a in st)
    jh, jst = jx.slstm_scan(*map(jnp.asarray, pres + recs),
                            initial_state=tuple(map(jnp.asarray, st)) if with_state else None)
    th, tst = tx.slstm_scan(*map(torch.from_numpy, pres + recs),
                            initial_state=tuple(map(torch.from_numpy, st)) if with_state else None)
    close(th, jh, F32_STATE)
    for got, want in zip(tst, jst):
        close(got, want, F32_STATE)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return JaxModel(jax_config(ARCH).reduced()), Model(get_config(ARCH).reduced())


def carried(dtype):
    jp = reference_params(ARCH, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def flat(tree):
    """A state tree's leaves: mLSTM C, n; sLSTM c, n, h, m."""
    return [*tree["mlstm"], *tree["slstm"]]


def state_tol(ref, tol):
    return dict(atol=tol or bf16_tol(ref), rtol=tol or 0)


def test_tree_cache_and_sizes_match_reference(models):
    """The parameter tree, the slot cache's leaves and slot axes (against
    the reference's ``SlotKVCache``) and the full model's parameter count."""
    jm, tm = models
    tp = tm.init(0, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jm.abstract()):
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype))
    jcache = JaxSlotKVCache(jm, 64, 3)
    tcache = SlotKVCache(tm, 64, 3, device="cpu", act_dtype=torch.bfloat16)
    jleaves = [jcache.state["mlstm"][0], jcache.state["mlstm"][1], *jcache.state["slstm"]]
    jaxes = [jcache.batch_axes["mlstm"][0], jcache.batch_axes["mlstm"][1],
             *jcache.batch_axes["slstm"]]
    for a, b, ax_a, ax_b in zip(jleaves, flat(tcache.state), jaxes,
                                [*tcache.batch_axes["mlstm"], *tcache.batch_axes["slstm"]]):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32 and ax_a == ax_b
    assert sorted(tcache.state) == ["mlstm", "slstm"] and len(flat(tcache.state)) == 6
    assert Model(get_config(ARCH)).param_count() == JaxModel(jax_config(ARCH)).param_count()


@pytest.mark.parametrize("dtype,tol_state,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_forward_matches_reference(models, dtype, tol_state, tol_logits):
    jm, tm = models
    jp, tp = carried(dtype)
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, (2, 64))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 64, jm.cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))


@pytest.mark.parametrize("dtype,tol_state,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_prefill_matches_reference(models, dtype, tol_state, tol_logits):
    """An unpadded prompt: last-position logits and every state leaf."""
    jm, tm = models
    jp, tp = carried(dtype)
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab, (1, 48))
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    for a, b in zip(flat(js), flat(ts)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(as_np(b), as_np(a), **state_tol(a, tol_state))


@pytest.mark.parametrize("dtype,tol_state,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_decode_step_matches_reference(models, dtype, tol_state, tol_logits):
    """One decode step from the same random state: the logits and every
    state leaf, the port's written in place into the tensors it was given."""
    jm, tm = models
    jp, tp = carried(dtype)
    rng = np.random.default_rng(3)
    shapes = [t.shape for t in flat(tm.init_cache(ShapeCell("c", "decode", 8, 2), device="cpu"))]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    arrays[3] = np.abs(arrays[3]) + 0.5  # the sLSTM normalizer n is positive
    jstate = {"mlstm": tuple(map(jnp.asarray, arrays[:2])),
              "slstm": tuple(map(jnp.asarray, arrays[2:]))}
    given = [torch.from_numpy(a.copy()) for a in arrays]
    tstate = {"mlstm": tuple(given[:2]), "slstm": tuple(given[2:])}
    tok = rng.integers(0, jm.cfg.vocab, (2, 1)).astype(np.int32)
    jl, jns = jm.decode_step(jp, jstate, {"tokens": jnp.asarray(tok), "index": jnp.int32(5)})
    tl, tns = tm.decode_step(tp, tstate, {"tokens": torch.from_numpy(tok), "index": 5})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    for a, b, g in zip(flat(jns), flat(tns), given):
        assert b is g  # written in place
        np.testing.assert_allclose(as_np(b), as_np(a), **state_tol(a, tol_state))


def test_decode_continues_prefill(models):
    """A prompt's prefill, copied into slot 1 of a slot cache, then decode
    steps from it: each step's logits and the final state equal a prefill
    of the longer prompt (f32). Slot 0 stays at its zeros' decode and
    does not disturb slot 1."""
    _, tm = models
    _, tp = carried(jnp.float32)
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab, (1, 40))
    cache = SlotKVCache(tm, 64, 2, device="cpu", act_dtype=torch.float32)
    _, state = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :33])})
    cache.insert_prefill(1, state)
    for t in range(33, 40):
        tokens = torch.from_numpy(np.repeat(toks[:, t : t + 1], 2, axis=0))
        logits, _ = tm.decode_step(tp, cache.state, {"tokens": tokens, "index": torch.tensor([3, t])})
        want, want_state = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, : t + 1])})
        np.testing.assert_allclose(as_np(logits[1]), as_np(want[0]), atol=F32_LOGITS)
    for got, ax, want in zip(flat(cache.state), [2, 2, 1, 1, 1, 1], flat(want_state)):
        np.testing.assert_allclose(as_np(got.select(ax, 1)), as_np(want.select(ax, 0)),
                                   atol=F32_STATE, rtol=F32_STATE)


def test_ragged_prompt_served_matches_forward(models):
    """A 200-token prompt (the reference's prefill raises: 128 does not
    divide 200) through the port's engine, unpadded: its first token and
    every decode step's logits equal a forward over the same tokens."""
    from repro_torch.serving import ServeRequest, ServingEngine

    _, tm = models
    _, tp = carried(jnp.float32)
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, tm.cfg.vocab, 200)]
    eng = ServingEngine(tm, tp, c_max=256, n_slots=2)
    eng.submit(ServeRequest(0, prompt, max_new_tokens=5))
    comps, logits = [], []
    while not comps:
        comps = eng.step()
        if eng.slots:
            logits.append(eng.last_logits[0].clone())
    out = comps[0].output_tokens
    full, _ = tm.forward(tp, {"tokens": torch.tensor([prompt + out[:-1]])})
    assert out[0] == int(full[0, 199].argmax())
    for j, got in enumerate(logits):  # decode step j read token out[j]
        np.testing.assert_allclose(as_np(got), as_np(full[0, 200 + j]), atol=F32_LOGITS)


def test_two_pool_server_matches_reference():
    """The same requests through both packages' TwoPoolServer with f32
    parameters: identical output tokens, pool choices and learned
    calibration. Prompts stay ≤ 128 tokens (the reference's mLSTM raises
    for longer prompts that 128 does not divide)."""
    jcfg = jax_config(ARCH).reduced()
    jp = reference_params(ARCH, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    # c_max: the reference sizes its slot cache by a prefill of c_max tokens
    kw = dict(short_cmax=64, long_cmax=256, short_slots=3, long_slots=2)
    jsrv = JaxTwoPoolServer(JaxModel(jcfg), jp, **kw)
    tsrv = TwoPoolServer(Model(get_config(ARCH).reduced()), tp, **kw)

    rng = np.random.default_rng(7)
    jpools, tpools = {}, {}
    for i in range(9):
        cat = int(rng.integers(0, 4))
        # two prompt lengths: the reference compiles its (unpadded)
        # prefill and slot insertion once per length
        n = int(rng.choice([9, 38]))
        toks = [int(t) for t in rng.integers(0, jcfg.vocab, n)]
        mx = 80 if i % 4 == 0 else int(rng.integers(2, 6))
        nbytes = max(1, int(n * (2.0 + cat) + rng.normal(0, 3)))
        jpools[i] = jsrv.submit(i, toks, nbytes, mx, category=cat)
        tpools[i] = tsrv.submit(i, toks, nbytes, mx, category=cat)
        if i % 3 == 2:
            jsrv.step()
            tsrv.step()
    jsrv.run_to_completion()
    tsrv.run_to_completion()

    assert tpools == jpools
    jout = {r.request_id: (r.pool, r.output_tokens, r.spilled) for r in jsrv.responses}
    tout = {r.request_id: (r.pool, r.output_tokens, r.spilled) for r in tsrv.responses}
    assert tout == jout
    assert tsrv.stats()["router"]["calibration"] == jsrv.stats()["router"]["calibration"]
    assert {"long", "short"} == set(tpools.values())


def test_int8_kv_raises():
    with pytest.raises(NotImplementedError, match="int8"):
        Model(get_config(ARCH).reduced(), kv_dtype="int8")


def test_reference_cache_shapes(models):
    """The port's zero state has the reference's ``init_cache`` shapes."""
    jm, tm = models
    cell = ShapeCell("c", "decode", 32, 3)
    jc = jm.init_cache(JaxShapeCell("c", "decode", 32, 3))
    tc = tm.init_cache(cell, device="cpu")
    for a, b in zip(flat(jc), flat(tc)):
        assert tuple(b.shape) == a.shape and not b.any()
