"""The port's hybrid family (zamba2) against the reference, on the CPU, at
reduced widths (4 Mamba-2 blocks in 2 groups, 2 shared attention blocks).

The reference's parameters are carried into the port with
``params_from_numpy``. Two changes to the reference's own tree, made before
either package sees it: the LoRA ``b_*`` factors are drawn nonzero (the
reference initializes them to zeros, which would leave the LoRA path
untested), and the shared blocks' ``w_q``/``w_k`` are scaled by 0.1, for
the reason ``tests/test_torch_models.py`` gives (the reference's fan-in
rule makes attention a near arg-max, which would turn 1e-7 differences
into different keys).

Tolerances: f32 1e-4 on states and 1e-3 on logits (summation order through
6 blocks), as in ``tests/test_torch_models.py``. bf16: BF16_ULPS = 8 ulps of
bf16 at each tensor's scale, twice the dense tests' 4, because a Mamba-2
block rounds to bf16 at about three times as many points as a dense layer
(conv, three SiLUs, the gate, the gated norm, the skip) and the reference's
bf16 SiLU is itself up to ~2 ulps off the f32 value (its sigmoid runs in
bf16; the port's in f32): measured on normal inputs, max |error| 0.0187
against PyTorch's 0.0105.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import params as jparams_lib  # noqa: E402
from repro.serving import TwoPoolServer as JaxTwoPoolServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import SlotKVCache, TwoPoolServer  # noqa: E402

ARCH = "zamba2-2.7b"
F32_STATE, F32_LOGITS = 1e-4, 1e-3
BF16_ULPS = 8
DTYPES = [(jnp.float32, F32_STATE, F32_LOGITS), (jnp.bfloat16, None, None)]
DTYPE_IDS = ["f32", "bf16"]


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def bf16_tol(ref) -> float:
    top = float(np.abs(as_np(ref)).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def numpy_init(defs, rng, dtype, edit=lambda path, v: v):
    """The reference's parameter tree with its init rule (zeros, ones,
    normal(scale), normal over the fan-in ``shape[-2]``) drawn by numpy
    (its own init compiles one program per leaf); ``edit`` adjusts a leaf
    in f32, and bf16 leaves are cast to ``dtype``."""

    def leaf(path, d):
        if d.init in ("zeros", "ones"):
            v = np.full(d.shape, float(d.init == "ones"), np.float32)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale if d.init == "normal" else 1.0 / np.sqrt(max(1, fan_in))
            v = rng.normal(0.0, std, d.shape).astype(np.float32)
        v = edit(tuple(k.key for k in path), v)
        return jnp.asarray(v.astype(dtype if d.dtype == jnp.bfloat16 else d.dtype))

    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=jparams_lib.is_def)


@functools.lru_cache(maxsize=None)
def reference_params(dtype):
    """LoRA ``b_*`` drawn nonzero and the shared blocks' ``w_q``/``w_k``
    scaled by 0.1 (see the module docstring)."""
    rng = np.random.default_rng(0)

    def edit(path, v):
        if path[0] == "lora" and path[-1].startswith("b_"):
            return rng.normal(0.0, 0.05, v.shape).astype(np.float32)
        if path[0] == "shared" and path[-1] in ("w_q", "w_k"):
            return v * np.float32(0.1)
        return v

    return numpy_init(JaxModel(jax_config(ARCH).reduced()).defs, rng, dtype, edit)


@pytest.fixture(scope="module")
def models():
    return JaxModel(jax_config(ARCH).reduced()), Model(get_config(ARCH).reduced())


@pytest.fixture(scope="module", params=DTYPES, ids=DTYPE_IDS)
def carried(request):
    dtype, tol_state, tol_logits = request.param
    jp = reference_params(dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp, tol_state, tol_logits


def flat(tree):
    """Leaves of a state tree in a fixed order: attn k, v, conv, ssd."""
    return [tree["attn"][0], tree["attn"][1], tree["mamba"]["conv"], tree["mamba"]["ssd"]]


def test_tree_and_sizes_match_reference(models):
    jm, tm = models
    jleaves = jax.tree_util.tree_leaves_with_path(jm.abstract())
    tp = tm.init(0, device="cpu")
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    assert tm.param_count() == jm.param_count()
    full = Model(get_config(ARCH))
    assert full.param_count() == JaxModel(jax_config(ARCH)).param_count()


def test_forward_matches_reference(models, carried):
    jm, tm = models
    jp, tp, _, tol_logits = carried
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, (2, 64))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 64, jm.cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))


def test_prefill_matches_reference(models, carried):
    """An unpadded prompt: last-position logits and every state leaf."""
    jm, tm = models
    jp, tp, tol_state, tol_logits = carried
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab, (1, 48))
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    for a, b in zip(flat(js), flat(ts)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(as_np(b), as_np(a), atol=tol_state or bf16_tol(a))


def test_decode_step_matches_reference(models, carried):
    """One decode step from the same random state in both packages: the
    logits and every updated state leaf (the reference's state is returned
    anew, the port's updated in place)."""
    jm, tm = models
    jp, tp, tol_state, tol_logits = carried
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    groups, sub = cfg.n_layers // cfg.attn_every, cfg.attn_every
    kv = (groups, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    conv = (groups, sub, 1, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    ssd = (groups, sub, 1, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    act = jp["embed"].dtype
    arrays = [rng.normal(size=s).astype(np.float32) for s in (kv, kv, conv, ssd)]
    jstate = {
        "attn": (jnp.asarray(arrays[0], jnp.bfloat16), jnp.asarray(arrays[1], jnp.bfloat16)),
        "mamba": {"conv": jnp.asarray(arrays[2], act), "ssd": jnp.asarray(arrays[3])},
    }
    tk, tv, tconv, tssd = (params_from_numpy(np.asarray(t), device="cpu") for t in flat(jstate))
    tstate = {"attn": (tk, tv), "mamba": {"conv": tconv, "ssd": tssd}}
    tok = np.array([[int(rng.integers(0, cfg.vocab))]], np.int32)
    jl, jns = jm.decode_step(jp, jstate, {"tokens": jnp.asarray(tok), "index": jnp.int32(41)})
    tl, tns = tm.decode_step(tp, tstate, {"tokens": torch.from_numpy(tok), "index": 41})
    assert tns["attn"][0] is tstate["attn"][0]
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    for a, b in zip(flat(jns), flat(tns)):
        a, b = as_np(a), as_np(b)
        # bf16 caches: f32 values within the tolerance may round to
        # neighbouring bf16 values, so one bf16 ulp on top
        np.testing.assert_allclose(b, a, atol=tol_state or bf16_tol(a), rtol=2**-7)


def test_decode_continues_prefill(models):
    """Prefill of a prompt, copied into a slot cache, then decode steps from
    it, give the logits of a full forward over the longer sequence (f32)."""
    _, tm = models
    tp = params_from_numpy(jax.tree.map(np.asarray, reference_params(jnp.float32)), device="cpu")
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab, (1, 40))
    full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    logits, state = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :33])})
    np.testing.assert_allclose(as_np(logits[0]), as_np(full[0, 32]), atol=F32_LOGITS)
    cache = SlotKVCache(tm, 64, 2, device="cpu", act_dtype=torch.float32)
    # an f32 attention cache, so the comparison sees no bf16 rounding
    cache.state["attn"] = tuple(t.float() for t in cache.state["attn"])
    cache.insert_prefill(1, state)
    for t in range(33, 40):
        tokens = torch.from_numpy(np.repeat(toks[:, t : t + 1], 2, axis=0))
        logits, _ = tm.decode_step(tp, cache.state, {"tokens": tokens, "index": torch.tensor([3, t])})
        np.testing.assert_allclose(as_np(logits[1]), as_np(full[0, t]), atol=F32_LOGITS)


def test_two_pool_server_matches_reference():
    """The same requests through both packages' TwoPoolServer with f32
    parameters: identical output tokens, pool choices and learned
    calibration. Prompts stay ≤ 128 tokens (the reference's chunked scan
    raises for longer prompts that 128 does not divide)."""
    jcfg = jax_config(ARCH).reduced()
    jp = reference_params(jnp.float32)
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
    jstats, tstats = jsrv.stats(), tsrv.stats()
    assert tstats["router"]["calibration"] == jstats["router"]["calibration"]
    assert {"long", "short"} == set(tpools.values())
