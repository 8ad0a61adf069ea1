"""The port's MoE family against the reference, on the CPU, at reduced widths.

The MoE layer (``repro_torch.models.moe``) is held against the reference's
``moe_layer`` and against a numpy oracle that places a group's top-k
choices token-major (each token's choices after every choice of the tokens
before it): top-1 at any group, drops included; any top-k at one token a group; top-2 at a group of 64 against
the reference called one token at a time where capacity does not bind; the
oracle where it binds; a ragged last group. The reference's own layer gives
two tokens of a group the same (expert, position) row when ``top_k > 1``
(ROADMAP.md, C, R2): ``test_reference_collision`` shows it.

The models (qwen3-235b-a22b, llama4-scout, llama4-maverick, reduced; and
two head layouts that the attention kernels serve at full width, a GQA
group of 16 and one of 5) go through ``forward``, ``prefill`` and
``decode_step`` in both packages with the reference's parameters carried
across (``w_q``/``w_k`` tempered as ``tests/test_torch_models.py``
explains). qwen3 is compared at ``moe_group=1`` on both sides, where the
reference is sound; at its default group, a prompt's logits do not depend
on how far the serving bucket pads it.

Tolerances are ``tests/test_torch_models.py``'s: f32 1e-4 on caches and
1e-3 on logits; bf16 4 ulps at the tensor's scale. In bf16 the forward is
held layer by layer, each layer fed the same input in both packages: a
top-k choice is a discontinuous function of the router's input, and the
two packages' bf16 hidden states differ by an ulp in about half their
values after one layer, which flips a near-tied choice (measured on
maverick, reduced: one of 256 token-layers, moving that token's logits by
0.17, 11 ulps). Fed the same input, both routers see the same values.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import TwoPoolServer as JaxTwoPoolServer  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.models import Model, get_model, params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402
from repro_torch.serving import TwoPoolServer  # noqa: E402
from test_torch_models import (  # noqa: E402
    F32_ATTN,
    F32_LOGITS,
    as_np,
    bf16_tol,
    reference_params,
)

QWEN3, SCOUT, MAVERICK = "qwen3-235b-a22b", "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
MOE_ARCHS = (QWEN3, SCOUT, MAVERICK)
# f32 MoE layer against the reference and the oracle: the same products
# summed in other orders (the oracle in f64)
LAYER_TOL = 1e-5

# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

D, FF, N_EXP = 32, 48, 8


def layer_params(seed: int, *, n_experts: int = N_EXP, shared: bool = False) -> dict:
    """One MoE layer's parameters in the reference's layout (f32), drawn
    with its fan-in rule."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": draw(D, n_experts), "w_up": draw(n_experts, D, FF),
         "w_gate": draw(n_experts, D, FF), "w_down": draw(n_experts, FF, D)}
    if shared:
        p["shared"] = {"w_up": draw(D, FF), "w_gate": draw(D, FF), "w_down": draw(FF, D)}
    return p


def tokens(seed: int, b: int, l: int, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, l, D)).astype(dtype)


def ref_layer(x, params, **kw):
    out, aux = jmoe.moe_layer(jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                              n_experts=params["router"].shape[1], activation="swiglu", **kw)
    return as_np(out), float(aux)


def port_layer(x, params, **kw):
    tp = params_from_numpy(params, device="cpu")
    xt = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    out, aux = tmoe.moe_layer(xt, tp, n_experts=params["router"].shape[1],
                              activation="swiglu", **kw)
    return as_np(out), float(aux)


def capacity_oracle(x, params, *, top_k, group_size, capacity_factor):
    """In f64, token by token: each group's top-k choices are placed
    token-major (token t's first choice, its second, ..., then token
    t+1's) into their expert's buffer; a choice past the capacity is
    dropped. Returns (out, choices dropped)."""
    b, l, d = x.shape
    toks = x.reshape(-1, d).astype(np.float64)
    p = {k: v for k, v in params.items() if k != "shared"}
    p = {k: v.astype(np.float64) for k, v in p.items()}
    n_exp = p["router"].shape[1]

    def silu(z):
        return z / (1.0 + np.exp(-z))

    def ffn(t, e):
        return (silu(t @ p["w_gate"][e]) * (t @ p["w_up"][e])) @ p["w_down"][e]

    out, dropped = np.zeros_like(toks), 0
    for start in range(0, len(toks), group_size):
        grp = toks[start:start + group_size]
        g = len(grp)
        cap = max(top_k, min(g, int(g * top_k * capacity_factor / n_exp)))
        logits = grp @ p["router"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        choice = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
        gates = np.take_along_axis(probs, choice, -1)
        gates /= np.maximum(gates.sum(-1, keepdims=True), 1e-9)
        filled = np.zeros(n_exp, int)
        for t in range(g):
            for j in range(top_k):
                e = choice[t, j]
                if filled[e] < cap:
                    out[start + t] += gates[t, j] * ffn(grp[t], e)
                    filled[e] += 1
                else:
                    dropped += 1
        if "shared" in params:
            sh = {k: v.astype(np.float64) for k, v in params["shared"].items()}
            out[start:start + g] += (silu(grp @ sh["w_gate"]) * (grp @ sh["w_up"])) @ sh["w_down"]
    return out.reshape(b, l, d), dropped


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("group", [512, 16])
def test_top1_matches_reference_with_drops(group, shared):
    """Top-1 at the default group (all 96 tokens in one) and at 16: the port
    equals the reference, drops in token order included."""
    params = layer_params(0, shared=shared)
    x = tokens(1, 2, 48)
    kw = dict(top_k=1, group_size=group, capacity_factor=tmoe.TRAIN_CAPACITY_FACTOR)
    ref, ref_aux = ref_layer(x, params, **kw)
    out, aux = port_layer(x, params, **kw)
    oracle, dropped = capacity_oracle(x, params, top_k=1, group_size=group,
                                    capacity_factor=tmoe.TRAIN_CAPACITY_FACTOR)
    assert dropped > 0
    np.testing.assert_allclose(out, ref, atol=LAYER_TOL)
    np.testing.assert_allclose(out, oracle, atol=LAYER_TOL)
    assert aux == pytest.approx(ref_aux, rel=1e-6)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_one_token_a_group_matches_reference(top_k):
    params = layer_params(2, shared=True)
    x = tokens(3, 1, 12)
    kw = dict(top_k=top_k, group_size=1, capacity_factor=tmoe.DECODE_CAPACITY_FACTOR)
    ref, ref_aux = ref_layer(x, params, **kw)
    out, aux = port_layer(x, params, **kw)
    np.testing.assert_allclose(out, ref, atol=LAYER_TOL)
    assert aux == pytest.approx(ref_aux, rel=1e-6)


def test_top2_group_matches_reference_token_by_token():
    """Top-2 at a group of 64 with a capacity of 64 (nothing can drop): the
    port equals the reference called one token a group."""
    params = layer_params(4)
    x = tokens(5, 1, 64)
    cf = N_EXP / 2  # int(64 * 2 * cf / E) = 64
    out, _ = port_layer(x, params, top_k=2, group_size=64, capacity_factor=cf)
    ref, _ = ref_layer(x, params, top_k=2, group_size=1, capacity_factor=cf)
    np.testing.assert_allclose(out, ref, atol=LAYER_TOL)


@pytest.mark.parametrize("top_k", [2, 4])
def test_matches_gshard_oracle_where_capacity_binds(top_k):
    """64 tokens' 2 or 4 choices over 8 experts at factor 1 (capacity 16
    or 32): drops in the oracle's token-major order."""
    params = layer_params(6, shared=True)
    x = tokens(7, 2, 32)
    kw = dict(top_k=top_k, group_size=64, capacity_factor=1.0)
    out, _ = port_layer(x, params, **kw)
    oracle, dropped = capacity_oracle(x, params, **kw)
    assert dropped > 0
    np.testing.assert_allclose(out, oracle, atol=LAYER_TOL)


def test_ragged_last_group():
    """100 tokens in groups of 32: three full groups and one of 4, which
    takes its capacity from its own length (the reference raises; it is
    run on the full groups and the last one apart)."""
    params = layer_params(8, shared=True)
    x = tokens(9, 2, 50)
    cf = tmoe.PREFILL_CAPACITY_FACTOR
    out, aux = port_layer(x, params, top_k=1, group_size=32, capacity_factor=cf)
    flat = x.reshape(1, 100, D)
    head, head_aux = ref_layer(flat[:, :96], params, top_k=1, group_size=32, capacity_factor=cf)
    tail, tail_aux = ref_layer(flat[:, 96:], params, top_k=1, group_size=4, capacity_factor=cf)
    ref = np.concatenate([head, tail], axis=1).reshape(2, 50, D)
    np.testing.assert_allclose(out, ref, atol=LAYER_TOL)
    assert aux == pytest.approx((3 * head_aux + tail_aux) / 4, rel=1e-6)
    with pytest.raises(ValueError):
        ref_layer(x, params, top_k=1, group_size=32, capacity_factor=cf)


def test_reference_collision():
    """R2: 12 tokens, top-4 of 8 experts, a capacity of 12, so nothing can
    drop. The reference counts each pass's positions from zero, so tokens of
    different passes share (expert, position) rows and each is fed their
    summed inputs: it is far from the per-token oracle, while the same
    layer called one token at a time, and the port, agree with it."""
    params = layer_params(10)
    x = tokens(11, 1, 12)
    kw = dict(top_k=4, group_size=12, capacity_factor=4.0)
    oracle, dropped = capacity_oracle(x, params, **kw)
    assert dropped == 0
    ref, _ = ref_layer(x, params, **kw)
    assert np.abs(ref - oracle).max() > 0.5
    one_by_one, _ = ref_layer(x, params, **{**kw, "group_size": 1})
    np.testing.assert_allclose(one_by_one, oracle, atol=LAYER_TOL)
    out, _ = port_layer(x, params, **kw)
    np.testing.assert_allclose(out, oracle, atol=LAYER_TOL)


@pytest.mark.parametrize("top_k,group", [(1, 512), (2, 1)])
def test_bf16_layer_matches_reference(top_k, group):
    """The same bf16 input and weights: the router in f32, the dispatch,
    expert products and the combine rounded to bf16 where the reference
    rounds them."""
    params = {k: v if k == "router" else jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
              for k, v in layer_params(12, shared=True).items()}
    x = jnp.asarray(tokens(13, 2, 32)).astype(jnp.bfloat16)
    kw = dict(top_k=top_k, group_size=group, capacity_factor=tmoe.PREFILL_CAPACITY_FACTOR)
    ref, ref_aux = jmoe.moe_layer(x, params, n_experts=N_EXP, activation="swiglu", **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    out, aux = tmoe.moe_layer(params_from_numpy(np.asarray(x), device="cpu"), tp,
                              n_experts=N_EXP, activation="swiglu", **kw)
    assert out.dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=bf16_tol(ref))
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)


def test_expert_products_take_every_group_at_once():
    """Decode's one-token groups reach the experts as one product per
    weight over every group's whole buffer (empty rows included): no loop
    over groups or experts, and no shape that depends on how many tokens
    an expert got, which would need a host read."""
    params = layer_params(14)
    tp = params_from_numpy(params, device="cpu")
    calls = []
    orig = tmoe.mlp

    def spy(x, p, activation):
        calls.append(tuple(x.shape))
        return orig(x, p, activation)

    tmoe.mlp = spy
    try:
        tmoe.moe_layer(torch.from_numpy(tokens(15, 8, 1)), tp, n_experts=N_EXP, top_k=2,
                       activation="swiglu", group_size=1,
                       capacity_factor=tmoe.DECODE_CAPACITY_FACTOR)
    finally:
        tmoe.mlp = orig
    assert calls == [(N_EXP, 8 * 2, D)]  # 8 one-token groups, capacity top_k = 2


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

# (arch, moe_group, config overrides): the reduced configs, and two of the
# GQA groups the full-width heads give the attention kernels (qwen3's 16,
# llama4's 5)
CASES = [
    (QWEN3, 1, {}),
    (SCOUT, 512, {}),
    (MAVERICK, 512, {}),
    (QWEN3, 1, {"n_heads": 16, "n_kv_heads": 1}),
    (SCOUT, 512, {"n_heads": 10, "n_kv_heads": 2}),
]
CASE_IDS = ["qwen3", "scout", "maverick", "qwen3-g16", "scout-g5"]
DTYPES = [(jnp.float32, F32_ATTN, F32_LOGITS), (jnp.bfloat16, None, None)]
DTYPE_IDS = ["f32", "bf16"]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    arch, group, over = request.param
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return dict(arch=arch, over=over, group=group, jm=JaxModel(jcfg, moe_group=group),
                tm=Model(tcfg, moe_group=group))


def carried(case, dtype):
    jp = reference_params(case["arch"], dtype, **case["over"])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def layer_ordered(tree) -> list:
    """The reference's cache tree ({"moe_block": c} or {"dense_block": c,
    "moe_block": c}, each c a tuple of (steps, ...) arrays) as the port's
    layer-ordered tuple (dense block of step i at 2i, its MoE block at 2i+1)."""
    if "dense_block" not in tree:
        return [np.asarray(a) for a in tree["moe_block"]]
    return [np.stack([np.asarray(d), np.asarray(m)], 1).reshape(-1, *np.shape(d)[1:])
            for d, m in zip(tree["dense_block"], tree["moe_block"])]


def reference_tree(flat, moe_every: int):
    """The inverse of :func:`layer_ordered`."""
    if moe_every == 1:
        return {"moe_block": tuple(flat)}
    return {"dense_block": tuple(a[0::2] for a in flat),
            "moe_block": tuple(a[1::2] for a in flat)}


def reference_layers(jp) -> list:
    """The reference's per-layer parameters in layer order, each with
    whether it is an MoE layer."""
    blocks = jp["blocks"]
    steps = jax.tree.leaves(blocks["moe_block"])[0].shape[0]

    def at(tree, i):
        return jax.tree.map(lambda a: a[i], tree)

    out = []
    for i in range(steps):
        if "dense_block" in blocks:
            out.append((at(blocks["dense_block"], i), False))
        out.append((at(blocks["moe_block"], i), True))
    return out


def test_forward_matches_reference_f32(case):
    jm, tm = case["jm"], case["tm"]
    jp, tp = carried(case, jnp.float32)
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 64))
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 64, jm.cfg.padded_vocab)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=F32_LOGITS)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_forward_matches_reference_bf16_layer_by_layer(case):
    """Each layer fed the port's own input in both packages (see the module
    docstring), then the final norm and head."""
    jm, tm = case["jm"], case["tm"]
    jcfg, tcfg = jm.cfg, tm.cfg
    jp, tp = carried(case, jnp.bfloat16)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 64))
    x = ttransformer._embed_input(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    pos = torch.arange(64).expand(2, 64)
    cos, sin = rope_angles(pos, tcfg.head_dim, tcfg.rope_theta)
    jcos, jsin = jtransformer._positions_full({"tokens": jnp.asarray(toks)}, jcfg, 64)
    layers = ttransformer._layers(tp)
    assert [m for _, m in layers] == [m for _, m in reference_layers(jp)]
    for (p, is_moe), (jlayer, _) in zip(layers, reference_layers(jp)):
        jy, _, _ = jtransformer._block_apply(
            jnp.asarray(as_np(x)).astype(jnp.bfloat16), jlayer, jcfg, jcos, jsin, mode="full",
            is_moe_block=is_moe, moe_group=case["group"],
        )
        y, _ = ttransformer._self_attention_full(x, p, cos, sin, tcfg)
        x, _ = ttransformer._ffn_sublayer(y, p, tcfg, is_moe, case["group"],
                                          tmoe.TRAIN_CAPACITY_FACTOR)
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(x), as_np(jy), atol=bf16_tol(jy))
    jh = jtransformer._head(jp, jcfg, jtransformer.rms_norm(
        jnp.asarray(as_np(x)).astype(jnp.bfloat16), jp["final_norm"], jcfg.norm_eps))
    th = ttransformer._head(tp, tcfg, ttransformer.rms_norm(x, tp["final_norm"], tcfg.norm_eps))
    np.testing.assert_allclose(as_np(th), as_np(jh), atol=bf16_tol(jh))


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_prefill_matches_reference(case, dtype, tol_attn, tol_logits):
    """Right-padded prompt (the engine's 64-token bucket) with last_pos: the
    logits, and the caches in layer order."""
    jm, tm = case["jm"], case["tm"]
    jp, tp = carried(case, dtype)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :41] = np.random.default_rng(1).integers(1, jm.cfg.vocab, 41)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray([40])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "last_pos": torch.tensor([40])})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    ref = layer_ordered(jc)
    assert len(tc) == len(ref) == 2
    for a, b in zip(ref, tc):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(as_np(b), as_np(a), atol=tol_attn or bf16_tol(a),
                                   rtol=tol_attn or 0)


def test_prefill_does_not_depend_on_bucket_padding():
    """qwen3 at its default group, with 16 experts so that prefill's
    capacity binds (top-2 at factor 2: a quarter of the group): a 32-token
    prompt right-padded to 64 and to 128 tokens, where the pads (token 0)
    crowd the experts they pick, and the same prompt one token a group
    (nothing drops), give the same logits. Token-major positions put every
    prompt choice before any pad's. The port's own init, in f32: the
    reference's reduced init routes the prompt itself past capacity."""
    cfg = dataclasses.replace(get_config(QWEN3).reduced(), n_experts=16)
    tp = jax.tree.map(lambda t: t.float(), Model(cfg).init(0, device="cpu"))
    prompt = np.random.default_rng(5).integers(1, cfg.vocab, 32)

    def last_logits(model, bucket):
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :32] = prompt
        logits, _ = model.prefill(tp, {"tokens": torch.from_numpy(toks),
                                       "last_pos": torch.tensor([31])})
        return as_np(logits)

    per_token = last_logits(Model(cfg, moe_group=1), 64)
    for bucket in (64, 128):
        np.testing.assert_allclose(last_logits(Model(cfg), bucket), per_token,
                                   atol=F32_LOGITS)


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_decode_step_matches_reference(case, dtype, tol_attn, tol_logits):
    """One decode step over the same bf16 cache: the logits, and the K/V
    written at ``index`` in every layer."""
    jm, tm = case["jm"], case["tm"]
    jp, tp = carried(case, dtype)
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    flat = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    jcache = reference_tree([jnp.asarray(a).astype(jnp.bfloat16) for a in flat], cfg.moe_every)
    tcache = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in flat)
    tok = np.array([[int(rng.integers(0, cfg.vocab))]], np.int32)
    jl, jnc = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(tok), "index": jnp.int32(41)})
    tl, tnc = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(tok), "index": 41})
    assert tnc[0] is tcache[0]
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    keep = np.arange(64) != 41
    for a, b in zip(layer_ordered(jnc), tnc):
        a, b = as_np(a), as_np(b)
        np.testing.assert_allclose(b[:, :, 41], a[:, :, 41],
                                   atol=tol_attn or bf16_tol(a[:, :, 41]), rtol=2**-7)
        np.testing.assert_array_equal(b[:, :, keep], a[:, :, keep])


def slot_decode_reference(jm, jp, tree, toks, index):
    """The reference engine's decode: a one-token decode vmapped over the
    slot axis (axis 1 of every cache leaf)."""

    def single(state, tok, idx):
        st = jax.tree.map(lambda a: a[:, None], state)
        logits, new = jm.decode_step(jp, st, {"tokens": tok[None, None], "index": idx})
        return logits[0], jax.tree.map(lambda a: a[:, 0], new)

    return jax.jit(jax.vmap(single, in_axes=(1, 0, 0), out_axes=(0, 1)))(
        tree, jnp.asarray(toks), jnp.asarray(index))


def test_decode_groups_are_per_slot():
    """Top-1 over 16 experts, 8 slots, three of them identical (same cache,
    token and position), so they pick one expert in every layer. As one
    group of 8 at the decode factor the capacity is 2 and the third would
    drop (the reference's unvmapped decode shows it); the port routes each
    slot alone and equals the reference's vmapped decode."""
    over = {"n_experts": 16}
    jcfg = dataclasses.replace(jax_config(SCOUT).reduced(), **over)
    tcfg = dataclasses.replace(get_config(SCOUT).reduced(), **over)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    jp = reference_params(SCOUT, jnp.float32, **over)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    shape = (tcfg.n_layers, 8, 64, tcfg.n_kv_heads, tcfg.head_dim)
    flat = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    toks = rng.integers(0, tcfg.vocab, 8).astype(np.int32)
    for a in flat:
        a[:, 1:3] = a[:, :1]
    toks[1:3] = toks[0]
    index = np.full(8, 41, np.int32)
    jcache = {"moe_block": tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in flat)}
    jl, _ = slot_decode_reference(jm, jp, jcache, toks, index)
    one_group, _ = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(toks)[:, None],
                                               "index": jnp.int32(41)})
    assert np.abs(as_np(one_group)[:3] - as_np(jl)[:3]).max() > 1e-2
    tcache = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in flat)
    tl, _ = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(toks)[:, None],
                                        "index": torch.from_numpy(index)})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=F32_LOGITS)
    assert torch.equal(tl[0], tl[1]) and torch.equal(tl[0], tl[2])


@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_int8_cache_on_moe(arch, monkeypatch):
    """``kv_dtype="int8"`` on the MoE family: prefill writes int8 K/V and
    f16 scales in layer order, and a decode step over them equals the
    reference's with its dequantization in f32 (the TPU kernel's
    arithmetic, which the port's kernel follows; see
    ``tests/test_torch_int8_kv.py``)."""
    monkeypatch.setattr(jtransformer, "dequantize_kv",
                        lambda q, s: q.astype(jnp.float32) * s.astype(jnp.float32))
    jm = JaxModel(jax_config(arch).reduced(), kv_dtype="int8")
    tm = Model(get_config(arch).reduced(), kv_dtype="int8")
    jp = reference_params(arch, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.zeros((1, 64), np.int32)
    toks[0, :41] = np.random.default_rng(4).integers(1, jm.cfg.vocab, 41)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray([40])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "last_pos": torch.tensor([40])})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=F32_LOGITS)
    assert [t.dtype for t in tc] == [torch.int8, torch.int8, torch.float16, torch.float16]
    ref = layer_ordered(jc)
    for a, b in zip(ref[:2], tc[:2]):  # one quantization step apart at most
        assert np.abs(b.numpy().astype(np.int32) - a.astype(np.int32)).max() <= 1
    jcache = reference_tree([jnp.asarray(a) for a in ref], tm.cfg.moe_every)
    tcache = tuple(params_from_numpy(a, device="cpu") for a in ref)
    tok = np.array([[7]], np.int32)
    jl, _ = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(tok), "index": jnp.int32(41)})
    tl, _ = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(tok), "index": 41})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=1e-5)


# ---------------------------------------------------------------------------
# Serving, parameters, the model facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,group", [(SCOUT, 512), (MAVERICK, 512), (QWEN3, 1)],
                         ids=["scout", "maverick", "qwen3-g1"])
def test_two_pool_server_matches_reference(arch, group):
    """The same requests through both packages' TwoPoolServer, f32
    parameters carried from the reference: identical output tokens, pool
    choices and learned calibration. Prompts are right-padded to the
    engines' bucket in both, so pad tokens share the prefill group."""
    jcfg = jax_config(arch).reduced()
    jp = reference_params(arch, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(short_cmax=64, long_cmax=192, short_slots=3, long_slots=2)
    jsrv = JaxTwoPoolServer(JaxModel(jcfg, moe_group=group), jp, **kw)
    tsrv = TwoPoolServer(Model(get_config(arch).reduced(), moe_group=group), tp, **kw)

    rng = np.random.default_rng(7)
    jpools, tpools = {}, {}
    for i in range(9):
        cat = int(rng.integers(0, 4))
        n = int(rng.integers(4, 40))
        toks = [int(t) for t in rng.integers(0, jcfg.vocab, n)]
        mx = 40 if i % 4 == 0 else int(rng.integers(2, 6))
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_mirror_reference_layout(arch):
    """Same tree, shapes and dtypes as the reference's defs at full widths
    (nothing allocated); a reduced reference tree carried across equals it
    leaf for leaf and has the port's own init's tree."""
    ref, port = JaxModel(jax_config(arch)), Model(get_config(arch))
    assert port.param_count() == ref.param_count()
    assert port.param_bytes() == ref.param_bytes()
    ref_abs = jax.tree.map(lambda s: (s.shape, str(s.dtype)), ref.abstract())
    port_abs = jax.tree.map(lambda d: (d.shape, str(d.dtype).replace("torch.", "")),
                            port.defs, is_leaf=lambda d: hasattr(d, "init"))
    assert port_abs == ref_abs
    jp = reference_params(arch, jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    own = Model(get_config(arch).reduced()).init(0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, own))
    for a, b, c in zip(jax.tree.leaves(jp), jax.tree.leaves(tp), jax.tree.leaves(own)):
        assert tuple(b.shape) == a.shape == tuple(c.shape) and b.dtype == c.dtype
        np.testing.assert_array_equal(as_np(b), as_np(a))


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_get_model_and_active_params_match_reference(name):
    """Every config: the port's get_model gives the reference's counts."""
    ref = jax_get_model(name)
    port = get_model(name)
    assert port is get_model(name) and port.cfg.name == name
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert (port.active_param_count() < port.param_count()) == port.cfg.is_moe


def test_moe_cache_is_layer_ordered():
    """maverick (a dense and an MoE block a step) keeps one flat KV pair of
    n_layers, as the paged kernel's page view wants."""
    cfg = get_config(MAVERICK).reduced()
    k, v = Model(cfg).init_cache(ShapeCell("c", "decode", 32, 3), device="cpu")
    assert k.shape == v.shape == (cfg.n_layers, 3, 32, cfg.n_kv_heads, cfg.head_dim)
    assert Model(cfg).cache_batch_axes() == (1, 1)
