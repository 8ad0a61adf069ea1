"""Five configs at their own attention layouts, against the reference on the CPU.

llama3-70b, gemma-2b, granite-3-8b, granite-34b and llama4-maverick keep
every published field that shapes attention and the head: ``n_heads``,
``n_kv_heads``, ``head_dim``, ``activation``, ``tie_embeddings`` and
``rope_theta`` (gemma's 8 heads of 256 on one KV head, granite-34b's 48 on
one, llama3-70b's 64 on 8 at theta 500,000, maverick's alternating dense
and top-1 MoE layers). Only ``d_model`` (256), ``d_ff``, the number of
experts and ``vocab`` are narrowed, at 2 layers; granite-3-8b's vocab
stays one that 8 does not divide, so its head pads and masks a tail.
(``ArchConfig.reduced()``, which ``tests/test_torch_models.py`` uses,
forces 4 heads of 32.)

The parameters are drawn by the reference's declarations (its
``ParamDef`` shapes, dtypes and init rules), ``w_q``/``w_k`` tempered as
``tests/test_torch_models.py`` explains, and carried into the port with
``params_from_numpy``, in f32; both packages are held to that file's
limits: 1e-4 on attention caches, 1e-3 on logits. Both packages'
``TwoPoolServer`` serve the same 4 requests and must give the same tokens.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.params import is_def  # noqa: E402
from repro.serving import TwoPoolServer as JaxTwoPoolServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.models import heads as theads  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving import TwoPoolServer  # noqa: E402
from test_torch_models import F32_ATTN, F32_LOGITS, _temper, as_np  # noqa: E402
from test_torch_moe import layer_ordered, reference_tree  # noqa: E402

MAVERICK = "llama4-maverick-400b-a17b"
#: Each config's narrowed widths (every other width as published).
NARROW = {
    "llama3-70b": dict(d_ff=512, vocab=512),
    "gemma-2b": dict(d_ff=512, vocab=512),
    "granite-3-8b": dict(d_ff=512, vocab=515),  # padded to 768, the tail masked
    "granite-34b": dict(d_ff=512, vocab=512),
    MAVERICK: dict(d_ff=512, moe_d_ff=256, n_experts=4, vocab=512),
}
ARCHS = list(NARROW)
#: The published fields that must survive the narrowing.
LAYOUT = ("n_heads", "n_kv_heads", "head_dim", "activation", "tie_embeddings", "rope_theta")
PROMPT, BUCKET, DECODE_STEPS, SLOT_LEN = 41, 64, 3, 64


def overrides(arch: str) -> dict:
    """The narrowed config's fields over ``reduced()``: the published
    layout restored, d_model 256, 2 layers, NARROW's widths."""
    full = get_config(arch)
    return dict({f: getattr(full, f) for f in LAYOUT}, d_model=256, n_layers=2, **NARROW[arch])


def draw(defs, rng) -> dict:
    """A parameter tree by the reference's declarations (its ``ParamDef``
    shapes, dtypes and init rules: zeros, ``normal`` at its scale,
    ``scaled`` by 1/sqrt(fan-in)), drawn with numpy: the reference's own
    threefry draws take seconds a config at these widths on the CPU (a
    layer of llama3-70b's has 8.4 M attention weights)."""
    if not is_def(defs):
        return {k: draw(defs[k], rng) for k in sorted(defs)}
    if defs.init in ("zeros", "ones"):
        return np.full(defs.shape, defs.init == "ones", np.float32).astype(defs.dtype)
    fan_in = defs.shape[-2] if len(defs.shape) >= 2 else defs.shape[-1]
    std = 1.0 / np.sqrt(max(1, fan_in)) if defs.init == "scaled" else defs.scale
    return (rng.standard_normal(defs.shape, np.float32) * np.float32(std)).astype(defs.dtype)


@functools.lru_cache(maxsize=None)
def narrowed(arch: str):
    """(reference model, port model, reference params, port params), the
    parameters f32 with w_q/w_k tempered."""
    kw = overrides(arch)
    jm = JaxModel(dataclasses.replace(jax_config(arch).reduced(), **kw))
    params = draw(jm.defs, np.random.default_rng(0))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          {**params, "blocks": _temper(params["blocks"])})
    tm = Model(dataclasses.replace(get_config(arch).reduced(), **kw))
    return jm, tm, jax.tree.map(jnp.asarray, params), params_from_numpy(params, device="cpu")


def cache_leaves(arch: str, caches) -> list:
    """Cache leaves in layer order (maverick's reference keeps its dense and
    MoE blocks' caches apart)."""
    return layer_ordered(caches) if arch == MAVERICK else list(caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_published_and_narrowing_keeps_the_layout(arch):
    """The port's config equals the reference's field for field, and the
    narrowed one keeps the published attention layout and head."""
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_config(arch))
    cfg = dataclasses.replace(full.reduced(), **overrides(arch))
    for field in LAYOUT + ("family", "moe_every", "top_k", "n_shared_experts", "pos_type"):
        assert getattr(cfg, field) == getattr(full, field), field
    assert cfg.d_model == 256 and cfg.n_layers == 2
    assert (cfg.padded_vocab != cfg.vocab) == (arch == "granite-3-8b")


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_and_mlp_at_config_widths(arch):
    """RoPE at the config's head_dim and theta over its query heads, and
    its MLP (SwiGLU, GeGLU or the plain GELU) at d_model 256."""
    cfg = get_config(arch)
    rng = np.random.default_rng(6)
    pos = np.arange(300, 316)[None]
    jc, js = jlayers.rope_angles(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    tc, ts = tlayers.rope_angles(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    q = rng.normal(size=(1, 16, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jc, js)), atol=F32_ATTN)
    x = rng.normal(size=(1, 8, 256)).astype(np.float32)
    mp = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for n, s in (("w_gate", (256, 512)), ("w_up", (256, 512)), ("w_down", (512, 256)))}
    np.testing.assert_allclose(
        tlayers.mlp(torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in mp.items()},
                    cfg.activation).numpy(),
        np.asarray(jlayers.mlp(jnp.asarray(x), {n: jnp.asarray(a) for n, a in mp.items()},
                               cfg.activation)),
        atol=F32_ATTN)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-3-8b"])
def test_head_at_published_vocab(arch):
    """gemma's tied head over its 256,000 rows and granite-3-8b's untied
    head over 49,155 (padded to 49,408, the tail masked to f32 min), at
    d 64."""
    cfg = get_config(arch)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    shape = (cfg.padded_vocab, 64) if cfg.tie_embeddings else (64, cfg.padded_vocab)
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    vv = cfg.vocab if cfg.padded_vocab != cfg.vocab else None
    got = theads.lm_logits(torch.from_numpy(x), torch.from_numpy(w), tied=cfg.tie_embeddings,
                           valid_vocab=vv)
    want = jheads.lm_logits(jnp.asarray(x), jnp.asarray(w), tied=cfg.tie_embeddings,
                            valid_vocab=vv)
    assert got.shape == (2, 3, cfg.padded_vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=F32_ATTN)
    if vv is not None:
        assert (got[..., vv:] == torch.finfo(torch.float32).min).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """A right-padded 41-token prompt in the engine's 64-token bucket: the
    logits and every layer's K/V; then the prompt's cache in a 64-position
    slot and DECODE_STEPS greedy decode steps (the reference's token fed to
    both), each step's logits and the K/V it writes."""
    jm, tm, jp, tp = narrowed(arch)
    cfg = tm.cfg
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :PROMPT] = np.random.default_rng(1).integers(1, cfg.vocab, PROMPT)
    last = PROMPT - 1
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "last_pos": jnp.asarray([last])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "last_pos": torch.tensor([last])})
    assert tl.shape == (1, cfg.padded_vocab)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=F32_LOGITS)
    ref = cache_leaves(arch, jc)
    assert len(tc) == len(ref) == 2
    for a, b in zip(ref, tc):
        assert tuple(b.shape) == a.shape == (2, 1, BUCKET, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(as_np(b), as_np(a), atol=F32_ATTN, rtol=F32_ATTN)

    # The slot cache holds the prompt's K/V (bf16, as both engines keep it),
    # taken from the reference's prefill so both decode from the same bits.
    slot = [np.zeros((2, 1, SLOT_LEN, cfg.n_kv_heads, cfg.head_dim), np.float32)
            for _ in range(2)]
    for s, a in zip(slot, ref):
        s[:, :, :PROMPT] = as_np(a)[:, :, :PROMPT]
    jcache = [jnp.asarray(s).astype(jnp.bfloat16) for s in slot]
    if arch == MAVERICK:
        jcache = reference_tree(jcache, cfg.moe_every)
    else:
        jcache = tuple(jcache)
    tcache = tuple(torch.from_numpy(s).to(torch.bfloat16) for s in slot)
    tok = int(np.argmax(as_np(jl)[0, :cfg.vocab]))
    jdecode = jax.jit(jm.decode_step)
    for i in range(DECODE_STEPS):
        index = PROMPT + i
        batch = np.array([[tok]], np.int32)
        jl, jcache = jdecode(jp, jcache, {"tokens": jnp.asarray(batch),
                                          "index": jnp.int32(index)})
        tl, tcache = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(batch),
                                                 "index": index})
        np.testing.assert_allclose(as_np(tl), as_np(jl), atol=F32_LOGITS)
        for a, b in zip(cache_leaves(arch, jcache), tcache):
            a, b = as_np(a), as_np(b)
            # the new K/V is stored in bf16: values within F32_ATTN may round
            # to neighbouring bf16 values, so one bf16 ulp on top
            np.testing.assert_allclose(b[:, :, index], a[:, :, index], atol=F32_ATTN,
                                       rtol=2**-7)
            np.testing.assert_array_equal(b[:, :, :PROMPT], a[:, :, :PROMPT])
            np.testing.assert_array_equal(b[:, :, index + 1:], a[:, :, index + 1:])
        tok = int(np.argmax(as_np(jl)[0, :cfg.vocab]))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_pool_server_matches_reference(arch):
    """The same 4 requests through both packages' TwoPoolServer, f32
    parameters carried from the reference: identical output tokens, pool
    choices and learned calibration. Every request fits the short pool
    (the long pool's engine would add its own compiles to the reference's
    run, seconds a config; the routing itself is held in
    ``tests/test_torch_serving.py``)."""
    jm, tm, jp, tp = narrowed(arch)
    kw = dict(short_cmax=64, long_cmax=128, short_slots=2, long_slots=1)
    jsrv = JaxTwoPoolServer(jm, jp, **kw)
    tsrv = TwoPoolServer(tm, tp, **kw)
    rng = np.random.default_rng(8)
    jpools, tpools = {}, {}
    for i, (n, mx) in enumerate(((12, 4), (30, 9), (7, 3), (20, 5))):
        cat = int(rng.integers(0, 4))
        toks = [int(t) for t in rng.integers(0, tm.cfg.vocab, n)]
        nbytes = int(n * (2.0 + cat))
        jpools[i] = jsrv.submit(i, toks, nbytes, mx, category=cat)
        tpools[i] = tsrv.submit(i, toks, nbytes, mx, category=cat)
    jsrv.run_to_completion()
    tsrv.run_to_completion()
    assert tpools == jpools == dict.fromkeys(range(4), "short")
    jout = {r.request_id: (r.pool, r.output_tokens, r.spilled) for r in jsrv.responses}
    tout = {r.request_id: (r.pool, r.output_tokens, r.spilled) for r in tsrv.responses}
    assert tout == jout
    assert all(0 <= t < tm.cfg.vocab for _, out, _ in tout.values() for t in out)
    assert tsrv.stats()["router"]["calibration"] == jsrv.stats()["router"]["calibration"]
