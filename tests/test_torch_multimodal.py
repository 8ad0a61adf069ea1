"""The port's vlm and audio stacks (qwen2-vl-7b, musicgen-medium) against
the reference, on the CPU, at reduced widths; and the model surface over
every config.

The parts alone: ``mrope_angles`` (three position streams over the rotary
pairs' sections) and ``codebook_logits`` (four heads, the padded vocab
masked). Then both models with the reference's parameters carried by
``params_from_numpy`` (``w_q``/``w_k`` and musicgen's ``cross_w_q`` /
``cross_w_k`` tempered by 0.1, as ``tests/test_torch_models.py`` explains)
through ``forward``, ``prefill`` (logits and every cache leaf, the cross
leaves included) and ``decode_step``, in f32 and bf16, on batches built as
the reference's ``tests/test_models.py::make_batch`` builds them: bf16
embeddings of std 0.1, M-RoPE positions ``arange(L)`` on all three streams,
a bf16 memory of std 0.1. The f32 model takes the same embedding values in
f32 (the reference's layer scan refuses bf16 embeddings into an f32 model)
and the bf16 memory, which both packages promote at its projections.
Decode continuing a prefill through the port's ``SlotKVCache`` equals a
forward over the longer sequence. Over every config: ``Model(get_config(name))`` constructs and ``input_specs`` has the
reference's shapes and dtypes.

Tolerances are ``tests/test_torch_models.py``'s: f32 1e-4 on caches and
1e-3 on logits; bf16 4 ulps at the tensor's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import ALL_SHAPES  # noqa: E402
from repro.configs.base import ShapeCell as JaxShapeCell  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving import SlotKVCache as JaxSlotKVCache  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.models import heads as theads  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving import ServingEngine, SlotKVCache  # noqa: E402
from test_torch_models import (  # noqa: E402
    F32_ATTN,
    F32_LOGITS,
    as_np,
    bf16_tol,
    reference_params,
)

VLM, AUDIO = "qwen2-vl-7b", "musicgen-medium"
DTYPES = [(jnp.float32, F32_ATTN, F32_LOGITS), (jnp.bfloat16, None, None)]
DTYPE_IDS = ["f32", "bf16"]
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


# ---------------------------------------------------------------------------
# The parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VLM, f"{VLM}-reduced"])
def test_mrope_angles_matches_reference(arch):
    cfg = jax_config(VLM) if arch == VLM else jax_config(VLM).reduced()
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (3, 2, 24)).astype(np.int32)  # three distinct streams
    jc, js = jlayers.mrope_angles(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta,
                                  cfg.mrope_sections)
    tc, ts = tlayers.mrope_angles(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta,
                                  cfg.mrope_sections)
    assert tc.shape == (2, 24, cfg.head_dim // 2) and tc.dtype == torch.float32
    # cos/sin of angles up to 4096 rad: both round the same f32 angle, then
    # their own cos/sin (a few f32 ulps of the angle)
    np.testing.assert_allclose(as_np(tc), as_np(jc), atol=2e-6 * 4096)
    np.testing.assert_allclose(as_np(ts), as_np(js), atol=2e-6 * 4096)
    with pytest.raises(ValueError, match="sum"):
        tlayers.mrope_angles(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta, (1, 2, 3))


@pytest.mark.parametrize("valid", [None, 500])
def test_codebook_logits_matches_reference(valid):
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, 8, 32)).astype(np.float32)
    heads = rng.normal(0.0, 0.2, (4, 32, 512)).astype(np.float32)
    jl = jheads.codebook_logits(jnp.asarray(hidden), jnp.asarray(heads), valid_vocab=valid)
    tl = theads.codebook_logits(torch.from_numpy(hidden), torch.from_numpy(heads),
                                valid_vocab=valid)
    assert tl.shape == (2, 8, 4, 512)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Every config
# ---------------------------------------------------------------------------


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_every_config_constructs_with_reference_inputs(name):
    """``Model`` at the published widths, its parameter count, and
    ``input_specs`` for every shape cell of the reference's matrix (and a
    small one of each kind) against the reference's."""
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    port, ref = Model(get_config(name)), JaxModel(jax_config(name))
    assert port.param_count() == ref.param_count()
    cells = [(c.name, c.kind, c.seq_len, c.global_batch) for c in ALL_SHAPES]
    cells += [("t", "train", 16, 2), ("p", "prefill", 40, 1), ("d", "decode", 64, 3)]
    for cell in cells:
        want, _ = ref.input_specs(JaxShapeCell(*cell))
        got = port.input_specs(ShapeCell(*cell))
        assert sorted(got) == sorted(want), cell
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == spec.shape, (cell, key)
            assert _dtype_name(got[key]) == str(spec.dtype), (cell, key)


def test_engine_refuses_embeddings_frontend():
    model = Model(get_config(VLM).reduced())
    with pytest.raises(ValueError, match="token-frontend"):
        ServingEngine(model, model.init(0, device="cpu"), c_max=64, n_slots=2)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[VLM, AUDIO])
def pair(request):
    arch = request.param
    return JaxModel(jax_config(arch).reduced()), Model(get_config(arch).reduced()), arch


def carried(arch, dtype):
    jp = reference_params(arch, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def make_batch(cfg, b: int, length: int, seed: int) -> dict:
    """numpy inputs as the reference's ``make_batch`` builds them (f32
    values rounded to bf16; returned as f32 arrays holding bf16 values),
    the positions int32."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))

    batch = {"embeds": bf16(rng.normal(size=(b, length, cfg.d_model)) * 0.1)}
    if cfg.pos_type == "mrope":
        batch["positions"] = np.broadcast_to(
            np.arange(length, dtype=np.int32)[None, None], (3, b, length)).copy()
    if cfg.cross_attention:
        batch["memory"] = bf16(rng.normal(size=(b, cfg.cross_mem_len, cfg.d_model)) * 0.1)
    return batch


def to_jax(batch: dict, dtype) -> dict:
    """The embeddings in the model's dtype (the reference's layer scan
    takes no bf16 embeddings into an f32 model), the memory in bf16."""
    dt = {"embeds": dtype, "memory": jnp.bfloat16}
    return {k: jnp.asarray(v).astype(dt[k]) if k in dt else jnp.asarray(v)
            for k, v in batch.items()}


def to_torch(batch: dict, dtype) -> dict:
    dt = {"embeds": TORCH_DTYPES[dtype], "memory": torch.bfloat16}
    return {k: torch.from_numpy(v).to(dt[k]) if k in dt else torch.from_numpy(v)
            for k, v in batch.items()}


def logits_shape(cfg, *lead):
    return (*lead, cfg.n_codebooks, cfg.padded_vocab) if cfg.n_codebooks else \
        (*lead, cfg.padded_vocab)


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_forward_matches_reference(pair, dtype, tol_attn, tol_logits):
    jm, tm, arch = pair
    jp, tp = carried(arch, dtype)
    batch = make_batch(jm.cfg, 2, 32, seed=0)
    jl, _ = jm.forward(jp, to_jax(batch, dtype))
    tl, aux = tm.forward(tp, to_torch(batch, dtype))
    assert tl.shape == logits_shape(jm.cfg, 2, 32) and float(aux) == 0.0
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_prefill_matches_reference(pair, dtype, tol_attn, tol_logits):
    """Last-position logits and every cache leaf: (k, v) and, for musicgen,
    the memory's (cross_k, cross_v)."""
    jm, tm, arch = pair
    jp, tp = carried(arch, dtype)
    batch = make_batch(jm.cfg, 1, 64, seed=1)
    jl, jc = jm.prefill(jp, to_jax(batch, dtype))
    tl, tc = tm.prefill(tp, to_torch(batch, dtype))
    assert tl.shape == logits_shape(jm.cfg, 1)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    assert len(tc) == len(jc) == 2 + 2 * jm.cfg.cross_attention
    for a, b in zip(jc, tc):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(as_np(b), as_np(a), atol=tol_attn or bf16_tol(a),
                                   rtol=tol_attn or 0)


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_decode_step_matches_reference(pair, dtype, tol_attn, tol_logits):
    """One decode step over the same bf16 caches in both packages, M-RoPE's
    three streams at distinct positions: the logits, the K/V written at
    ``index``, the rest untouched (the cross caches are only read)."""
    jm, tm, arch = pair
    jp, tp = carried(arch, dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    self_shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    shapes = [self_shape] * 2
    if cfg.cross_attention:
        shapes += [(cfg.n_layers, 1, cfg.cross_mem_len, cfg.n_kv_heads, cfg.head_dim)] * 2
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jcache = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    tcache = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    before = [t.clone() for t in tcache]
    step = {"embeds": make_batch(cfg, 1, 1, seed=3)["embeds"]}
    if cfg.pos_type == "mrope":
        step["positions"] = np.array([41, 7, 23], np.int32).reshape(3, 1, 1)
    jb, tb = to_jax(step, dtype), to_torch(step, dtype)
    jl, jnc = jm.decode_step(jp, jcache, {**jb, "index": jnp.int32(41)})
    tl, tnc = tm.decode_step(tp, tcache, {**tb, "index": 41})
    assert tnc[0] is tcache[0] and tl.shape == logits_shape(cfg, 1)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    keep = np.ones(64, bool)
    keep[41] = False
    for i, (a, b) in enumerate(zip(jnc, tnc)):
        a, b = as_np(a), as_np(b)
        if i >= 2:  # cross caches: read, never written
            np.testing.assert_array_equal(b, as_np(before[i]))
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_allclose(b[:, :, 41], a[:, :, 41],
                                   atol=tol_attn or bf16_tol(a[:, :, 41]), rtol=2**-7)
        np.testing.assert_array_equal(b[:, :, keep], a[:, :, keep])


def test_cache_layout_matches_reference(pair):
    """The port's zero slot cache has the reference's leaves, shapes and
    slot axes (its ``SlotKVCache``, sized by a prefill of ``c_max``)."""
    jm, tm, _ = pair
    jcache = JaxSlotKVCache(jm, 64, 3)
    tcache = SlotKVCache(tm, 64, 3, device="cpu", act_dtype=torch.bfloat16)
    assert len(tcache.state) == len(jcache.state)
    for a, b, ax_a, ax_b in zip(jcache.state, tcache.state, jcache.batch_axes,
                                tcache.batch_axes):
        assert tuple(b.shape) == a.shape and _dtype_name(b) == str(a.dtype) and ax_a == ax_b


def test_decode_continues_prefill(pair):
    """A prefill copied into slot 1 of the port's ``SlotKVCache``, then
    decode steps with per-slot index (and, for M-RoPE, per-slot positions):
    each step's logits equal a forward over the longer sequence (f32)."""
    _, tm, arch = pair
    _, tp = carried(arch, jnp.float32)
    cfg = tm.cfg
    full = to_torch(make_batch(cfg, 1, 40, seed=4), jnp.float32)
    ref, _ = tm.forward(tp, full)

    def prefix(n):
        b = {"embeds": full["embeds"][:, :n]}
        if "positions" in full:
            b["positions"] = full["positions"][:, :, :n]
        if "memory" in full:
            b["memory"] = full["memory"]
        return b

    logits, state = tm.prefill(tp, prefix(33))
    np.testing.assert_allclose(as_np(logits[0]), as_np(ref[0, 32]), atol=F32_LOGITS)
    cache = SlotKVCache(tm, 64, 2, device="cpu", act_dtype=torch.float32)
    # an f32 cache, so the comparison sees no bf16 rounding of K/V
    cache.state = tuple(t.float() for t in cache.state)
    cache.insert_prefill(1, state)
    for t in range(33, 40):
        step = {"embeds": full["embeds"][:, t : t + 1].repeat(2, 1, 1),
                "index": torch.tensor([3, t])}
        if "positions" in full:
            step["positions"] = torch.tensor([3, t]).view(1, 2, 1).repeat(3, 1, 1)
        logits, _ = tm.decode_step(tp, cache.state, step)
        np.testing.assert_allclose(as_np(logits[1]), as_np(ref[0, t]), atol=F32_LOGITS)


def test_int8_cache_with_cross_attention(monkeypatch):
    """musicgen with ``kv_dtype="int8"`` (f32 weights): the prefill's six
    cache leaves (int8 k/v one quantization step apart at most, as in
    ``tests/test_torch_int8_kv.py``; f16 scales; the cross k/v), and a
    decode step over the same int8 self cache and cross cache against the
    reference with its dequantization in f32 (the port dequantizes each
    page in f32, ROADMAP.md C)."""
    from repro.models import transformer as jtransformer

    jm = JaxModel(jax_config(AUDIO).reduced(), kv_dtype="int8")
    tm = Model(get_config(AUDIO).reduced(), kv_dtype="int8")
    jp, tp = carried(AUDIO, jnp.float32)
    cfg = jm.cfg
    batch = make_batch(cfg, 1, 64, seed=6)
    jl, jc = jm.prefill(jp, to_jax(batch, jnp.float32))
    tl, tc = tm.prefill(tp, to_torch(batch, jnp.float32))
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=F32_LOGITS)
    assert len(tc) == len(jc) == 6
    assert [t.dtype for t in tc[:4]] == [torch.int8, torch.int8, torch.float16, torch.float16]
    for a, b in zip(jc[:2], tc[:2]):
        diff = np.abs(b.numpy().astype(np.int32) - np.asarray(a).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for a, b in zip(jc[2:4], tc[2:4]):
        np.testing.assert_allclose(as_np(b), as_np(a), rtol=2e-3)
    for a, b in zip(jc[4:], tc[4:]):
        np.testing.assert_allclose(as_np(b), as_np(a), atol=F32_ATTN, rtol=F32_ATTN)

    monkeypatch.setattr(jtransformer, "dequantize_kv",
                        lambda q, s: q.astype(jnp.float32) * s.astype(jnp.float32))
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    kq, ks = jtransformer.quantize_kv(jnp.asarray(rng.normal(size=shape), jnp.float32))
    vq, vs = jtransformer.quantize_kv(jnp.asarray(rng.normal(size=shape), jnp.float32))
    cross = (cfg.n_layers, 1, cfg.cross_mem_len, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (jnp.asarray(rng.normal(size=cross), jnp.float32) for _ in range(2))
    jcache = (kq, vq, ks, vs, ck, cv)
    tcache = tuple(params_from_numpy(np.asarray(t), device="cpu") for t in jcache)
    step = {"embeds": make_batch(cfg, 1, 1, seed=8)["embeds"]}
    jl, _ = jm.decode_step(jp, jcache, {**to_jax(step, jnp.float32), "index": jnp.int32(41)})
    tl, _ = tm.decode_step(tp, tcache, {**to_torch(step, jnp.float32), "index": 41})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=1e-5)
