"""The port's dense model stack against the reference, at reduced widths.

The reference's parameters are carried into the port with
``params_from_numpy`` and the same token batches go through both
packages: ``forward``, ``prefill`` (logits and caches) and ``decode_step``.

About the parameters: the reference scales a 3-D projection by the fan-in
``shape[-2]``, which for ``w_q``/``w_k`` (d, heads, head_dim) is the head
count, so at reduced widths q and k come out ~3x larger than fan-in
scaling and attention saturates into a near arg-max. There a 1e-7 change
in a score can move a whole row's weight to another key, and the
comparison would measure that amplification instead of the port. The
carried ``w_q`` and ``w_k`` are therefore scaled by 0.1 (in the
reference's own tree, before both packages see it).
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
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import REGISTRY, ShapeCell, get_config  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

ARCHS = ["yi-6b", "granite-3-8b", "gemma-2b", "granite-34b", "llama3-70b"]

# f32: the two packages sum matmuls and softmaxes in different orders;
# through 2-4 layers that stays near 1e-6 relative, so 1e-4 on attention
# outputs and caches and 1e-3 on logits (|logit| up to ~4) leave margin.
F32_ATTN, F32_LOGITS = 1e-4, 1e-3
# bf16: every matmul output, activation and residual add is rounded to 8
# significant bits, at different points in the two packages, and the
# error a rounding leaves is absolute at the scale of the tensor it feeds:
# 4 bf16 ulps of the tensor's largest |value| (2**-4 for logits < 4).
BF16_ULPS = 4


def bf16_tol(ref) -> float:
    """BF16_ULPS ulps of bf16 at the largest |value| of ``ref``."""
    top = float(np.abs(as_np(ref)).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


TEMPERED = ("w_q", "w_k", "cross_w_q", "cross_w_k")
#: The xLSTM's sLSTM gate projections, (d, heads, head_dim) like w_q.
SLSTM_GATES = ("w_z", "w_i", "w_f", "w_o")


def _temper(tree: dict, keys: tuple = TEMPERED) -> dict:
    """``tree`` with every leaf named in ``keys``, at any depth (the MoE
    family nests its layers under ``moe_block`` / ``dense_block``), scaled
    by 0.1: by default every ``w_q``/``w_k`` and musicgen's
    cross-attention ``cross_w_q``/``cross_w_k``."""
    return {
        k: _temper(v, keys) if isinstance(v, dict)
        else (v.astype(jnp.float32) * 0.1).astype(v.dtype) if k in keys else v
        for k, v in tree.items()
    }


@functools.lru_cache(maxsize=None)
def _tempered_init(arch: str, overrides: tuple) -> dict:
    """The attention families' ``blocks`` tempered. The xLSTM has no
    attention, but the same fan-in rule makes its mLSTM's q·k and its
    sLSTM's gate preactivations large (``tests/test_torch_xlstm.py``
    says what that does), so its mLSTM ``w_q``/``w_k`` and its sLSTM gate
    projections are tempered alike."""
    cfg = dataclasses.replace(jax_config(arch).reduced(), **dict(overrides))
    params = JaxModel(cfg).init(jax.random.key(0))
    if "slstm" in params:
        return {**params, "mlstm": _temper(params["mlstm"]),
                "slstm": _temper(params["slstm"], SLSTM_GATES)}
    return {**params, "blocks": _temper(params["blocks"])}


def reference_params(arch: str, dtype, **overrides):
    """The reference's params for the reduced arch (with ``overrides``
    replacing config fields), w_q/w_k tempered (see the module docstring),
    weights cast to ``dtype`` (norms and the MoE router stay f32)."""
    params = _tempered_init(arch, tuple(sorted(overrides.items())))
    return jax.tree.map(
        lambda x: x.astype(dtype) if x.dtype == jnp.bfloat16 else x, params
    )


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    return (
        JaxModel(jax_config(arch).reduced()),
        Model(get_config(arch).reduced()),
        arch,
    )


def carried(arch, dtype):
    jp = reference_params(arch, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


DTYPES = [(jnp.float32, F32_ATTN, F32_LOGITS), (jnp.bfloat16, None, None)]
DTYPE_IDS = ["f32", "bf16"]


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_forward_matches_reference(pair, dtype, tol_attn, tol_logits):
    jm, tm, arch = pair
    jp, tp = carried(arch, dtype)
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 64))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 64, jm.cfg.padded_vocab) and tl.dtype == tp["embed"].dtype
    assert float(aux) == 0.0
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_prefill_matches_reference(pair, dtype, tol_attn, tol_logits):
    """Right-padded prompt (the engine's 64-token bucket) with last_pos."""
    jm, tm, arch = pair
    jp, tp = carried(arch, dtype)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :41] = np.random.default_rng(1).integers(1, jm.cfg.vocab, 41)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray([40])})
    tl, tc = tm.prefill(
        tp, {"tokens": torch.from_numpy(toks), "last_pos": torch.tensor([40])}
    )
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    assert len(tc) == len(jc) == 2
    for a, b in zip(jc, tc):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(
            as_np(b), as_np(a), atol=tol_attn or bf16_tol(a), rtol=tol_attn or 0
        )


@pytest.mark.parametrize("dtype,tol_attn,tol_logits", DTYPES, ids=DTYPE_IDS)
def test_decode_step_matches_reference(pair, dtype, tol_attn, tol_logits):
    """One decode step over the same bf16 cache in both packages: the
    logits, and the K/V written at ``index`` (the rest is untouched)."""
    jm, tm, arch = pair
    jp, tp = carried(arch, dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    jcache = (jnp.asarray(k0).astype(jnp.bfloat16), jnp.asarray(v0).astype(jnp.bfloat16))
    tcache = tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (k0, v0))
    tok = np.array([[int(rng.integers(0, cfg.vocab))]], np.int32)
    jl, jnc = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(tok), "index": jnp.int32(41)})
    tl, tnc = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(tok), "index": 41})
    assert tnc[0] is tcache[0]  # updated in place
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=tol_logits or bf16_tol(jl))
    for a, b in zip(jnc, tnc):
        a, b = as_np(a), as_np(b)
        # the new K/V is stored in bf16 in both dtypes: f32 values within
        # tol_attn may round to neighbouring bf16 values, so one bf16 ulp
        # (2**-7 relative) on top
        new_a, new_b = a[:, :, 41], b[:, :, 41]
        np.testing.assert_allclose(
            new_b, new_a, atol=tol_attn or bf16_tol(new_a), rtol=2**-7
        )
        keep = np.ones(64, bool)
        keep[41] = False
        np.testing.assert_array_equal(b[:, :, keep], a[:, :, keep])


def test_decode_step_per_slot_index():
    """A per-slot index equals running each slot alone with its own index
    (what the reference's vmap over slots does)."""
    cfg = get_config("yi-6b").reduced()
    tm = Model(cfg)
    _, tp = carried("yi-6b", jnp.float32)
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, 3, 64, cfg.n_kv_heads, cfg.head_dim)
    k0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    v0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
    index = torch.tensor([5, 63, 17])
    batched = (k0.clone(), v0.clone())
    logits, _ = tm.decode_step(tp, batched, {"tokens": toks, "index": index})
    for s in range(3):
        solo = (k0[:, s : s + 1].clone(), v0[:, s : s + 1].clone())
        ls, _ = tm.decode_step(tp, solo, {"tokens": toks[s : s + 1], "index": int(index[s])})
        np.testing.assert_allclose(as_np(logits[s]), as_np(ls[0]), atol=1e-5)
        for a, b in zip(batched, solo):
            assert torch.equal(a[:, s], b[:, 0])


@pytest.mark.parametrize("length", [12, 576])
def test_flash_attention_any_length(length):
    """The port's prefill attention takes lengths the reference's chunked
    jnp version refuses (L=576 does not divide min(512, L)); at L=12 both
    run and agree."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, length, 4, 32)).astype(np.float32)
    k = rng.normal(size=(1, length, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, length, 2, 32)).astype(np.float32)
    out = tlayers.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == (1, length, 4, 32) and torch.isfinite(out).all()
    chunk = min(512, length)
    if length % chunk:
        with pytest.raises(ValueError):
            jlayers.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), q_chunk=chunk, kv_chunk=chunk)
        return
    expect = jlayers.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(as_np(out), as_np(expect), atol=F32_ATTN)


def test_layers_match_reference():
    """rms_norm ((1 + w) scaling), swiglu/geglu/gelu mlp, half-split RoPE."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6,
    )
    mp = {n: rng.normal(size=s).astype(np.float32) * 0.2
          for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    for act in ("swiglu", "geglu", "gelu"):
        np.testing.assert_allclose(
            tlayers.mlp(torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in mp.items()}, act).numpy(),
            np.asarray(jlayers.mlp(jnp.asarray(x), {n: jnp.asarray(a) for n, a in mp.items()}, act)),
            atol=1e-5,
        )
    pos = np.arange(16)[None].repeat(2, 0)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 32, 5e6)
    tc, ts = tlayers.rope_angles(torch.from_numpy(pos), 32, 5e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    q = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jc, js)),
        atol=1e-5,
    )


def test_params_mirror_reference_layout():
    """Same tree, shapes and dtypes as the reference's defs (full widths,
    nothing allocated), and a seeded init is reproducible."""
    for arch in ARCHS:
        ref = JaxModel(jax_config(arch))
        port = Model(get_config(arch))
        assert port.param_count() == ref.param_count()
        assert port.param_bytes() == ref.param_bytes()
        ref_abs = jax.tree.map(lambda s: (s.shape, str(s.dtype)), ref.abstract())
        port_abs = jax.tree.map(
            lambda d: (d.shape, str(d.dtype).replace("torch.", "")),
            port.defs,
            is_leaf=lambda d: hasattr(d, "init"),
        )
        assert port_abs == ref_abs
    small = Model(get_config("yi-6b").reduced())
    a, b = small.init(7, device="cpu"), small.init(7, device="cpu")
    assert all(torch.equal(a["blocks"][n], b["blocks"][n]) for n in a["blocks"])
    assert a["blocks"]["w_q"].dtype == torch.bfloat16
    assert a["blocks"]["attn_norm"].dtype == torch.float32


def test_init_cache_is_bf16_slot_layout():
    cfg = get_config("granite-3-8b").reduced()
    k, v = Model(cfg).init_cache(ShapeCell("c", "decode", 64, 3), device="cpu")
    assert k.shape == v.shape == (cfg.n_layers, 3, 64, cfg.n_kv_heads, cfg.head_dim)
    assert k.dtype == torch.bfloat16 and not k.any()


def test_other_families_raise():
    """Every family the reference ships constructs (dense, MoE, vlm, audio,
    hybrid, ssm); a family the reference does not know raises, as the
    reference's ``Model`` does."""
    for cfg in REGISTRY.values():
        Model(cfg.reduced())
    with pytest.raises(ValueError, match="family"):
        Model(dataclasses.replace(get_config("yi-6b").reduced(), family="rnn"))


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the entry points run on it")
    model = Model(dataclasses.replace(get_config("yi-6b").reduced(), n_layers=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(ShapeCell("c", "decode", 16, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
