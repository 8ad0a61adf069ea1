"""The port's training loss and its gradient against the reference's
``jax.value_and_grad(model.loss)``, on the CPU at reduced widths, for every
family: yi-6b and gemma-2b (tied embeddings), qwen3-235b-a22b and
llama4-scout (MoE, both packages at ``moe_group=1``: ROADMAP R2),
zamba2-2.7b (hybrid), xlstm-350m (ssm), qwen2-vl-7b (M-RoPE, embeddings)
and musicgen-medium (cross-attention, four codebook heads). Also the
remat modes, which must not change a bit.

The reference's parameters are carried into the port with
``params_from_numpy``, tempered as the forward tests temper them
(``tests/test_torch_models.py``; the hybrid's as ``tests/test_torch_hybrid.py``
draws them). The port's gradient runs through the flash attention's
autograd Function, its plain backward on the CPU.

Tolerances, a gradient leaf at a time: f32 1e-4 relative L2 (the two sum
in different orders through 2-4 layers and back; measured at most 1.5e-6).
bf16: ``bf16_tol`` (4 bf16 ulps at the leaf's largest value) for the
attention families, whose gradients stay within 2 ulps. The backward pass
goes through every bf16 rounding point of the forward a second time, so
the families whose forward tests already need more get twice their
forward allowance: the xLSTM 8 ulps (measured 5.5, the mLSTM's w_i), the
hybrid 2 x 8 + 8 = 24 ulps (its forward tests allow 8, for the reference's
bf16 SiLU; measured 15.5, on ``d_skip``, an f32 leaf whose gradient sums
B·L·P bf16 products that largely cancel).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_hybrid  # noqa: E402
from test_torch_models import as_np, reference_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

#: The attention families here; the hybrid and the xLSTM are held by
#: ``tests/test_torch_loss_state.py`` with the same check.
ARCHS = ["yi-6b", "gemma-2b", "qwen3-235b-a22b", "llama4-scout-17b-a16e", "qwen2-vl-7b",
         "musicgen-medium"]
F32_REL = 1e-4
#: bf16 ulps, at a leaf's largest gradient, by family (the module docstring).
BF16_ULPS = {"hybrid": 24, "ssm": 8}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, L = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small eager ops. The test run's other workers
    share the cores, and intra-op threads contending for them slowed a
    40-step run 100x (8 s alone, 791 s beside five busy workers); one
    thread keeps it near its time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group(cfg) -> int:
    return 1 if cfg.is_moe else 512


def carried(arch: str, jdtype):
    if jax_config(arch).family == "hybrid":
        jp = test_torch_hybrid.reference_params(jdtype)
    else:
        jp = reference_params(arch, jdtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def make_batch(cfg, seed: int = 0) -> dict:
    """numpy inputs: tokens, or embeddings of std 0.1 (rounded to bf16),
    M-RoPE's arange positions, the conditioning memory, labels."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))

    batch = {}
    if cfg.frontend == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    else:
        batch["embeds"] = bf16(rng.normal(size=(B, L, cfg.d_model)) * 0.1)
    if cfg.pos_type == "mrope":
        batch["positions"] = np.broadcast_to(np.arange(L, dtype=np.int32), (3, B, L)).copy()
    if cfg.cross_attention:
        batch["memory"] = bf16(rng.normal(size=(B, cfg.cross_mem_len, cfg.d_model)) * 0.1)
    labels = (B, L, cfg.n_codebooks) if cfg.n_codebooks else (B, L)
    batch["labels"] = rng.integers(0, cfg.vocab, labels).astype(np.int32)
    return batch


def to_jax(batch: dict, jdtype) -> dict:
    """Embeddings in the model's dtype, the memory in bf16 (as the
    reference's ``input_specs`` has it)."""
    dt = {"embeds": jdtype, "memory": jnp.bfloat16}
    return {k: jnp.asarray(v).astype(dt[k]) if k in dt else jnp.asarray(v)
            for k, v in batch.items()}


def to_torch(batch: dict, tdtype) -> dict:
    dt = {"embeds": tdtype, "memory": torch.bfloat16}
    return {k: torch.from_numpy(v).to(dt[k]) if k in dt else torch.from_numpy(v)
            for k, v in batch.items()}


def port_value_and_grad(model: Model, params: dict, batch: dict):
    p_leaves = leaves(params)
    for p in p_leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    return loss, metrics, torch.autograd.grad(loss, p_leaves)


def check_loss_and_gradients(arch: str, dtype: str) -> None:
    """The loss, its metrics and every gradient leaf of ``arch`` against the
    reference's, at the tolerances of the module docstring."""
    jdtype, tdtype = DTYPES[dtype]
    jcfg = jax_config(arch).reduced()
    jmodel = JaxModel(jcfg, moe_group=group(jcfg))
    tmodel = Model(get_config(arch).reduced(), moe_group=group(jcfg))
    jp, tp = carried(arch, jdtype)
    batch = make_batch(jcfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jp, to_jax(batch, jdtype))
    loss, metrics, grads = port_value_and_grad(tmodel, tp, to_torch(batch, tdtype))
    assert set(metrics) == set(jmetrics)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(jleaves) == len(grads)
    ulps = BF16_ULPS.get(jcfg.family, 4)
    for (path, jg), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        assert tuple(g.shape) == jg.shape and str(g.dtype)[6:] == str(jg.dtype), name
        ref, got = as_np(jg), as_np(g)
        if dtype == "f32":
            err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert err <= F32_REL, f"{name}: rel L2 {err}"
        else:
            tol = ulps * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
            np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)
    loss_tol = 1e-5 if dtype == "f32" else 2e-3
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=loss_tol)
    for key in jmetrics:
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmetrics[key]),
                                   rtol=loss_tol, atol=loss_tol, err_msg=key)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dtype):
    check_loss_and_gradients(arch, dtype)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-235b-a22b", "zamba2-2.7b", "xlstm-350m",
                                  "musicgen-medium"])
def test_remat_changes_no_bit(arch):
    """``remat="full"`` and ``"dots"`` give the loss and every gradient of
    ``"none"``, bit for bit (bf16 weights)."""
    cfg = get_config(arch).reduced()
    batch = to_torch(make_batch(cfg, seed=1), torch.bfloat16)
    out = {}
    for mode in ("none", "full", "dots"):
        model = Model(cfg, moe_group=group(cfg), remat=mode)
        params = model.init(0, device="cpu")
        loss, _, grads = port_value_and_grad(model, params, batch)
        out[mode] = (loss.detach(), grads)
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b), mode


def test_forward_runs_without_remat_and_rejects_unknown_modes():
    cfg = get_config("yi-6b").reduced()
    with pytest.raises(ValueError, match="remat"):
        Model(cfg, remat="some")
    model = Model(cfg, remat="full")
    params = model.init(0, device="cpu")
    batch = to_torch(make_batch(cfg), torch.bfloat16)
    logits, _ = model.forward(params, batch)
    loss, metrics = model.loss(params, batch)
    assert logits.shape == (B, L, cfg.padded_vocab)
    assert set(metrics) == {"loss", "accuracy", "aux_loss", "total_loss"}
    assert torch.isfinite(loss)
