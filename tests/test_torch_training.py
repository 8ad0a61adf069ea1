"""The port's training substrate against the reference, on the CPU: the
loss head, the optimizers, schedule and clipping, the synthetic data, one
train step from carried state, microbatch accumulation, and a loss that
falls (the reference's ``tests/test_training.py`` mirrored on the port).

Inputs are numpy draws from seeds, handed to both packages. Tolerances:
1e-6 for the loss head and the optimizers (the same f32 formulas; XLA and
PyTorch may round a transcendental or a fused multiply-add differently by
an ulp); 1e-5 relative for a whole train step (a loss, a backward pass
through 4 layers, clipping and the update); the reference's own 5e-3 for
microbatches against one batch.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_models import reference_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro import training as jtraining  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.heads import softmax_xent  # noqa: E402
from repro_torch.training import (  # noqa: E402
    Adafactor,
    AdafactorState,
    AdamW,
    AdamWState,
    DataConfig,
    SyntheticLM,
    TrainConfig,
    clip_by_global_norm,
    cosine_schedule,
    get_optimizer,
    global_norm,
    init_train_state,
    make_batch_fn,
    make_train_step,
)
from repro_torch.training.tree import leaves  # noqa: E402

OPT_TOL = 1e-6


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


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def np_of(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# softmax_xent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 97), (2, 8, 4, 33)], ids=["lm", "codebooks"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(shape, z_loss, masked):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    labels.flat[:3] = logits.reshape(-1, shape[-1])[:3].argmax(-1)  # some hits
    mask = (rng.random(shape[:-1]) < 0.7).astype(np.float32) if masked else None
    want, wm = jheads.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss,
                                   mask=None if mask is None else jnp.asarray(mask))
    got, gm = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z_loss,
                           mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and set(gm) == set(wm)
    assert rel_err(got, want) <= OPT_TOL
    assert float(gm["accuracy"]) == pytest.approx(float(wm["accuracy"]), abs=OPT_TOL)


def test_softmax_xent_takes_bf16_logits_in_f32():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 5, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (3, 5)).astype(np.int32)
    b16 = torch.from_numpy(logits).bfloat16()
    want, _ = jheads.softmax_xent(jnp.asarray(b16.float().numpy()).astype(jnp.bfloat16),
                                  jnp.asarray(labels))
    got, _ = softmax_xent(b16, torch.from_numpy(labels))
    assert rel_err(got, want) <= OPT_TOL


# ---------------------------------------------------------------------------
# Optimizers, schedule, clipping
# ---------------------------------------------------------------------------


def tree_np(rng, scale=1.0) -> dict:
    """A parameter-like tree: a stacked (3-D) leaf, a matrix, a vector."""
    return {
        "blocks": {"w": (rng.normal(size=(3, 6, 5)) * scale).astype(np.float32)},
        "head": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
        "norm": (rng.normal(size=(6,)) * scale).astype(np.float32),
    }


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return params_from_numpy(tree, device="cpu")


def assert_trees_close(got, want, tol=OPT_TOL, l2=False):
    """Every leaf within ``tol``: of the leaf's largest value, or with
    ``l2`` in relative L2 (a train step's Adam update divides by the root
    of a second moment, so a gradient that is near 0 gets a larger
    relative error than the leaf's largest element shows)."""
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(np.shape(w))
        g, w = np_of(g).astype(np.float64), np.asarray(w, np.float64)
        if l2:
            assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w)
        else:
            assert rel_err(g, w) <= tol


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """Five steps from the same parameters and gradients (f32, and one
    bf16 parameter tree for AdamW), states and parameters compared after
    each."""
    rng = np.random.default_rng(2)
    params_np = tree_np(rng)
    grads_np = [tree_np(rng, 0.1) for _ in range(5)]
    jopt = jtraining.get_optimizer(name)
    topt = get_optimizer(name)
    jp, tp = to_jax(params_np), to_torch(params_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads_np):
        lr = 1e-2 * (i + 1)
        jp, js = jopt.update(to_jax(g), js, jp, jnp.float32(lr))
        tp, ts = topt.update(to_torch(g), ts, tp, torch.tensor(lr, dtype=torch.float32))
        assert_trees_close(tp, jp)
        assert int(ts.count) == int(js.count) == i + 1
        for field in ts._fields[1:]:
            assert_trees_close(getattr(ts, field), getattr(js, field))


def test_adamw_on_bf16_parameters_matches_reference():
    rng = np.random.default_rng(3)
    params_np = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
                             tree_np(rng))
    jp, tp = to_jax(params_np), to_torch(params_np)
    js, ts = jtraining.AdamW().init(jp), AdamW().init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
                         tree_np(rng, 0.1))
        jp, js = jtraining.AdamW().update(to_jax(g), js, jp, jnp.float32(3e-3))
        tp, ts = AdamW().update(to_torch(g), ts, tp, torch.tensor(3e-3))
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == torch.bfloat16
            # the same f32 result rounded to bf16: equal, or one ulp apart
            # where the f32 values straddle a rounding boundary
            np.testing.assert_allclose(np_of(a), np.asarray(b, np.float32), rtol=2**-7, atol=0)
        assert_trees_close(ts.mu, js.mu)


class TestReferenceOptimizerCases:
    """``tests/test_training.py``'s optimizer cases on the port."""

    def test_adamw_first_step_is_signed_lr(self):
        opt = AdamW(weight_decay=0.0)
        p = {"w": torch.tensor([1.0, -2.0])}
        g = {"w": torch.tensor([0.5, -0.1])}
        new_p, _ = opt.update(g, opt.init(p), p, torch.tensor(0.1))
        np.testing.assert_allclose(np_of(new_p["w"]), np.array([1.0, -2.0]) - 0.1 * np.sign(
            [0.5, -0.1]), rtol=1e-4)

    def test_adafactor_factored_shapes(self):
        s = Adafactor().init({"m": torch.zeros(8, 16), "v": torch.zeros(4)})
        assert s.vr["m"].shape == (8,) and s.vc["m"].shape == (16,)
        assert s.vr["v"].shape == (4,) and isinstance(s, AdafactorState)

    def test_adafactor_reduces_loss_direction(self):
        opt = Adafactor()
        p = {"w": torch.tensor([[2.0, -3.0]])}
        s = opt.init(p)
        for _ in range(5):
            p, s = opt.update({"w": p["w"].clone()}, s, p, torch.tensor(0.1))
        assert float(p["w"].abs().sum()) < 5.0


@pytest.mark.parametrize("step", [0, 3, 9, 10, 55, 100, 130])
def test_cosine_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    want = jtraining.cosine_schedule(jnp.int32(step), **kw)
    got = cosine_schedule(step, **kw)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= OPT_TOL


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = tree_np(np.random.default_rng(4))
    want, wnorm = jtraining.clip_by_global_norm(to_jax(tree), max_norm)
    got, gnorm = clip_by_global_norm(to_torch(tree), max_norm)
    assert rel_err(gnorm, wnorm) <= OPT_TOL
    assert rel_err(global_norm(to_torch(tree)), jtraining.global_norm(to_jax(tree))) <= OPT_TOL
    assert_trees_close(got, want)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", [0, 17, 1234])
def test_synthetic_lm_equals_reference_bit_for_bit(index):
    cfg = dict(vocab=1000, seq_len=64, global_batch=8, seed=3)
    want = jtraining.SyntheticLM(jtraining.DataConfig(**cfg))
    got = SyntheticLM(DataConfig(**cfg))
    np.testing.assert_array_equal(got.motifs, want.motifs)
    for shard in ((0, 1), (1, 2)):
        a = got.batch(index, process_index=shard[0], process_count=shard[1])
        b = want.batch(index, process_index=shard[0], process_count=shard[1])
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    fn_a = make_batch_fn(get_config("yi-6b").reduced(), 32, 4)
    fn_b = jtraining.make_batch_fn(jax_config("yi-6b").reduced(), 32, 4)
    np.testing.assert_array_equal(fn_a(index)["tokens"], fn_b(index)["tokens"])


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_train_step_from_carried_state_matches_reference():
    """Two reference steps, the state carried across, then one step in each
    package from it: loss, grad norm, lr within 1e-5, every parameter and
    both moments within 1e-5 relative L2 a leaf."""
    arch = "yi-6b"
    jcfg = jax_config(arch).reduced()
    tcfg_kw = dict(total_steps=10, warmup_steps=2, peak_lr=1e-3)
    jstep, jopt = jtraining.make_train_step(JaxModel(jcfg), jtraining.TrainConfig(**tcfg_kw))
    jp = reference_params(arch, jnp.float32)
    js = jopt.init(jp)
    data = SyntheticLM(DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2))
    jstep = jax.jit(jstep)
    for i in range(2):
        jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray, data.batch(i)), jnp.int32(i))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert isinstance(ts, AdamWState) and int(ts.count) == 2
    tstep, _ = make_train_step(Model(get_config(arch).reduced()), TrainConfig(**tcfg_kw))
    jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, data.batch(2)), jnp.int32(2))
    tp, ts, tm = tstep(tp, ts, data.batch(2), 2)
    for key in ("loss", "grad_norm", "lr", "accuracy"):
        assert rel_err(tm[key], jm[key]) <= 1e-5, key
    assert_trees_close(tp, jp, 1e-5, l2=True)
    assert_trees_close(ts.mu, js.mu, 1e-5, l2=True)
    assert_trees_close(ts.nu, js.nu, 1e-5, l2=True)


def test_opt_state_carries_adafactor_and_refuses_others():
    p = {"m": np.ones((3, 4), np.float32), "v": np.ones(2, np.float32)}
    js = jax.tree.map(np.asarray, jtraining.Adafactor().init(to_jax(p)))
    ts = opt_state_from_numpy(js, device="cpu")
    assert isinstance(ts, AdafactorState) and ts.count.shape == ()
    assert ts.vr["m"].shape == (3,) and ts.vc["v"].shape == ()
    with pytest.raises(TypeError):
        opt_state_from_numpy((1, 2), device="cpu")


def test_grad_accumulation_matches_full_batch():
    """microbatches=2 equals the single-batch step (the reference's test)."""
    cfg = get_config("yi-6b").reduced()
    model = Model(cfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)).batch(0)
    outs = {}
    for mb in (1, 2):
        tcfg = TrainConfig(total_steps=5, warmup_steps=0, microbatches=mb)
        step_fn, _ = make_train_step(model, tcfg)
        params, opt_state = init_train_state(model, tcfg, 3, device="cpu")
        p2, _, m = step_fn(params, opt_state, batch, 1)
        outs[mb] = (p2, float(m["loss"]))
    for a, b in zip(leaves(outs[1][0]), leaves(outs[2][0])):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=5e-3)
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-2)


def test_microbatches_split_mrope_positions_on_their_batch_axis():
    """qwen2-vl's (3, B, L) positions split along B, as the reference's
    accumulation does: two microbatches give the one-batch gradients."""
    cfg = get_config("qwen2-vl-7b").reduced()
    model = Model(cfg)
    rng = np.random.default_rng(5)
    b, length = 4, 16
    batch = {
        "embeds": torch.from_numpy(rng.normal(size=(b, length, cfg.d_model)) * 0.1).bfloat16(),
        "positions": rng.integers(0, 64, (3, b, length)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (b, length)).astype(np.int32),
    }
    outs = []
    for mb in (1, 2):
        tcfg = TrainConfig(total_steps=5, warmup_steps=0, microbatches=mb)
        step_fn, _ = make_train_step(model, tcfg)
        params, opt_state = init_train_state(model, tcfg, 0, device="cpu")
        p2, _, m = step_fn(params, opt_state, batch, 1)
        outs.append((p2, float(m["loss"])))
    for a, b2 in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        np.testing.assert_allclose(np_of(a), np_of(b2), atol=5e-3)
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-2)


def test_loss_decreases():
    """40 steps of reduced granite-3-8b with every layer rematerialized:
    the last five losses average 0.5 below the first five (the reference's
    test)."""
    cfg = get_config("granite-3-8b").reduced()
    model = Model(cfg, remat="full")
    tcfg = TrainConfig(total_steps=60, warmup_steps=5, peak_lr=3e-3)
    step_fn, _ = make_train_step(model, tcfg)
    params, opt_state = init_train_state(model, tcfg, 0, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    losses = []
    for i in range(40):
        params, opt_state, m = step_fn(params, opt_state, data.batch(i), i)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5


def test_train_config_defaults_match_reference():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(jtraining.TrainConfig())
    assert dataclasses.asdict(AdamW()) == dataclasses.asdict(jtraining.AdamW())
    assert dataclasses.asdict(Adafactor()) == dataclasses.asdict(jtraining.Adafactor())


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-medium"])
def test_batches_of_the_embeddings_frontend(arch, tmp_path):
    """The configs whose model takes embeddings get them from the token
    stream (the reference's launcher feeds tokens only): every input of
    ``Model.input_specs`` with its shape, bf16 values for the embeddings
    and the memory, the same batch again for the same index, a codebook
    label a column; and the launcher trains on them (finite losses)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.train import train

    cfg = get_config(arch).reduced()
    fn = make_batch_fn(cfg, 16, 2)
    batch = fn(3)
    specs = Model(cfg).input_specs(ShapeCell("t", "train", 16, 2))
    assert batch.keys() == specs.keys()
    for key, spec in specs.items():
        assert batch[key].shape == tuple(spec.shape), key
        np.testing.assert_array_equal(batch[key], fn(3)[key])
    for key in ("embeds", "memory"):
        if key in batch:
            x = torch.from_numpy(batch[key])
            assert torch.equal(x.bfloat16().float(), x) and 0.05 < x.std() < 0.2
    if cfg.n_codebooks:
        assert (batch["labels"][..., 1] == (batch["labels"][..., 0] + 1) % cfg.vocab).all()
    run = train(arch, steps=2, seq_len=16, global_batch=2, device="cpu",
                ckpt_dir=str(tmp_path), ckpt_every=None, log_every=100)
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
