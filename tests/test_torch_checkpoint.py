"""The port's checkpointer and training restart, on the CPU: the
reference's ``tests/test_checkpoint.py`` cases on tensor trees, the on-disk
format shared with the reference (a parameter checkpoint written by either
package restores in the other, bit for bit), and ``launch.train.train``
with an injected failure, resumed, against an uninterrupted run (every
loss equal, bit for bit)."""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.fault import SimulatedFailure  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.training import (  # noqa: E402
    DataConfig,
    SyntheticLM,
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.training.tree import flatten_with_paths, leaves  # noqa: E402


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


def tree():
    return {
        "w": torch.from_numpy(np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)),
        "b16": torch.tensor([1.5, -2.25, 0.125], dtype=torch.bfloat16),
        "nested": {"count": torch.tensor(7, dtype=torch.int32), "m": torch.ones(4)},
    }


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


class TestRoundTrip:
    def test_exact_bits_including_bf16(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        t = tree()
        ck.save(5, t)
        restored, _ = ck.restore(t, step=5)
        for a, b in zip(leaves(restored), leaves(t)):
            assert same_bits(a, b)

    def test_metadata_round_trip(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, tree(), {"loss": 3.25, "step_time": 0.1})
        _, meta = ck.restore(tree())
        assert meta == {"loss": 3.25, "step_time": 0.1}

    def test_async_save(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=True)
        ck.save(2, tree())
        ck.wait()
        assert ck.latest_step() == 2

    def test_async_save_holds_the_tree_at_save(self, tmp_path, monkeypatch):
        """The optimizer updates CPU leaves in place: an update made while
        an async save is still writing must not reach the checkpoint. The
        writes are held until the tree has been changed."""
        go = threading.Event()
        save = np.save

        def held_save(*args, **kwargs):
            go.wait(timeout=30)
            return save(*args, **kwargs)

        monkeypatch.setattr(np, "save", held_save)
        ck = Checkpointer(str(tmp_path), async_save=True)
        t = tree()
        want = [leaf.clone() for leaf in leaves(t)]
        ck.save(2, t)
        for leaf in leaves(t):
            leaf.add_(1)
        go.set()
        restored, _ = ck.restore(tree(), step=2)
        for a, b in zip(leaves(restored), want):
            assert same_bits(a, b)

    def test_train_state_tree_with_named_tuples(self, tmp_path):
        """{"p": params, "o": AdamWState} round-trips with the reference's
        leaf paths (``['o'].count``, ``['o'].mu['blocks']['w_q']``)."""
        model = Model(get_config("yi-6b").reduced())
        params, opt = init_train_state(model, TrainConfig(), 0, device="cpu")
        state = {"p": params, "o": opt}
        ck = Checkpointer(str(tmp_path))
        path = ck.save(3, state)
        restored, _ = ck.restore(state)
        assert type(restored["o"]) is type(opt)
        for a, b in zip(leaves(restored), leaves(state)):
            assert same_bits(a.detach(), b.detach())
        with open(os.path.join(path, "manifest.json")) as f:
            paths = [leaf["path"] for leaf in json.load(f)["leaves"]]
        assert "['o'].count" in paths and "['o'].mu['blocks']['w_q']" in paths


class TestVersioning:
    def test_latest_and_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, tree())
        assert ck.latest_step() == 4
        assert ck.completed_steps() == [3, 4]

    def test_partial_checkpoint_invisible(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, tree())
        fake = os.path.join(str(tmp_path), "step_00000009.tmp-123")
        os.makedirs(fake)
        with open(os.path.join(fake, "arr_00000.p0.npy"), "wb") as f:
            f.write(b"partial")
        assert ck.latest_step() == 1

    def test_restore_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            Checkpointer(str(tmp_path)).restore(tree())

    def test_leaf_count_mismatch_detected(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, tree())
        with pytest.raises(ValueError):
            ck.restore({"only": torch.zeros(2)})

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_async_error_surfaces_at_wait(self, tmp_path):
        ck = Checkpointer(str(tmp_path / "root"), async_save=True)
        os.rmdir(tmp_path / "root")
        (tmp_path / "root").write_text("not a directory")
        ck.save(1, tree())
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            ck.wait()


class TestAcrossPackages:
    @staticmethod
    def params():
        cfg = jax_config("yi-6b").reduced()
        return JaxModel(cfg).init(jax.random.key(0))

    def test_manifest_equals_the_references(self, tmp_path):
        """The same tree saved by both packages: the same leaf paths,
        shapes, dtype names and files."""
        jp = self.params()
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        JaxCheckpointer(str(tmp_path / "ref")).save(1, {"p": jp})
        Checkpointer(str(tmp_path / "port")).save(1, {"p": tp})
        manifests = []
        for root in ("ref", "port"):
            with open(tmp_path / root / "step_00000001" / "manifest.json") as f:
                manifests.append(json.load(f))
        for key in ("step", "process_index", "process_count", "metadata"):
            assert manifests[0][key] == manifests[1][key]
        assert manifests[0]["leaves"] == manifests[1]["leaves"]
        assert manifests[0]["treedef"] == manifests[1]["treedef"]
        assert [p for p, _ in flatten_with_paths({"p": tp})] == [
            leaf["path"] for leaf in manifests[1]["leaves"]]

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        jp = self.params()
        JaxCheckpointer(str(tmp_path)).save(4, jp, {"loss": 1.5})
        like = Model(get_config("yi-6b").reduced()).init(1, device="cpu")
        got, meta = Checkpointer(str(tmp_path)).restore(like)
        assert meta == {"loss": 1.5}
        want = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        for a, b in zip(leaves(got), leaves(want)):
            assert same_bits(a, b)

    def test_port_checkpoint_restores_in_the_reference(self, tmp_path):
        tp = Model(get_config("yi-6b").reduced()).init(2, device="cpu")
        Checkpointer(str(tmp_path)).save(6, tp)
        jp, _ = JaxCheckpointer(str(tmp_path)).restore(self.params())
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp), leaves(tp)):
            assert str(a.dtype) == str(b.dtype)[6:], jax.tree_util.keystr(path)
            np.testing.assert_array_equal(np.asarray(a).view(np.uint16 if a.dtype == jnp.bfloat16
                                                             else a.dtype),
                                          b.view(torch.int16).numpy().view(np.uint16)
                                          if b.dtype == torch.bfloat16 else b.numpy())


def test_training_resume_continuity(tmp_path):
    """Save mid-run, restore, continue: the same losses as the uninterrupted
    run, bit for bit (the reference's test, there within 1e-5)."""
    cfg = get_config("yi-6b").reduced()
    model = Model(cfg)
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    step_fn, _ = make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2))
    params, opt = init_train_state(model, tcfg, 0, device="cpu")
    ck = Checkpointer(str(tmp_path))
    losses_a = []
    for i in range(6):
        params, opt, m = step_fn(params, opt, data.batch(i), i)
        losses_a.append(float(m["loss"]))
        if i == 2:
            ck.save(i + 1, {"p": params, "o": opt})
    fresh, fresh_opt = init_train_state(model, tcfg, 5, device="cpu")
    state, _ = ck.restore({"p": fresh, "o": fresh_opt}, step=3)
    p2, o2 = state["p"], state["o"]
    losses_b = []
    for i in range(3, 6):
        p2, o2, m = step_fn(p2, o2, data.batch(i), i)
        losses_b.append(float(m["loss"]))
    assert losses_a[3:] == losses_b


def test_launcher_restart_equals_uninterrupted_run(tmp_path, capsys):
    """``train()`` with a failure injected at step 5, then resumed from its
    step-4 checkpoint with the data seeked: every loss after the resume
    equals the uninterrupted run's, bit for bit."""
    kw = dict(steps=8, seq_len=32, global_batch=2, ckpt_every=2, device="cpu", log_every=1)
    full = train("yi-6b", ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(SimulatedFailure):
        train("yi-6b", ckpt_dir=str(tmp_path / "b"), simulate_failure_at=5, **kw)
    resumed = train("yi-6b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert full["start"] == 0 and resumed["start"] == 4
    assert resumed["losses"] == full["losses"][4:]
    assert resumed["final_loss"] == full["final_loss"]
    assert "[train] resumed from step 4" in capsys.readouterr().out
