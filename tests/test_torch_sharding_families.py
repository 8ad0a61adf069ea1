"""The MoE and hybrid families and the int8 KV cache on DTensors over two
gloo ranks (a 1 x 2 mesh, ``tests/torch_mesh_worker.py``'s ``families2``
phase, one launch for every case), against one plain process and the
reference, at reduced widths with f32 parameters:

* reduced qwen3-235b-a22b (4 experts, top 2, the experts sharded) at the
  default ``moe_group`` and at 1, and zamba2-2.7b (its SSM heads sharded):
  the loss and every gradient leaf within 1e-5 of one process; against the
  reference's ``jax.value_and_grad``, qwen3 at ``moe_group=1`` (ROADMAP
  R2) within 1e-5 and zamba2 within ``tests/test_torch_loss.py``'s 1e-4
  relative L2 a leaf (the reference's SSD chunk is 128, the port's 64);
* each family's decode step and prefill: logits within 1e-5 of one
  process, the cache and states within 2**-8;
* a decode step and a prefill on an int8 KV cache of yi-6b
  (heads-sharded), gemma-2b (one KV head: sequence-sharded) and qwen3:
  logits within 1e-5, the int8 codes within one step and the scales
  within 2**-8, every leaf placed as the policy says;
* one MoE layer's forward and backward all-gathers no expert weight.
"""

from __future__ import annotations

import os
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training.tree import flatten_with_paths, leaves, map_tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as worker  # noqa: E402

QWEN3, ZAMBA2 = "qwen3-235b-a22b", "zamba2-2.7b"
#: Per-leaf relative L2 the hybrid's gradients keep from the reference's
#: (``tests/test_torch_loss.py``'s f32 tolerance).
HYBRID_REF_REL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worker.run_ranks("families2", 2, tmp_path_factory.mktemp("families"))


def one_process(tag: str, train: bool = True) -> dict:
    """The worker's case on plain tensors in this process."""
    arch, kw = {**worker.FAMILIES, **worker.INT8}[tag]
    model = Model(get_config(arch).reduced(), **kw)
    params = worker.f32_params(model)
    out = {"params": params}
    if train:
        for p in leaves(params):
            p.requires_grad_(True)
        loss, _ = model.loss(params, worker.train_batch(model.cfg))
        out["loss"] = loss.detach()
        out["grads"] = dict(zip((path for path, _ in flatten_with_paths(params)),
                                torch.autograd.grad(loss, leaves(params))))
        params = map_tree(lambda t: t.detach(), params)
    cache, batch = worker.decode_inputs(model)
    with torch.no_grad():
        out["logits"], cache = model.decode_step(params, cache, batch)
        out["prefill_logits"], state = model.prefill(
            params, {"tokens": worker.train_batch(model.cfg)["tokens"]})
    out["cache"], out["prefill_state"] = leaves(cache), leaves(state)
    return out


def close_leaves(got: list, want: list) -> None:
    """Cache or state leaves: floats within 2**-8 (a head-sharded
    projection sums in another order, which may round a bf16 value to its
    neighbour), int8 codes within one step."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if w.dtype == torch.int8:  # a reordered sum may round a code once
            assert (g.int() - w.int()).abs().max().item() <= 1, f"leaf {i}"
        else:
            worker.close(g, w, 2 ** -8, f"leaf {i}")


def reference_loss_and_grads(tag: str, params: dict) -> tuple:
    arch, kw = worker.FAMILIES[tag]
    rmodel = ref_zoo.Model(REF_REGISTRY[arch].reduced(), **kw)
    jp = map_tree(lambda t: jax.numpy.asarray(t.detach().numpy()), params)
    batch = worker.train_batch(get_config(arch).reduced())
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rmodel.loss(p, jb)[0]))(jp)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    return (torch.from_numpy(np.array(loss)),
            {jax.tree_util.keystr(p): torch.from_numpy(np.array(g)) for p, g in flat})


@pytest.mark.parametrize("tag", list(worker.FAMILIES))
def test_loss_and_grads_match_one_process(runs, tag):
    want = one_process(tag)
    for got in runs:  # each rank gathered the same whole values
        worker.close(got[f"{tag}/loss"], want["loss"], 1e-5, "loss")
        for path, g in want["grads"].items():
            worker.close(got[f"{tag}/grad{path}"], g, 1e-5, path)


@pytest.mark.parametrize("tag", [f"{QWEN3}/group1", ZAMBA2])
def test_loss_and_grads_match_reference(runs, tag):
    ref_loss, ref_grads = reference_loss_and_grads(tag, one_process(tag, train=False)["params"])
    got = runs[0]
    worker.close(got[f"{tag}/loss"], ref_loss, 1e-5, "loss")
    paths = [k.removeprefix(f"{tag}/grad") for k in got if k.startswith(f"{tag}/grad")]
    assert set(paths) == set(ref_grads)
    for path in paths:
        g, want = got[f"{tag}/grad{path}"], ref_grads[path]
        if tag == ZAMBA2:
            err = ((g - want).norm() / want.norm().clamp_min(1e-30)).item()
            assert err <= HYBRID_REF_REL, f"{path}: rel L2 {err}"
        else:
            worker.close(g, want, 1e-5, path)


@pytest.mark.parametrize("tag", [QWEN3, ZAMBA2, *worker.INT8])
def test_decode_matches_one_process(runs, tag):
    want = one_process(tag, train=False)
    for got in runs:
        worker.close(got[f"{tag}/decode_logits"], want["logits"], 1e-5, "logits")
        close_leaves(got[f"{tag}/decode_cache"], want["cache"])


@pytest.mark.parametrize("tag", [QWEN3, ZAMBA2, *worker.INT8])
def test_prefill_matches_one_process(runs, tag):
    """A prefill on the mesh (the MoE layer and the SSD scan on shards, the
    hybrid's conv state gathered whole, an int8 cache quantized on shards):
    logits within 1e-5 of one process, the state as the decode's cache."""
    want = one_process(tag, train=False)
    for got in runs:
        worker.close(got[f"{tag}/prefill_logits"], want["prefill_logits"], 1e-5, "logits")
        close_leaves(got[f"{tag}/prefill_state"], want["prefill_state"])


def test_cache_layouts_follow_the_policy(runs):
    """gemma-2b's one KV head cannot shard over the model axis, so its int8
    cache and scales shard their sequence; yi-6b's and qwen3's shard their
    heads. zamba2's SSD state shards its SSM heads, its conv state is
    whole."""
    got = runs[0]
    heads, seq = "(Shard(dim=1), Shard(dim=3))", "(Shard(dim=1), Shard(dim=2))"
    assert got["gemma-2b/int8/cache_placements"] == [seq] * 4
    assert got["yi-6b/int8/cache_placements"] == [heads] * 4
    assert got[f"{QWEN3}/int8/cache_placements"] == [heads] * 4
    assert got[f"{ZAMBA2}/cache_placements"] == [
        heads, heads, "(Shard(dim=2), Replicate())", "(Shard(dim=2), Shard(dim=3))"]


def test_moe_layer_gathers_no_expert_weight(runs):
    """The experts stay on their shards through the layer's forward and
    backward: no all-gather at all (the one collective is the
    load-balancing loss's scalar all-reduce), and the weights' placements
    are the ones they were given."""
    got = runs[0]
    assert [op for op, _, _ in got["moe/records"]] == ["all-reduce"]
    assert not any(op == "all-gather" and nbytes in got["moe/expert_bytes"].values()
                   for op, nbytes, _ in got["moe/records"])
    for name in ("w_up", "w_down", "w_gate"):
        assert got["moe/placements"][name] == "(Replicate(), Shard(dim=0))"
