"""The xLSTM, vlm and audio families on DTensors over two gloo ranks (a
1 x 2 mesh, ``tests/torch_mesh_worker.py``'s ``families3`` phase, one
launch for every case), against one plain process and the reference, at
reduced widths with f32 parameters:

* reduced xlstm-350m (its 4 heads sharded; a training batch of 2 x 64
  tokens, so the up-projection reorders its weight, and a decode step
  that gathers the product instead), qwen2-vl-7b (M-RoPE, the embeddings frontend) and
  musicgen-medium (cross-attention, four codebook heads): the loss and
  every gradient leaf within 1e-5 of one process and within
  ``tests/test_torch_loss.py``'s 1e-4 relative L2 a leaf of the
  reference's ``jax.value_and_grad``;
* each decode step's and each prefill's logits within 1e-5 of one
  process, the caches and states within 2**-8;
* musicgen's decode step once more with its self and cross caches laid out
  along their sequence (``kv_shardable=False``): the sequence-parallel
  paged decode, within 1e-5, with no all-gather as large as a cache
  layer.
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
from test_torch_sharding_families import close_leaves  # noqa: E402

FAMILIES = worker.FAMILIES3
MUSICGEN = "musicgen-medium"
#: Per-leaf relative L2 the gradients keep from the reference's
#: (``tests/test_torch_loss.py``'s f32 tolerance).
REF_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The one-process and reference cases run many small ops beside the
    test run's other workers; one intra-op thread keeps them from
    contending for the cores (as ``tests/test_torch_training.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worker.run_ranks("families3", 2, tmp_path_factory.mktemp("families3"))


@pytest.fixture(scope="module")
def plain():
    """Each family's case on plain tensors in this process, by arch."""
    return {arch: one_process(arch) for arch in FAMILIES}


def one_process(arch: str) -> dict:
    model = Model(get_config(arch).reduced())
    params = worker.f32_params(model)
    out = {"params": params}
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
        out["prefill_logits"], state = model.prefill(params, worker.prompt_batch(model.cfg))
    out["cache"], out["prefill_state"] = leaves(cache), leaves(state)
    return out


def reference_loss_and_grads(arch: str, params: dict) -> tuple:
    """The reference's loss and gradients on the same parameters and batch:
    embeddings in f32 (the model's dtype), the memory in bf16 (as the
    reference's ``input_specs`` has it)."""
    rmodel = ref_zoo.Model(REF_REGISTRY[arch].reduced())
    jp = map_tree(lambda t: jax.numpy.asarray(t.detach().numpy()), params)
    batch = worker.train_batch(get_config(arch).reduced())
    jb = {k: jax.numpy.asarray(v.float().numpy()).astype(jax.numpy.bfloat16) if k == "memory"
          else jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rmodel.loss(p, jb)[0]))(jp)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    return (torch.from_numpy(np.array(loss)),
            {jax.tree_util.keystr(p): torch.from_numpy(np.array(g)) for p, g in flat})


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_one_process(runs, plain, arch):
    want = plain[arch]
    for got in runs:  # each rank gathered the same whole values
        worker.close(got[f"{arch}/loss"], want["loss"], 1e-5, "loss")
        for path, g in want["grads"].items():
            worker.close(got[f"{arch}/grad{path}"], g, 1e-5, path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(runs, plain, arch):
    ref_loss, ref_grads = reference_loss_and_grads(arch, plain[arch]["params"])
    got = runs[0]
    worker.close(got[f"{arch}/loss"], ref_loss, 1e-5, "loss")
    paths = [k.removeprefix(f"{arch}/grad") for k in got if k.startswith(f"{arch}/grad")]
    assert set(paths) == set(ref_grads)
    for path in paths:
        g, want = got[f"{arch}/grad{path}"], ref_grads[path]
        err = ((g - want).norm() / want.norm().clamp_min(1e-30)).item()
        assert err <= REF_REL, f"{path}: rel L2 {err}"


@pytest.mark.parametrize("tag", [*FAMILIES, worker.KV_SEQ])
def test_decode_matches_one_process(runs, plain, tag):
    want = plain[tag.split("/")[0]]
    for got in runs:
        worker.close(got[f"{tag}/decode_logits"], want["logits"], 1e-5, "logits")
        close_leaves(got[f"{tag}/decode_cache"], want["cache"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_one_process(runs, plain, arch):
    """A prefill on the mesh (the xLSTM's cells on head shards, M-RoPE's
    tables replicated, the cross-attention's memory K/V on head shards):
    logits within 1e-5 of one process, the state as the decode's cache."""
    want = plain[arch]
    for got in runs:
        worker.close(got[f"{arch}/prefill_logits"], want["prefill_logits"], 1e-5, "logits")
        close_leaves(got[f"{arch}/prefill_state"], want["prefill_state"])


def test_cache_layouts(runs):
    """The xLSTM's decode state keeps its heads whole (the reference's cache
    rule); musicgen's self and cross caches shard their heads, or, placed
    ``kv_shardable=False``, their sequence."""
    got = runs[0]
    heads, seq = "(Shard(dim=1), Shard(dim=3))", "(Shard(dim=1), Shard(dim=2))"
    assert got[f"{MUSICGEN}/cache_placements"] == [heads] * 4
    assert got[f"{worker.KV_SEQ}/cache_placements"] == [seq] * 4
    assert set(got["xlstm-350m/cache_placements"]) == {"(Shard(dim=2), Replicate())",
                                                       "(Shard(dim=1), Replicate())"}


def test_sequence_sharded_decode_gathers_no_cache_layer(runs):
    """The sequence-parallel decode moves q-sized and output-sized tensors,
    not the cache: no all-gather is as large as one layer's cache leaf
    (musicgen's cross cache, the smaller)."""
    cfg = get_config(MUSICGEN).reduced()
    layer = 2 * worker.DECODE.global_batch * cfg.cross_mem_len * cfg.n_kv_heads * cfg.head_dim
    records = runs[0][f"{worker.KV_SEQ}/decode_records"]
    assert any(op == "all-reduce" for op, _, _ in records)
    gathers = [nbytes for op, nbytes, _ in records if op == "all-gather"]
    assert all(nbytes < layer for nbytes in gathers), (gathers, layer)
