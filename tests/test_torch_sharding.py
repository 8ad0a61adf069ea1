"""The port's sharding layer against the reference's: axis rules, the
sharding policy, the PartitionSpec and the local shard shape of every
parameter, optimizer-state and cache leaf on both production meshes, the
shape-only surface (abstract parameters, axes, cache specs, optimizer
state), the dense transformer on DTensors over two gloo ranks (with the
sequence-parallel decode on gemma-2b's sequence-sharded cache), and the
training launcher on one-rank meshes.

The reference's policy reads only a mesh's axis names and sizes, so both
sides take stand-in meshes for the specs (as ``tests/test_launch.py``
does). Local shapes come from real meshes, each side in a process of its
own: the reference's with 512 host devices (``XLA_FLAGS``, which this
process must not see), the port's over a fake process group of 512 ranks.
The cache leaves' shapes are the port's (``Model.cache_specs``; the
reference's ``jax.eval_shape`` of a full-size prefill takes seconds a
config), held to the reference's at reduced widths and at full width for
yi-6b and llama3-70b below.

The two-rank cases run ``tests/torch_mesh_worker.py`` in gloo processes
that meet through a file under ``tmp_path``; each process has its own
timeout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import types
from unittest import mock

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.configs import SHAPES_BY_NAME as REF_SHAPES  # noqa: E402
from repro.configs import ShapeCell as RefShapeCell  # noqa: E402
from repro.distributed.sharding import DEFAULT_RULES as REF_DEFAULT_RULES  # noqa: E402
from repro.distributed.sharding import AxisRules as RefAxisRules  # noqa: E402
from repro.launch import policy as ref_policy  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.training import train_loop as ref_train_loop  # noqa: E402
from repro_torch.configs import REGISTRY, SHAPES_BY_NAME, ShapeCell, get_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES,
    AxisRules,
    Layout,
    constrain,
    map_axes,
    placements,
    use_rules,
)
from repro_torch.launch import policy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import TrainConfig, abstract_train_state, opt_state_axes  # noqa: E402
from repro_torch.training.tree import flatten_with_paths, leaves, map_tree  # noqa: E402

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s, m) for a in REGISTRY for s in SHAPES_BY_NAME for m in MESHES]
OPTIMIZERS = ("adamw", "adafactor")
TIMEOUT = 120  # seconds a subprocess may take


def ref_mesh(name: str):
    sizes = MESHES[name]
    mesh = mock.MagicMock()
    mesh.shape = dict(sizes)
    mesh.axis_names = tuple(sizes)
    mesh.devices.size = int(np.prod(list(sizes.values())))
    return mesh


def port_mesh(name: str):
    sizes = MESHES[name]
    return types.SimpleNamespace(shape=tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


class _Box:
    def __init__(self, value):
        self.value = value


def port_axes_items(tree) -> dict:
    """{path: axes} of a tree of logical-axes tuples, paths spelled as
    ``jax.tree_util.keystr`` spells them."""
    return {p: b.value for p, b in flatten_with_paths(map_axes(_Box, tree))}


def ref_axes_items(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_axes)
    return {jax.tree_util.keystr(p): ax for p, ax in flat}


def cache_leaves(model: Model, cell) -> dict:
    return dict(flatten_with_paths(model.cache_specs(cell)))


# ---------------------------------------------------------------------------
# Axis rules and placements
# ---------------------------------------------------------------------------


class TestAxisRules:
    @pytest.mark.parametrize("axes", [
        ("vocab", "embed"), ("batch", "embed"), ("batch", None, "heads", None),
        ("nonexistent",), ("kv_seq", "kv_heads"), ("layers", "serve_batch", "kv_seq", None, None),
    ])
    @pytest.mark.parametrize("mesh", list(MESHES) + ["model_only"])
    def test_default_rules_spec_as_reference(self, axes, mesh):
        if mesh == "model_only":  # the reference's one-axis mesh: "pod", "data" absent
            rmesh = types.SimpleNamespace(axis_names=("model",))
            pmesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(1,))
        else:
            rmesh, pmesh = ref_mesh(mesh), port_mesh(mesh)
        assert DEFAULT_RULES.spec(axes, pmesh) == tuple(REF_DEFAULT_RULES.spec(axes, rmesh))

    def test_duplicate_mesh_axis_degrades_to_replication(self):
        rules = AxisRules(rules=(("a", "model"), ("b", "model")))
        ref = RefAxisRules(rules=(("a", "model"), ("b", "model")))
        assert rules.spec(("a", "b"), port_mesh("pod16x16")) == ("model", None)
        assert tuple(ref.spec(("a", "b"), ref_mesh("pod16x16"))) == ("model", None)

    def test_placements(self):
        mesh = port_mesh("pod2x16x16")
        assert placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
        assert placements((None, None), mesh) == (Replicate(),) * 3

    def test_placements_refuse_an_order_dtensor_cannot_express(self):
        with pytest.raises(ValueError, match="mesh's order"):
            placements((("data", "pod"),), port_mesh("pod2x16x16"))
        with pytest.raises(ValueError, match="twice"):
            placements(("model", "model"), port_mesh("pod16x16"))

    def test_layout_refuses_a_shard_that_does_not_divide(self):
        layout = Layout(port_mesh("pod16x16"), (Replicate(), Shard(0)))
        assert layout.local_shape((32, 8)) == (2, 8)
        with pytest.raises(ValueError, match="does not divide"):
            layout.local_shape((8, 8))

    def test_constrain_leaves_a_plain_tensor(self):
        x = torch.ones(2, 3)
        with use_rules(DEFAULT_RULES):
            assert constrain(x, ("batch", "embed")) is x


# ---------------------------------------------------------------------------
# The policy and every leaf's PartitionSpec, both production meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_policy_as_reference(arch, shape, mesh):
    cfg, cell = get_config(arch), SHAPES_BY_NAME[shape]
    rcfg, rcell = REF_REGISTRY[arch], REF_SHAPES[shape]
    for build, ref_build in ((policy.build_policy, ref_policy.build_policy),
                             (policy.pure_dp_policy, ref_policy.pure_dp_policy)):
        got = build(cfg, cell, port_mesh(mesh)).describe()
        want = ref_build(rcfg, rcell, ref_mesh(mesh)).describe()
        assert got == want


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_leaf_specs_as_reference(arch, shape, mesh):
    """Parameters, both optimizers' states and the decode cache in either
    layout: the port's spec of every leaf equals the reference's."""
    cfg, cell = get_config(arch), SHAPES_BY_NAME[shape]
    pmesh, rmesh = port_mesh(mesh), ref_mesh(mesh)
    pol = policy.build_policy(cfg, cell, pmesh)
    rrules = ref_policy.build_policy(REF_REGISTRY[arch], REF_SHAPES[shape], rmesh).rules
    model, rmodel = Model(cfg), ref_zoo.Model(REF_REGISTRY[arch])

    def check(port_tree, ref_tree):
        got, want = port_axes_items(port_tree), ref_axes_items(ref_tree)
        assert list(got) == list(want)
        for path, axes in got.items():
            assert axes == want[path], path
            assert pol.rules.spec(axes, pmesh) == tuple(rrules.spec(want[path], rmesh)), path

    check(model.axes(), rmodel.axes())
    for opt in OPTIMIZERS:
        check(opt_state_axes(model, TrainConfig(optimizer=opt)),
              ref_train_loop.opt_state_axes(rmodel, ref_train_loop.TrainConfig(optimizer=opt)))
    for shardable in (True, False):
        got = model.cache_axes(cell, kv_shardable=shardable)
        want = {p: ref_zoo._cache_leaf_axes(t, REF_REGISTRY[arch], shardable)
                for p, t in cache_leaves(model, cell).items()}
        assert port_axes_items(got) == want
        for axes in want.values():
            assert pol.rules.spec(axes, pmesh) == tuple(rrules.spec(axes, rmesh))


# ---------------------------------------------------------------------------
# Local shard shapes on real meshes (each side in a process of its own)
# ---------------------------------------------------------------------------

_COMMON = """
import json, sys
from repro_torch.configs import REGISTRY, SHAPES_BY_NAME
from repro_torch.models import Model as PortModel
from repro_torch.training.tree import flatten_with_paths
ADAFACTOR_THRESHOLD = 4e10
KV_DTYPES = {"cache": "bf16", "cache_int8": "int8"}
def kv_dtypes(cfg):  # the families with a transformer KV cache keep an int8 one too
    return KV_DTYPES if cfg.family not in ("hybrid", "ssm") else {"cache": "bf16"}
def cache_shapes(cfg, cell, kv_dtype="bf16"):
    return {p: tuple(t.shape) for p, t in flatten_with_paths(PortModel(cfg, kv_dtype=kv_dtype).cache_specs(cell))}
out = {}
"""

_REF_SCRIPT = _COMMON + """
import jax
from jax.sharding import NamedSharding
from repro.configs import REGISTRY as RR
from repro.launch.policy import build_policy
from repro.models import model_zoo
from repro.training import train_loop
meshes = {"pod16x16": jax.make_mesh((16, 16), ("data", "model"), devices=jax.devices()[:256]),
          "pod2x16x16": jax.make_mesh((2, 16, 16), ("pod", "data", "model"))}
is_axes = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
def items(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): v for p, v in flat}
def local(mesh, rules, axes, shapes):
    return {p: list(NamedSharding(mesh, rules.spec(ax, mesh)).shard_shape(tuple(shapes[p])))
            for p, ax in axes.items()}
for name in REGISTRY:
    model = model_zoo.Model(RR[name])
    p_shapes = {p: s.shape for p, s in items(model.abstract()).items()}
    for shape, cell in SHAPES_BY_NAME.items():
        for mname, mesh in meshes.items():
            pol = build_policy(RR[name], cell, mesh)
            rec = {"params": local(mesh, pol.rules, items(model.axes(), is_axes), p_shapes)}
            opt = "adafactor" if model.param_count() > ADAFACTOR_THRESHOLD else "adamw"
            tcfg = train_loop.TrainConfig(optimizer=opt)
            _, o_abs = train_loop.abstract_train_state(model, tcfg)
            o_shapes = {p: s.shape for p, s in items(o_abs).items()}
            rec["opt"] = local(mesh, pol.rules, items(train_loop.opt_state_axes(model, tcfg), is_axes),
                               o_shapes)
            for key, kv_dtype in kv_dtypes(REGISTRY[name]).items():
                shapes = cache_shapes(REGISTRY[name], cell, kv_dtype)
                axes = {p: model_zoo._cache_leaf_axes(type("Leaf", (), {"shape": s}), RR[name],
                                                      pol.kv_heads_sharded) for p, s in shapes.items()}
                rec[key] = local(mesh, pol.rules, axes, shapes)
            out[f"{name}/{shape}/{mname}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""

_PORT_SCRIPT = _COMMON + """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.sharding import distribute_tree, tree_placements
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.policy import build_policy
from repro_torch.training import TrainConfig, abstract_train_state, opt_state_axes
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
meshes = {"pod16x16": make_production_mesh(), "pod2x16x16": make_production_mesh(multi_pod=True)}
def local(tree):
    return {p: list(t.to_local().shape) for p, t in flatten_with_paths(tree)}
for name, cfg in REGISTRY.items():
    model = PortModel(cfg)
    for shape, cell in SHAPES_BY_NAME.items():
        for mname, mesh in meshes.items():
            pol = build_policy(cfg, cell, mesh)
            rec = {"params": local(distribute_tree(model.abstract(), tree_placements(model.axes(), mesh, pol.rules)))}
            opt = "adafactor" if model.param_count() > ADAFACTOR_THRESHOLD else "adamw"
            tcfg = TrainConfig(optimizer=opt)
            _, o_abs = abstract_train_state(model, tcfg)
            rec["opt"] = local(distribute_tree(o_abs, tree_placements(opt_state_axes(model, tcfg), mesh, pol.rules)))
            for key, kv_dtype in kv_dtypes(cfg).items():
                m = PortModel(cfg, kv_dtype=kv_dtype)
                axes = m.cache_axes(cell, kv_shardable=pol.kv_heads_sharded)
                rec[key] = local(distribute_tree(m.cache_specs(cell), tree_placements(axes, mesh, pol.rules)))
            out[f"{name}/{shape}/{mname}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


def test_local_shapes_as_reference(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    procs = {}
    for side, code, e in (("ref", _REF_SCRIPT, ref_env), ("port", _PORT_SCRIPT, env)):
        out = str(tmp_path / f"{side}.json")
        procs[side] = (subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), out],
                                        env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), out)
    got = {}
    for side, (proc, out) in procs.items():
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        with open(out) as f:
            got[side] = json.load(f)
    assert len(got["port"]) == len(CELLS)
    assert "cache_int8" in got["port"]["yi-6b/decode_32k/pod16x16"]
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# The shape-only surface
# ---------------------------------------------------------------------------

SURFACE = [(a, True) for a in REGISTRY] + [("yi-6b", False), ("llama3-70b", False)]


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def struct(tree) -> dict:
    return {p: (tuple(t.shape), dtype_name(t.dtype)) for p, t in flatten_with_paths(tree)}


def ref_struct(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype)) for p, t in flat}


@pytest.mark.parametrize("arch,reduced", SURFACE)
def test_abstract_surface_as_reference(arch, reduced):
    cfg, rcfg = get_config(arch), REF_REGISTRY[arch]
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
        cell = ShapeCell("surface", "decode", 64, 2)
    else:
        cell = SHAPES_BY_NAME["decode_32k"]
    model, rmodel = Model(cfg), ref_zoo.Model(rcfg)
    assert struct(model.abstract()) == ref_struct(rmodel.abstract())
    assert port_axes_items(model.axes()) == ref_axes_items(rmodel.axes())
    assert all(t.device.type == "meta" for t in leaves(model.abstract()))

    rcell = RefShapeCell(cell.name, cell.kind, cell.seq_len, cell.global_batch)
    ref_cache = rmodel.cache_specs(rcell)
    got = struct(model.cache_specs(cell))
    if isinstance(ref_cache, dict) and "moe_block" in ref_cache:
        # MoE: the reference keeps a (k, v) pair a block kind, the port one
        # layer-ordered pair of both (maverick interleaves dense and MoE)
        kinds = [ref_cache[k] for k in ("dense_block", "moe_block") if k in ref_cache]
        want = {f"[{i}]": ((sum(t.shape[0] for t in leaf), *leaf[0].shape[1:]), str(leaf[0].dtype))
                for i, leaf in enumerate(zip(*kinds))}
    else:
        want = ref_struct(ref_cache)
    assert got == want
    for shardable in (True, False):
        ref_axes = jax.tree.map(lambda t: ref_zoo._cache_leaf_axes(t, rcfg, shardable), ref_cache)
        got_axes = set(port_axes_items(model.cache_axes(cell, kv_shardable=shardable)).values())
        assert got_axes == set(ref_axes_items(ref_axes).values())

    for opt in OPTIMIZERS:
        tcfg, rtcfg = TrainConfig(optimizer=opt), ref_train_loop.TrainConfig(optimizer=opt)
        _, o_abs = abstract_train_state(model, tcfg)
        _, ro_abs = ref_train_loop.abstract_train_state(rmodel, rtcfg)
        assert struct(o_abs) == ref_struct(ro_abs)
        assert (port_axes_items(opt_state_axes(model, tcfg))
                == ref_axes_items(ref_train_loop.opt_state_axes(rmodel, rtcfg)))


# ---------------------------------------------------------------------------
# The dense transformer on DTensors over two gloo ranks
# ---------------------------------------------------------------------------

sys.path.insert(0, TESTS)
import torch_mesh_worker as worker  # noqa: E402


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    world2 = worker.run_ranks("world2", 2, out)
    world1 = worker.run_ranks("world1", 1, out)
    return world2, world1[0]


def reference_loss_and_grads(arch: str, params: dict, batch: dict) -> tuple:
    """The reference's loss and gradients ({path: array}) on the same f32
    parameters and batch."""
    rmodel = ref_zoo.Model(REF_REGISTRY[arch].reduced())
    jp = map_tree(lambda t: jax.numpy.asarray(t.detach().numpy()), params)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rmodel.loss(p, jb)[0]))(jp)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    return (torch.from_numpy(np.array(loss)),
            {jax.tree_util.keystr(p): torch.from_numpy(np.array(g)) for p, g in flat})


@pytest.mark.parametrize("arch", worker.ARCHS)
def test_loss_and_grads_match_one_process(mesh_runs, arch):
    """The two ranks' loss and gradients against one plain process and
    against the reference on the same f32 parameters and batch."""
    world2, _ = mesh_runs
    model = Model(get_config(arch).reduced())
    params = worker.f32_params(model)
    batch = worker.train_batch(model.cfg)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params))
    ref_loss, ref_grads = reference_loss_and_grads(arch, params, batch)
    paths = [path for path, _ in flatten_with_paths(params)]
    assert set(paths) == set(ref_grads)
    for got in world2:  # each rank gathered the same whole values
        for want, what in ((loss.detach(), "one process"), (ref_loss, "reference")):
            worker.close(got[f"{arch}/loss"], want, 1e-5, f"loss against the {what}")
        for path, g in zip(paths, grads):
            worker.close(got[f"{arch}/grad{path}"], g, 1e-5, f"{path} against one process")
            worker.close(got[f"{arch}/grad{path}"], ref_grads[path], 1e-5, f"{path} against the reference")


@pytest.mark.parametrize("arch", worker.ARCHS)
def test_decode_on_a_sharded_cache_matches_one_process(mesh_runs, arch):
    world2, _ = mesh_runs
    model = Model(get_config(arch).reduced())
    cache, batch = worker.decode_inputs(model)
    with torch.no_grad():
        logits, cache = model.decode_step(worker.f32_params(model), cache, batch)
    for got in world2:
        worker.close(got[f"{arch}/decode_logits"], logits, 1e-5, "logits")
        for g, want in zip(got[f"{arch}/decode_cache"], cache):
            # a head-sharded projection sums in another order, which may
            # round the written K/V to the neighbouring bf16 value
            worker.close(g, want, 2 ** -8, "cache")


def test_sequence_sharded_decode_gathers_no_cache_layer(mesh_runs):
    """gemma-2b's decode step on its sequence-sharded cache runs the paged
    kernel on each rank's positions: its collectives (``CommCounter``)
    hold all-reduces and no all-gather as large as one layer's K or V
    leaf (q's heads are all that is gathered)."""
    world2, _ = mesh_runs
    cfg = get_config("gemma-2b").reduced()
    layer = worker.DECODE.global_batch * worker.DECODE.seq_len * cfg.n_kv_heads * cfg.head_dim * 2
    for got in world2:
        records = got["gemma-2b/decode_records"]
        assert any(op == "all-reduce" for op, _, _ in records)
        gathers = [nbytes for op, nbytes, _ in records if op == "all-gather"]
        assert all(nbytes < layer for nbytes in gathers), (gathers, layer)


def test_partial_lse_combine_equals_the_unsharded_softmax(mesh_runs):
    """Each rank's partial output and lse over its half of the sequence
    (one slot has no position in the second half: lse -inf, output 0),
    merged by ``combine_partials``, and the sharded path's output, equal
    the softmax over the whole cache (the plain version, one process)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import combine_partials

    world2, _ = mesh_runs
    q, k, v, lengths = world2[0]["combine/inputs"]
    want, want_lse = ops._paged_over_slots(q[:, 0], k, v, lengths, return_lse=True)
    (o0, lse0), (o1, lse1) = (got["combine/partial"] for got in world2)
    assert torch.isneginf(lse1[1]).all() and not o1[1].any()

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    out, lse = combine_partials(torch.stack([o0, o1]), torch.stack([lse0, lse1]), stacked)
    worker.close(out, want, 1e-6, "combined output")
    worker.close(lse, want_lse, 1e-6, "combined lse")
    for got in world2:
        worker.close(got["combine/out"][:, 0], want, 1e-6, "sharded path")


def test_cache_layouts(mesh_runs):
    """gemma-2b's one KV head cannot shard over the model axis, so its
    cache shards its sequence (``kv_seq``); yi-6b's shards its heads."""
    world2, _ = mesh_runs
    assert world2[0]["gemma-2b/cache_placements"][0] == "(Shard(dim=1), Shard(dim=2))"
    assert world2[0]["yi-6b/cache_placements"][0] == "(Shard(dim=1), Shard(dim=3))"


def test_checkpoint_saved_at_world_2_restores_at_world_1(mesh_runs):
    world2, world1 = mesh_runs
    want = world2[0]["ckpt/next_loss"]
    assert world1["ckpt/placements"] == "(Replicate(), Replicate())"
    assert abs(world1["ckpt/next_loss"].item() - want.item()) <= 1e-6 * abs(want.item())


def test_launcher_on_a_mesh_matches_one_device(mesh_runs, tmp_path):
    from repro_torch.launch.train import train

    _, world1 = mesh_runs
    plain = train("yi-6b", ckpt_dir=str(tmp_path / "plain"), **worker.LAUNCH)
    worker.close(world1["launch/losses"], torch.tensor(plain["losses"]), 1e-5, "launcher losses")


def test_launcher_takes_a_config_as_it_is(tmp_path):
    """``train`` given a config trains that config (as a depth-cut one is
    given), the same as given its name."""
    from repro_torch.launch.train import train

    by_name = train("yi-6b", ckpt_dir=str(tmp_path / "name"), **worker.LAUNCH)
    by_cfg = train(get_config("yi-6b").reduced(), ckpt_dir=str(tmp_path / "cfg"), **worker.LAUNCH)
    assert by_cfg["losses"] == by_name["losses"]


def test_launcher_refuses_the_families_not_yet_sharded(tmp_path):
    """No family is refused any more: ``train("xlstm-350m")`` on a one-rank
    gloo group (the mesh path: DTensors, its mLSTM and sLSTM cells on their
    one shard of heads) gives the plain launcher's losses."""
    import torch.distributed as dist
    from repro_torch.launch.train import train

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = train("xlstm-350m", ckpt_dir=str(tmp_path / "mesh"), **worker.LAUNCH)
    finally:
        dist.destroy_process_group()
    plain = train("xlstm-350m", ckpt_dir=str(tmp_path / "plain"), **worker.LAUNCH)
    worker.close(torch.tensor(mesh["losses"]), torch.tensor(plain["losses"]), 1e-5,
                 "launcher losses")


def test_launcher_trains_the_hybrid_on_a_one_rank_mesh(tmp_path):
    """``train("zamba2-2.7b")`` on a one-rank gloo group (the mesh path:
    DTensors, its SSM heads on their one shard) gives the plain launcher's
    losses."""
    import torch.distributed as dist
    from repro_torch.launch.train import train

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = train("zamba2-2.7b", ckpt_dir=str(tmp_path / "mesh"), **worker.LAUNCH)
    finally:
        dist.destroy_process_group()
    plain = train("zamba2-2.7b", ckpt_dir=str(tmp_path / "plain"), **worker.LAUNCH)
    worker.close(torch.tensor(mesh["losses"]), torch.tensor(plain["losses"]), 1e-5,
                 "launcher losses")
