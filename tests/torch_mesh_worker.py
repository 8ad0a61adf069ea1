"""One rank of the multi-process cases of ``tests/test_torch_sharding.py``
and ``tests/test_torch_collectives.py``: a gloo process group on the CPU,
rendezvous through a file, results saved with ``torch.save`` for the test
to compare with its single-process runs.

    python tests/torch_mesh_worker.py --phase world2 --rank 0 --world 2 \\
        --init <file> --out <dir>

``world2`` (two ranks on a 1 x 2 mesh): the losses and gradients, and a
decode step on a placed cache (and its collectives), of reduced yi-6b and
gemma-2b with f32 parameters; decode attention over a sequence-sharded
cache, each rank's partials and their combine; three AdamW steps of
reduced yi-6b, a checkpoint, and the next step's loss. ``world1`` (one
rank): that checkpoint restored onto a 1 x 1 mesh through
``placements=`` and the next step's loss; the training
launcher on the mesh. ``collectives`` (any world): two rounds of
``compressed_all_reduce`` over the world. ``families2`` (two ranks on a
1 x 2 mesh): the MoE and hybrid families (reduced qwen3-235b-a22b, at
``moe_group`` 1 and the default, and zamba2-2.7b, f32 parameters): the
loss and gradients, a decode step and a prefill; a decode step and a
prefill on an int8 KV cache of yi-6b, gemma-2b and qwen3; the collectives
one MoE layer's forward and backward issue. ``families3`` (two ranks on a
1 x 2 mesh): the xLSTM, vlm and audio families (reduced xlstm-350m, at a
longer training batch, qwen2-vl-7b and musicgen-medium, f32 parameters):
the loss and gradients, a decode step and a prefill; musicgen's decode
step again with its caches laid out along their sequence on the model
axis.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeCell, get_config
from repro_torch.distributed.collectives import compressed_all_reduce
from repro_torch.distributed.sharding import (
    AxisRules,
    Layout,
    distribute_tree,
    tree_placements,
    use_rules,
)
from repro_torch.kernels import ops
from repro_torch.launch.comm_count import CommCounter
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.policy import build_policy
from repro_torch.launch.train import train
from repro_torch.models import Model
from repro_torch.models.moe import moe_layer
from repro_torch.training import TrainConfig, make_train_step, opt_state_axes
from repro_torch.training.tree import flatten_with_paths, leaves, map_tree

ARCHS = ("yi-6b", "gemma-2b")
#: ``families2``'s cases: tag → (arch, Model keywords); ``INT8`` the int8
#: KV cache's.
FAMILIES = {"qwen3-235b-a22b": ("qwen3-235b-a22b", {}),
            "qwen3-235b-a22b/group1": ("qwen3-235b-a22b", {"moe_group": 1}),
            "zamba2-2.7b": ("zamba2-2.7b", {})}
INT8 = {f"{a}/int8": (a, {"kv_dtype": "int8"}) for a in ("yi-6b", "gemma-2b", "qwen3-235b-a22b")}
#: ``families3``'s cases.
FAMILIES3 = ("xlstm-350m", "qwen2-vl-7b", "musicgen-medium")
#: musicgen's decode step on caches sharded along their sequence.
KV_SEQ = "musicgen-medium/kv_seq"
TRAIN = ShapeCell("mesh_train", "train", 16, 2)
#: The xLSTM's training and prefill batch: enough tokens (B x L >= its
#: reduced d_model) that its up-projection reorders the weight on
#: DTensors; the decode step gathers the product instead.
TRAIN_XLSTM = ShapeCell("mesh_train_xlstm", "train", 64, 2)
DECODE = ShapeCell("mesh_decode", "decode", 32, 2)
DECODE_INDEX = (20, 5)  # one position in each half of the 32-position cache
CKPT_STEPS = 3
TCFG = TrainConfig(total_steps=8, warmup_steps=1)
#: The launcher's run on the mesh (``world1``) and the test's plain run.
LAUNCH = dict(steps=2, seq_len=32, global_batch=4, device="cpu", ckpt_every=100, log_every=100)


def f32_params(model: Model) -> dict:
    """Seeded parameters in f32, every w_q and w_k tempered by 0.1 as the
    repo's comparisons do (the reference's init leaves attention near
    arg-max, where f32 rounding of a reordered sum is amplified ~1e3
    times), the hybrid's LoRA ``b_*`` (zero at init) drawn nonzero."""
    params = map_tree(lambda t: t.float(), model.init(0, device="cpu"))
    rng = np.random.default_rng(7)
    for path, t in flatten_with_paths(params):
        if path.endswith(("['w_q']", "['w_k']")):
            t.mul_(0.1)
        elif path.startswith("['lora']['b_"):
            t.copy_(torch.as_tensor(rng.normal(0.0, 0.05, t.shape), dtype=t.dtype))
    return params


def train_cell(cfg) -> ShapeCell:
    return TRAIN_XLSTM if cfg.family == "ssm" else TRAIN


def bf16_values(rng, shape, scale: float = 0.1) -> torch.Tensor:
    """Normal values of std ``scale`` rounded to bf16, held in f32."""
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32) \
        .to(torch.bfloat16).float()


def train_batch(cfg, seed: int = 0) -> dict:
    """Tokens and next-token labels; for the embeddings frontend, embeddings
    of std 0.1 (bf16 values), M-RoPE's arange positions, the conditioning
    memory in bf16 and labels (one a codebook)."""
    rng = np.random.default_rng(seed)
    cell = train_cell(cfg)
    b, length = cell.global_batch, cell.seq_len
    if cfg.frontend == "tokens":
        toks = rng.integers(0, cfg.vocab, size=(b, length + 1))
        return {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
                "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}
    batch = {"embeds": bf16_values(rng, (b, length, cfg.d_model))}
    if cfg.pos_type == "mrope":
        batch["positions"] = torch.arange(length, dtype=torch.int32).expand(3, b, length).clone()
    if cfg.cross_attention:
        batch["memory"] = bf16_values(rng, (b, cfg.cross_mem_len, cfg.d_model)).bfloat16()
    labels = (b, length, cfg.n_codebooks) if cfg.n_codebooks else (b, length)
    batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab, labels), dtype=torch.int32)
    return batch


def prompt_batch(cfg) -> dict:
    """The training batch without its labels (a prefill's inputs)."""
    return {k: v for k, v in train_batch(cfg).items() if k != "labels"}


def decode_inputs(model: Model) -> tuple:
    """A cache of seeded values (int8 codes in [-127, 127] and f16 scales in
    [0.005, 0.02] for an int8 cache, normal values otherwise) and one decode
    step's batch (tokens, or embeddings and M-RoPE's positions, one column
    a slot at its index)."""
    rng = np.random.default_rng(1)

    def draw(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.int8:
            return torch.as_tensor(rng.integers(-127, 128, t.shape), dtype=torch.int8)
        if t.dtype == torch.float16:
            return torch.as_tensor(rng.uniform(0.005, 0.02, t.shape), dtype=torch.float16)
        return torch.as_tensor(rng.normal(size=t.shape), dtype=torch.float32).to(t.dtype)

    cache = map_tree(draw, model.cache_specs(DECODE))
    cfg = model.cfg
    index = torch.tensor(DECODE_INDEX, dtype=torch.int32)
    if cfg.frontend == "tokens":
        toks = rng.integers(0, cfg.vocab, size=(DECODE.global_batch, 1))
        return cache, {"tokens": torch.as_tensor(toks, dtype=torch.int32), "index": index}
    batch = {"embeds": bf16_values(rng, (DECODE.global_batch, 1, cfg.d_model)), "index": index}
    if cfg.pos_type == "mrope":
        batch["positions"] = index[None, :, None].expand(3, -1, 1).clone()
    return cache, batch


def full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def model_case(mesh, arch: str, out: dict, tag: str = "", train: bool = True,
               prefill: bool = False, kv_seq: bool = False, **model_kw) -> None:
    """``arch``'s loss and gradients (unless ``train`` is False), a decode
    step on a placed cache (laid out as the policy says, or with ``kv_seq``
    along its sequence on the model axis, as a model axis its KV heads do
    not divide lays it out) and, with ``prefill``, a prefill, each gathered
    whole, under ``tag``; the decode step's collectives as ``CommCounter``
    records them."""
    tag = tag or arch
    cfg = get_config(arch).reduced()
    model = Model(cfg, **model_kw)
    plain = f32_params(model)
    if train:
        train_case(mesh, model, plain, tag, out)
    policy = build_policy(cfg, DECODE, mesh)
    rules = policy.rules
    if kv_seq:
        rules = AxisRules(tuple((name, "model" if name == "kv_seq" else target)
                                for name, target in rules.rules))
    cache, batch = decode_inputs(model)
    cache_axes = model.cache_axes(DECODE, kv_shardable=policy.kv_heads_sharded and not kv_seq)
    cache = distribute_tree(cache, tree_placements(cache_axes, mesh, rules))
    out[f"{tag}/cache_placements"] = [str(t.placements) for t in leaves(cache)]
    params = distribute_tree(plain, tree_placements(model.axes(), mesh, rules))
    axes = model.input_axes(DECODE)
    batch = distribute_tree(batch, tree_placements({k: axes[k] for k in batch}, mesh, rules))
    with use_rules(rules), torch.no_grad(), CommCounter() as counter:
        logits, cache = model.decode_step(params, cache, batch)
    out[f"{tag}/decode_records"] = counter.records
    out[f"{tag}/decode_logits"] = full(logits)
    out[f"{tag}/decode_cache"] = [full(t) for t in leaves(cache)]
    if prefill:
        prefill_case(mesh, model, plain, tag, out)


def prefill_case(mesh, model: Model, plain: dict, tag: str, out: dict) -> None:
    """A prefill of the training batch's prompts on the mesh: its logits
    and decode state, gathered whole."""
    cell = train_cell(model.cfg)
    cell = ShapeCell("mesh_prefill", "prefill", cell.seq_len, cell.global_batch)
    rules = build_policy(model.cfg, cell, mesh).rules
    params = distribute_tree(plain, tree_placements(model.axes(), mesh, rules))
    batch = distribute_tree(prompt_batch(model.cfg),
                            tree_placements(model.input_axes(cell), mesh, rules))
    with use_rules(rules), torch.no_grad():
        logits, state = model.prefill(params, batch)
    out[f"{tag}/prefill_logits"] = full(logits)
    out[f"{tag}/prefill_state"] = [full(t) for t in leaves(state)]


def train_case(mesh, model: Model, plain: dict, tag: str, out: dict) -> None:
    cfg = model.cfg
    cell = train_cell(cfg)
    rules = build_policy(cfg, cell, mesh).rules
    params = distribute_tree(plain, tree_placements(model.axes(), mesh, rules))
    p_leaves = leaves(params)
    for p in p_leaves:
        p.requires_grad_(True)
    batch = distribute_tree(train_batch(cfg), tree_placements(model.input_axes(cell), mesh, rules))
    with use_rules(rules):
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, p_leaves)
    out[f"{tag}/loss"] = full(loss).detach()
    for (path, _), g in zip(flatten_with_paths(params), grads):
        out[f"{tag}/grad{path}"] = full(g)


def combine_case(mesh, out: dict) -> None:
    """Decode attention over one layer's cache (gemma-2b's reduced widths:
    4 query heads, one KV head) sharded along its sequence: each rank's
    partial output and lse on its own positions (lengths DECODE_INDEX + 1,
    so one slot has none in the second half), and the sharded path's
    output, gathered whole."""
    rng = np.random.default_rng(5)
    b, s, h, d = DECODE.global_batch, DECODE.seq_len, 4, 32
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)), dtype=torch.float32)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, 1, d)), dtype=torch.float32)
            for _ in range(2))
    lengths = torch.tensor(DECODE_INDEX, dtype=torch.int32) + 1
    out["combine/inputs"] = (q, k, v, lengths)
    whole, seq = Layout(mesh, (Replicate(), Replicate())), Layout(mesh, (Replicate(), Shard(1)))
    kd, vd = seq.place(k), seq.place(v)
    s_local = kd.to_local().shape[1]
    first = mesh.get_local_rank(1) * s_local
    out["combine/partial"] = ops._paged_over_slots(
        q[:, 0], kd.to_local(), vd.to_local(), (lengths - first).clamp(0, s_local).int(),
        return_lse=True)
    out["combine/out"] = full(ops.slot_decode_attention(whole.place(q), kd, vd,
                                                        whole.place(lengths)))


def moe_comms_case(mesh, out: dict) -> None:
    """One MoE layer of reduced qwen3's forward and backward under
    ``CommCounter``: every collective's (op, bytes, group size), the
    bytes of each expert weight, and their placements after."""
    model = Model(get_config("qwen3-235b-a22b").reduced())
    rules = build_policy(model.cfg, TRAIN, mesh).rules
    params = distribute_tree(f32_params(model), tree_placements(model.axes(), mesh, rules))
    moe = {k: v[0].detach().requires_grad_(True) if not isinstance(v, dict) else v
           for k, v in params["blocks"]["moe_block"]["moe"].items()}
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(TRAIN.global_batch, TRAIN.seq_len,
                                                               model.cfg.d_model)),
                        dtype=torch.float32)
    x = distribute_tree(x, tree_placements(("batch", None, "embed"), mesh, rules))
    cfg = model.cfg
    with use_rules(rules), CommCounter() as counter:
        y, aux = moe_layer(x, moe, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           activation=cfg.activation)
        torch.autograd.grad((y.sum() + aux), [moe["w_up"], moe["w_down"], moe["w_gate"]])
    out["moe/records"] = counter.records
    out["moe/expert_bytes"] = {k: v.numel() * v.element_size() for k, v in moe.items()
                               if k.startswith("w_")}
    out["moe/placements"] = {k: str(v.placements) for k, v in moe.items()}


def train_state(mesh, model: Model):
    step_fn, opt = make_train_step(model, TCFG)
    plain = f32_params(model)
    rules = build_policy(model.cfg, TRAIN, mesh).rules
    placed = {"p": tree_placements(model.axes(), mesh, rules),
              "o": tree_placements(opt_state_axes(model, TCFG), mesh, rules)}
    b_layout = tree_placements(model.input_axes(TRAIN), mesh, rules)
    return step_fn, opt, plain, rules, placed, b_layout


def ckpt_case(mesh, ckpt_dir: str, out: dict) -> None:
    """Three steps, a checkpoint, and the loss of the step after it."""
    model = Model(get_config("yi-6b").reduced())
    step_fn, opt, plain, rules, placed, b_layout = train_state(mesh, model)
    params = distribute_tree(plain, placed["p"])
    opt_state = distribute_tree(opt.init(plain), placed["o"])
    with use_rules(rules):
        for i in range(CKPT_STEPS + 1):
            if i == CKPT_STEPS:
                Checkpointer(ckpt_dir).save(i, {"p": params, "o": opt_state})
            batch = distribute_tree(train_batch(model.cfg, i), b_layout)
            params, opt_state, metrics = step_fn(params, opt_state, batch, i)
    out["ckpt/next_loss"] = full(metrics["loss"])


def restore_case(mesh, ckpt_dir: str, out: dict) -> None:
    """The checkpoint restored onto this mesh, then the step after it."""
    model = Model(get_config("yi-6b").reduced())
    step_fn, opt, plain, rules, placed, b_layout = train_state(mesh, model)
    state, _ = Checkpointer(ckpt_dir).restore({"p": plain, "o": opt.init(plain)},
                                              placements=placed)
    out["ckpt/placements"] = str(leaves(state["p"])[0].placements)
    batch = distribute_tree(train_batch(model.cfg, CKPT_STEPS), b_layout)
    with use_rules(rules):
        _, _, metrics = step_fn(state["p"], state["o"], batch, CKPT_STEPS)
    out["ckpt/next_loss"] = full(metrics["loss"])


def collectives_case(out: dict) -> None:
    """Two rounds of ``compressed_all_reduce`` over the world, each rank
    with its own seeded gradient in f32 and bf16."""
    rank = dist.get_rank()
    rng = np.random.default_rng(10 + rank)
    for dtype in (torch.float32, torch.bfloat16):
        err = None
        for r in range(2):
            x = torch.as_tensor(rng.normal(scale=1 + rank, size=(257,)), dtype=torch.float32)
            x = x.to(dtype)
            mean, err = compressed_all_reduce(x, None, err)
            name = str(dtype).removeprefix("torch.")
            out[f"comp/{name}/{r}/x"], out[f"comp/{name}/{r}/mean"] = x, mean
            out[f"comp/{name}/{r}/err"] = err


TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT = 120  # seconds a rank may take


def run_ranks(phase: str, world: int, out) -> list[dict]:
    """``phase`` on ``world`` gloo ranks, each a process of its own meeting
    through a file under the directory ``out`` → each rank's results."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, TESTS]), "OMP_NUM_THREADS": "1"}
    init = out / f"rendezvous_{phase}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase", phase, "--rank", str(r),
         "--world", str(world), "--init", str(init), "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            err = f"rank timed out after {TIMEOUT} s"
        finally:
            proc.kill()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    return [torch.load(out / f"{phase}_rank{r}.pt") for r in range(world)]


def close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> None:
    """``got`` within ``tol`` of ``want``'s largest magnitude (at least 1)."""
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: max |diff| {err:.3g} against {tol} x {scale:.3g}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["world2", "world1", "collectives", "families2",
                                        "families3"], required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="rendezvous file")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)  # ranks share the host's cores with each other
    dist.init_process_group("gloo", init_method=f"file://{args.init}", rank=args.rank,
                            world_size=args.world)
    mesh = make_host_mesh(model_parallel=args.world, device_type="cpu")
    out: dict = {}
    ckpt_dir = os.path.join(args.out, "ckpt")
    if args.phase == "world2":
        for arch in ARCHS:
            model_case(mesh, arch, out)
        combine_case(mesh, out)
        ckpt_case(mesh, ckpt_dir, out)
    elif args.phase == "families2":
        for tag, (arch, kw) in FAMILIES.items():
            model_case(mesh, arch, out, tag, prefill=True, **kw)
        for tag, (arch, kw) in INT8.items():
            model_case(mesh, arch, out, tag, train=False, prefill=True, **kw)
        moe_comms_case(mesh, out)
    elif args.phase == "families3":
        for arch in FAMILIES3:
            model_case(mesh, arch, out, prefill=True)
        model_case(mesh, "musicgen-medium", out, KV_SEQ, train=False, kv_seq=True)
    elif args.phase == "world1":
        restore_case(mesh, ckpt_dir, out)
        run = train("yi-6b", ckpt_dir=os.path.join(args.out, "launch"), **LAUNCH)
        out["launch/losses"] = torch.tensor(run["losses"])
    else:
        collectives_case(out)
    torch.save(out, os.path.join(args.out, f"{args.phase}_rank{args.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
