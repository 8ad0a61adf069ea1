"""Training launcher with fault-tolerant restart (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 100 \\
        --seq-len 128 --global-batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 20 --device cpu

Runs the train step on one device (the card unless ``--device cpu``, where
the kernels' plain versions run), flags straggler steps, checkpoints every
``--ckpt-every`` steps (async, atomic) and, when a checkpoint is there,
resumes from the latest with the data pipeline seeked to its step.
``--simulate-failure-at N`` exercises the restart path deliberately.

With a process group initialised (``torchrun``, or a caller's own
``init_process_group``) the step runs on DTensors: :func:`elastic_mesh`
builds the largest ``(data, model)`` mesh over the world, ``model_parallel``
wide on the model axis (``--model-parallel``); the parameters and the
optimizer state are placed by the sharding policy over ``Model.axes()``
and ``opt_state_axes``, the batch is sharded over the data axis, and a
resume restores the checkpoint onto that mesh (``placements=``). Every
family runs sharded. Without a process group, training runs on one device
as before.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch zamba2-2.7b \
        --model-parallel 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ArchConfig, ShapeCell, get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import SimulatedFailure, StepTimer, elastic_mesh
from repro_torch.distributed.sharding import distribute_tree, tree_placements, use_rules
from repro_torch.launch.policy import build_policy
from repro_torch.models import Model
from repro_torch.training import (
    TrainConfig,
    init_train_state,
    make_batch_fn,
    make_train_step,
    opt_state_axes,
)

def _scalar(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def train(
    arch: str | ArchConfig,
    *,
    steps: int = 100,
    seq_len: int = 128,
    global_batch: int = 8,
    reduced: bool = True,
    peak_lr: float = 1e-3,
    microbatches: int = 1,
    remat: str = "full",
    ckpt_dir: str | None = None,
    ckpt_every: int | None = 25,
    model_parallel: int = 1,
    simulate_failure_at: int = -1,
    log_every: int = 10,
    device: str | torch.device = "cuda",
) -> dict:
    """Train ``arch`` (a config's name, its reduced config unless
    ``reduced=False``; or a config itself, e.g. one cut in depth, taken as
    it is) for ``steps`` steps, resuming from the latest checkpoint under
    ``ckpt_dir`` if there is one; on the world's mesh when a process group
    is initialised. ``ckpt_every=None`` saves no checkpoint (a run timed for
    its steps alone). Returns the final loss, this run's losses, the step it
    started at, the straggler steps and each step's seconds."""
    dev = resolve_device(device)
    cfg = arch
    if isinstance(arch, str):
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    model = Model(cfg, remat=remat)
    tcfg = TrainConfig(
        peak_lr=peak_lr,
        warmup_steps=max(2, steps // 20),
        total_steps=steps,
        microbatches=microbatches,
    )
    step_fn, _ = make_train_step(model, tcfg)
    batch_fn = make_batch_fn(cfg, seq_len, global_batch)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ck = Checkpointer(ckpt_dir, keep=3, async_save=True)
    timer = StepTimer()

    params, opt_state = init_train_state(model, tcfg, 0, device=dev)
    cell = ShapeCell("train", "train", seq_len, global_batch)
    placed, sharding_rules = None, contextlib.nullcontext()
    if dist.is_initialized():
        mesh = elastic_mesh(model_parallel=model_parallel, device_type=dev.type)
        policy = build_policy(cfg, cell, mesh)
        placed = {"p": tree_placements(model.axes(), mesh, policy.rules),
                  "o": tree_placements(opt_state_axes(model, tcfg), mesh, policy.rules),
                  "b": tree_placements(model.input_axes(cell), mesh, policy.rules)}
        params = distribute_tree(params, placed["p"])
        opt_state = distribute_tree(opt_state, placed["o"])
        sharding_rules = use_rules(policy.rules)
    elif model_parallel != 1:
        raise ValueError("model_parallel needs a process group (torchrun)")
    start = ck.latest_step() or 0
    if start:
        state, meta = ck.restore(
            {"p": params, "o": opt_state},
            placements=None if placed is None else {"p": placed["p"], "o": placed["o"]},
        )
        params, opt_state = state["p"], state["o"]
        print(f"[train] resumed from step {start} (loss {meta.get('loss')})")

    specs = model.input_specs(cell)

    def batch_at(i: int) -> dict:
        batch = {k: torch.as_tensor(v, device=dev).to(specs[k].dtype)
                 for k, v in batch_fn(i).items()}
        return batch if placed is None else distribute_tree(batch, placed["b"])

    losses = []
    try:
        with sharding_rules:
            for i in range(start, steps):
                t0 = time.perf_counter()
                if i == simulate_failure_at:
                    raise SimulatedFailure(f"injected failure at step {i}")
                params, opt_state, metrics = step_fn(params, opt_state, batch_at(i), i)
                loss = _scalar(metrics["loss"])
                losses.append(loss)
                if timer.record(time.perf_counter() - t0):
                    print(f"[train] straggler step {i}")
                if i % log_every == 0:
                    print(
                        f"[train] step {i}: loss {loss:.4f} "
                        f"lr {_scalar(metrics['lr']):.2e} "
                        f"gnorm {_scalar(metrics['grad_norm']):.2f}"
                    )
                if ckpt_every and ((i + 1) % ckpt_every == 0 or i + 1 == steps):
                    ck.save(i + 1, {"p": params, "o": opt_state}, {"loss": loss})
    finally:
        # An injected failure still lets the save in flight land, so the
        # drill resumes from a step that does not depend on thread timing.
        ck.wait()
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "start": start, "straggler_steps": list(timer.straggler_steps),
            "step_s": list(timer.history)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true", help="full (unreduced) config")
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt under $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis width of the mesh (under torchrun)")
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if "WORLD_SIZE" in os.environ:  # launched by torchrun: one rank a process
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    out = train(
        args.arch,
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        reduced=not args.full,
        peak_lr=args.peak_lr,
        microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        model_parallel=args.model_parallel,
        simulate_failure_at=args.simulate_failure_at,
        device=args.device,
    )
    print(f"[train] done: final loss {out['final_loss']:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
