"""Training launcher with fault-tolerant restart (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 100 \\
        --seq-len 128 --global-batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 20 --device cpu

Runs the train step on one device (the card unless ``--device cpu``, where
the kernels' plain versions run), flags straggler steps, checkpoints every
``--ckpt-every`` steps (async, atomic) and, when a checkpoint is there,
resumes from the latest with the data pipeline seeked to its step.
``--simulate-failure-at N`` exercises the restart path deliberately. One
device and no mesh, so none of the reference's shardings: the reference's
``--model-parallel`` waits for the port's sharded path.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import SimulatedFailure, StepTimer
from repro_torch.models import Model
from repro_torch.training import TrainConfig, init_train_state, make_batch_fn, make_train_step


def train(
    arch: str,
    *,
    steps: int = 100,
    seq_len: int = 128,
    global_batch: int = 8,
    reduced: bool = True,
    peak_lr: float = 1e-3,
    microbatches: int = 1,
    remat: str = "full",
    ckpt_dir: str | None = None,
    ckpt_every: int = 25,
    simulate_failure_at: int = -1,
    log_every: int = 10,
    device: str | torch.device = "cuda",
) -> dict:
    """Train ``arch`` for ``steps`` steps, resuming from the latest
    checkpoint under ``ckpt_dir`` if there is one. Returns the final loss,
    this run's losses, the step it started at and the straggler steps."""
    dev = resolve_device(device)
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
    start = ck.latest_step() or 0
    if start:
        state, meta = ck.restore({"p": params, "o": opt_state})
        params, opt_state = state["p"], state["o"]
        print(f"[train] resumed from step {start} (loss {meta.get('loss')})")

    losses = []
    try:
        for i in range(start, steps):
            t0 = time.perf_counter()
            if i == simulate_failure_at:
                raise SimulatedFailure(f"injected failure at step {i}")
            params, opt_state, metrics = step_fn(params, opt_state, batch_fn(i), i)
            loss = float(metrics["loss"])
            losses.append(loss)
            if timer.record(time.perf_counter() - t0):
                print(f"[train] straggler step {i}")
            if i % log_every == 0:
                print(
                    f"[train] step {i}: loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.2f}"
                )
            if (i + 1) % ckpt_every == 0 or i + 1 == steps:
                ck.save(i + 1, {"p": params, "o": opt_state}, {"loss": loss})
    finally:
        # An injected failure still lets the save in flight land, so the
        # drill resumes from a step that does not depend on thread timing.
        ck.wait()
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "start": start, "straggler_steps": list(timer.straggler_steps)}


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
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
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
        simulate_failure_at=args.simulate_failure_at,
        device=args.device,
    )
    print(f"[train] done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
