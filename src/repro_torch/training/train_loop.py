"""The training step (counterpart of ``repro.training.train_loop``).

``make_train_step`` builds ``train_step(params, opt_state, batch, step) →
(params, opt_state, metrics)``: the loss and its gradient by autograd
(attention's through the flash kernel's backward on the card), optional
microbatch accumulation in f32, global-norm clipping, the cosine learning
rate and the optimizer's update. Parameters and optimizer state are
updated in place and returned (the reference donates its buffers to the
jitted step instead). The step runs on plain tensors or on DTensors placed
by :func:`repro_torch.distributed.sharding.tree_placements` over the
parameters' axes and :func:`opt_state_axes`; :func:`abstract_train_state`
gives the dry run its meta-device stand-ins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import map_axes
from repro_torch.models.model_zoo import Model
from repro_torch.training.optimizer import (
    AdafactorState,
    AdamWState,
    clip_by_global_norm,
    cosine_schedule,
    get_optimizer,
)
from repro_torch.training.tree import leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    optimizer: str = "adamw"
    weight_decay: float = 0.1
    microbatches: int = 1  # gradient accumulation factor


def _to_device(batch: dict, device: torch.device) -> dict:
    """The batch's leaves as tensors on ``device``; a tensor already there
    (a DTensor among them) is kept as it is."""
    return {k: v if isinstance(v, torch.Tensor) and v.device == device
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


def _split(batch: dict, n: int) -> list[dict]:
    """The batch as ``n`` microbatches along the batch axis (axis 1 of
    M-RoPE's (3, B, L) ``positions``); scalars go to every microbatch."""
    def parts(key, x):
        if x.dim() == 0:
            return [x] * n
        axis = 1 if key == "positions" else 0
        if x.shape[axis] % n:
            raise ValueError("batch must divide microbatches")
        return x.chunk(n, dim=axis)

    split = {k: parts(k, x) for k, x in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def make_train_step(model: Model, tcfg: TrainConfig = TrainConfig()) -> tuple[Callable, Any]:
    """Returns (train_step, optimizer)."""
    if tcfg.optimizer == "adamw":
        opt = get_optimizer("adamw", weight_decay=tcfg.weight_decay)
    else:
        opt = get_optimizer(tcfg.optimizer)

    def compute_grads(params, batch, p_leaves):
        if tcfg.microbatches <= 1:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, p_leaves)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)
        n = tcfg.microbatches
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in p_leaves]
        total = torch.zeros((), dtype=torch.float32, device=p_leaves[0].device)
        for mb in _split(batch, n):
            loss, _ = model.loss(params, mb)
            for acc, g in zip(grads, torch.autograd.grad(loss, p_leaves)):
                acc.add_(g.float() / n)
            total = total + loss.detach() / n
        return total, {"loss": total}, grads

    def train_step(params, opt_state, batch, step):
        p_leaves = leaves(params)
        for p in p_leaves:
            p.requires_grad_(True)
        batch = _to_device(batch, p_leaves[0].device)
        _, metrics, grads = compute_grads(params, batch, p_leaves)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = cosine_schedule(
            step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps,
        )
        params, opt_state = opt.update(grads, opt_state, params, lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step, opt


def init_train_state(model: Model, tcfg: TrainConfig, seed: int = 0, *,
                     device: str | torch.device = "cuda"):
    """(params from ``model.init(seed)``, the optimizer's zero state), both
    on ``device``; the parameters require grad."""
    params = model.init(seed, device=resolve_device(device))
    for p in leaves(params):
        p.requires_grad_(True)
    _, opt = make_train_step(model, tcfg)
    return params, opt.init(params)


def abstract_train_state(model: Model, tcfg: TrainConfig):
    """(parameters, optimizer state) as meta tensors: the dry run's
    stand-ins, no memory allocated."""
    params = model.abstract()
    _, opt = make_train_step(model, tcfg)
    return params, opt.init(params)


def opt_state_axes(model: Model, tcfg: TrainConfig):
    """Logical axes of the optimizer state, shaped like it: AdamW's moments
    take the parameters' axes; Adafactor's row statistics drop a leaf's last
    axis and its column statistics the one before it (a rank-1 leaf keeps
    its axes in the rows and has a scalar column); the step count is a
    scalar."""
    p_axes = model.axes()
    if tcfg.optimizer == "adamw":
        return AdamWState(count=(), mu=p_axes, nu=p_axes)
    return AdafactorState(
        count=(),
        vr=map_axes(lambda ax: ax[:-1] if len(ax) >= 2 else ax, p_axes),
        vc=map_axes(lambda ax: ax[:-2] + ax[-1:] if len(ax) >= 2 else (), p_axes),
    )
