"""Optimizers: AdamW and Adafactor, with the cosine schedule and global-norm
clipping (counterpart of ``repro.training.optimizer``).

The reference's formulas in its op order: f32 moments, ``step = m_hat /
(sqrt(v_hat) + eps) + wd * p``, the update in f32, cast to the parameter's
dtype. (``torch.optim.AdamW`` decays the parameter before the step: the
same update in exact arithmetic, rounded in another order.) Scalars (the
learning rate, bias corrections, the Adafactor decay) are f32 tensors, as
the reference's are.

Unlike the reference, whose functions return new trees, ``update`` and
:func:`clip_by_global_norm` work in place and return the trees they were
given: AdamW updates a stacked leaf one layer slice at a time, so its f32
temporaries stay the size of one layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import leaves, map_tree


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _slices(t: torch.Tensor):
    """A stacked leaf (rank > 2) one layer at a time, else the leaf."""
    return t.unbind(0) if t.dim() > 2 else (t,)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def cosine_schedule(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_frac: float = 0.1,
) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``; an f32 scalar."""
    step = _f32(step)
    warm = torch.clamp((step + 1.0) / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return peak_lr * warm * (final_frac + (1 - final_frac) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a stacked leaf
    summed a layer at a time)."""
    total = None
    for x in leaves(tree):
        for sl in _slices(x):
            sq = torch.sum(torch.square(sl.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scales every leaf by ``min(1, max_norm / max(norm, 1e-9))`` in place
    (rounded to its dtype) → (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale)
    return tree, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: Any  # f32 first moment
    nu: Any  # f32 second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Any) -> AdamWState:
        first = leaves(params)[0]
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=map_tree(zeros, params),
            nu=map_tree(zeros, params),
        )

    @torch.no_grad()
    def update(
        self, grads: Any, state: AdamWState, params: Any, lr
    ) -> tuple[Any, AdamWState]:
        """One step on every leaf, in place → (params, state)."""
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c1 = 1 - _f32(b1).to(count.device) ** count.float()
        c2 = 1 - _f32(b2).to(count.device) ** count.float()
        lr = _f32(lr)
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
            for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
                gf = gs.float()
                ms.copy_(b1 * ms + (1 - b1) * gf)
                vs.copy_(b2 * vs + (1 - b2) * torch.square(gf))
                step = (ms / c1) / (torch.sqrt(vs / c2) + self.eps)
                step = step + self.weight_decay * ps.float()
                ps.copy_(ps.float() - lr * step)
        return params, AdamWState(count=count, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    count: torch.Tensor
    vr: Any  # row stats (or full v for rank<2 leaves)
    vc: Any  # col stats (zeros for rank<2 leaves)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def init(self, params: Any) -> AdafactorState:
        def row(p):
            shape = p.shape[:-1] if self._factored(p.shape) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def col(p):
            shape = p.shape[:-2] + p.shape[-1:] if self._factored(p.shape) else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        first = leaves(params)[0]
        return AdafactorState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            vr=map_tree(row, params),
            vc=map_tree(col, params),
        )

    @torch.no_grad()
    def update(
        self, grads: Any, state: AdafactorState, params: Any, lr
    ) -> tuple[Any, AdafactorState]:
        """One step on every leaf (the update's RMS clip spans the whole
        leaf), parameters and statistics in place → (params, state)."""
        count = state.count + 1
        beta = 1.0 - (count.float() + 1.0) ** (-self.decay)
        lr = _f32(lr)
        for p, g, vr, vc in zip(leaves(params), leaves(grads), leaves(state.vr), leaves(state.vc)):
            gf = g.float()
            g2 = torch.square(gf) + self.eps
            if self._factored(p.shape):
                vr.copy_(beta * vr + (1 - beta) * torch.mean(g2, dim=-1))
                vc.copy_(beta * vc + (1 - beta) * torch.mean(g2, dim=-2))
                r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=self.eps)
                step = gf / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + self.eps)
            else:
                vr.copy_(beta * vr + (1 - beta) * g2)
                step = gf / (torch.sqrt(vr) + self.eps)
            rms = torch.sqrt(torch.mean(torch.square(step)) + self.eps)
            step = step / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
        return params, AdafactorState(count=count, vr=state.vr, vc=state.vc)


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
