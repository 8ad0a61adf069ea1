"""Per-layer rematerialization for the training loss (counterpart of the
reference's ``jax.checkpoint`` around each scanned layer or group).

``"full"`` keeps only a layer's input and recomputes the rest in the
backward pass (``torch.utils.checkpoint.checkpoint(..., use_reentrant=
False)``, the reference's ``nothing_saveable`` policy); ``"dots"`` keeps
the weight products (``aten.mm``) and recomputes the rest (a
selective-checkpoint policy, the reference's
``checkpoint_dots_with_no_batch_dims``). Neither changes a value: the
recomputed forward is the same code on the same inputs.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_MODES = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, mode: str) -> Callable:
    """``fn`` (one layer or group) under the rematerialization ``mode``."""
    if mode == "none":
        return fn
    if mode == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if mode == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    raise ValueError(f"remat {mode!r} not in {REMAT_MODES}")
