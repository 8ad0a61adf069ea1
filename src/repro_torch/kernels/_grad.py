"""Autograd policy of the kernel wrappers that have no backward kernel."""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record ``name``'s kernel output: a kernel
    with no backward kernel returns a tensor with no ``grad_fn``, so a loss
    built on it would give its inputs no gradient, silently."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel on CUDA yet (its output would carry "
            f"no gradient): run it under torch.no_grad(), or train on the CPU, "
            f"where its plain version is differentiable"
        )
