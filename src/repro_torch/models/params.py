"""Spec-first parameter trees (counterpart of ``repro.models.params``).

Models declare parameters as a nested dict of :class:`ParamDef`; from one
declaration come the materialized tensors (:func:`init_params`, from a
seeded ``torch.Generator``), the parameter count and byte size. The
materialized tree is a nested dict of tensors in the reference's layout,
so :func:`params_from_numpy` can carry a reference parameter tree (as
numpy arrays) across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch"
            )


def _leaves(defs: Any, prefix: tuple = ()):
    """(path, ParamDef) pairs in sorted-key order."""
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for key in sorted(defs):
        yield from _leaves(defs[key], (*prefix, key))


def _set(tree: dict, path: tuple, value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _init_leaf(
    d: ParamDef, gen: torch.Generator, device: torch.device
) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "scaled":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = 1.0 / math.sqrt(max(1, fan_in))
    elif d.init == "normal":
        std = d.scale
    else:
        raise ValueError(f"unknown init {d.init!r}")
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    # Stacked layers are drawn one layer at a time so the f32 draw never
    # holds more than one layer's worth of memory.
    for sl in out if len(d.shape) > 2 else (out,):
        noise = torch.randn(sl.shape, generator=gen, dtype=torch.float32, device=device)
        sl.copy_(noise.mul_(std))
    return out


def init_params(
    defs: Any, seed: int = 0, *, device: str | torch.device = "cuda"
) -> dict:
    """Materialize a ParamDef tree, drawing from one seeded generator in
    sorted-path order. Not bit-compatible with the reference's jax keys."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree: dict = {}
    for path, d in _leaves(defs):
        _set(tree, path, _init_leaf(d, gen, dev))
    return tree


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))  # keeps a 0-d leaf 0-d
    if not arr.flags.writeable:  # e.g. a view of a jax array's buffer
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from jax arrays
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """Carry a reference parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into tensors of the same layout
    and dtype."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)


def opt_state_from_numpy(state: Any, *, device: str | torch.device = "cuda") -> Any:
    """Carry a reference optimizer state (its ``AdamWState`` or
    ``AdafactorState`` with numpy leaves, e.g. ``jax.tree.map(np.asarray,
    opt_state)``) into the port's state of the same name, field by field."""
    from repro_torch.training import optimizer

    cls = getattr(optimizer, type(state).__name__, None)
    if cls not in (optimizer.AdamWState, optimizer.AdafactorState):
        raise TypeError(f"not an optimizer state: {type(state).__name__}")
    dev = resolve_device(device)
    return cls(*(params_from_numpy(getattr(state, f), device=dev) for f in cls._fields))


def param_count(defs: Any) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(defs))


def param_bytes(defs: Any) -> int:
    return sum(
        math.prod(d.shape) * d.dtype.itemsize for _, d in _leaves(defs)
    )


def stack_defs(d: ParamDef, n: int, axis_name: Optional[str] = "layers") -> ParamDef:
    """Prepend a stacking dimension (one entry per layer)."""
    return dataclasses.replace(d, shape=(n, *d.shape), axes=(axis_name, *d.axes))


def stack_tree(defs: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    """Prepend a stacking dimension to every ParamDef of a nested tree (the
    hybrid stacks its Mamba blocks twice: groups, then blocks per group)."""
    if isinstance(defs, ParamDef):
        return stack_defs(defs, n, axis_name)
    return {k: stack_tree(d, n, axis_name) for k, d in defs.items()}
