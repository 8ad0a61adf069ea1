"""Logical-axis sharding on DeviceMeshes (counterpart of
``repro.distributed.sharding``).

Models name every parameter and activation dimension with a *logical*
axis ("vocab", "heads", "ffn", "batch", ...). An :class:`AxisRules` table
maps logical names to mesh axes, so one model definition runs on the
single-pod ``("data", "model")`` mesh, the multi-pod ``("pod", "data",
"model")`` mesh or a one-card mesh without edits. The rules give a
PartitionSpec (here a tuple, one entry a tensor dimension: ``None``, a mesh
axis or a tuple of mesh axes) with the reference's semantics, and
:func:`placements` turns it into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh``.

:func:`constrain` is the reference's in-graph sharding hint: a no-op for a
plain tensor, a ``redistribute`` for a DTensor, under the rules that
:func:`use_rules` makes current (the dry run and the training launcher
set their policy's). Unlike the reference's, it never swallows an error: a
placement the mesh cannot take raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

MeshAxes = Union[str, tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to mesh axis names."""

    rules: tuple[tuple[str, MeshAxes], ...]

    def lookup(self, logical: Optional[str], mesh) -> MeshAxes:
        """The mesh axes of ``logical`` that ``mesh`` has (None for an
        unknown logical axis: it replicates)."""
        if logical is None:
            return None
        for name, target in self.rules:
            if name == logical:
                return _filter_present(target, mesh)
        return None

    def spec(self, logical_axes: Sequence[Optional[str]], mesh) -> tuple:
        """The PartitionSpec of a tensor annotated with logical axes, as a
        tuple. A mesh axis may appear once: a later dimension that names it
        again degrades to replication, the first use winning."""
        used: set[str] = set()
        parts: list[MeshAxes] = []
        for logical in logical_axes:
            target = self.lookup(logical, mesh)
            target_t = (target,) if isinstance(target, str) else tuple(target or ())
            fresh = tuple(a for a in target_t if a not in used)
            used.update(fresh)
            if not fresh:
                parts.append(None)
            elif len(fresh) == 1:
                parts.append(fresh[0])
            else:
                parts.append(fresh)
        return tuple(parts)


def _filter_present(target: MeshAxes, mesh) -> MeshAxes:
    """Drop mesh axes the mesh does not have (e.g. no "pod" axis)."""
    if target is None:
        return None
    names = set(mesh.mesh_dim_names)
    if isinstance(target, str):
        return target if target in names else None
    kept = tuple(a for a in target if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


#: Default rules for the production meshes.
DEFAULT_RULES = AxisRules(
    rules=(
        # data-like
        ("batch", ("pod", "data")),
        ("serve_batch", ("pod", "data")),
        # model/tensor parallel
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("ffn", "model"),
        ("experts", "model"),
        ("ssm_heads", "model"),
        ("kv_seq", "model"),  # MQA decode: shard the cache's sequence instead
        # sequence parallelism over the data axis (long context, batch 1)
        ("seq_data", "data"),
        # never sharded
        ("layers", None),
        ("embed", None),
        ("seq", None),
        ("head_dim", None),
        ("state", None),
        ("conv", None),
        ("codebooks", None),
    )
)


def placements(spec: Sequence[MeshAxes], mesh) -> tuple[Placement, ...]:
    """DTensor placements of a PartitionSpec: a tensor dimension on mesh
    axes becomes ``Shard(dim)`` on each of them, the rest replicate.
    DTensor splits a dimension over several mesh axes in mesh order, so a
    spec that names them in another order raises, as does a mesh axis
    named twice."""
    names = tuple(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {tuple(spec)}: dimension {dim} on mesh axes {axes} out of the "
                f"mesh's order {names}; DTensor cannot express that layout"
            )
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} names mesh axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one tensor lives: a mesh and its placements on it."""

    mesh: Any
    placements: tuple[Placement, ...]

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shard each rank holds of a tensor of global ``shape``.
        Raises where a sharded dimension does not divide its mesh axes (the
        reference's shardings must divide too)."""
        local = list(shape)
        for i, p in enumerate(self.placements):
            if isinstance(p, Shard):
                n = self.mesh.shape[i]
                if p.dim >= len(local) or local[p.dim] % n:
                    raise ValueError(
                        f"dimension {p.dim} of {tuple(shape)} does not divide mesh axis "
                        f"{self.mesh.mesh_dim_names[i]!r} of size {n}"
                    )
                local[p.dim] //= n
        return tuple(local)

    def place(self, t: torch.Tensor) -> DTensor:
        """``t`` (a tensor, or a DTensor to re-place) as a DTensor in this
        layout."""
        self.local_shape(t.shape)
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements)
        return distribute_tensor(t, self.mesh, list(self.placements))


def _is_axes(node: Any) -> bool:
    return isinstance(node, tuple) and all(isinstance(a, (str, type(None))) for a in node)


def map_axes(fn, axes_tree: Any) -> Any:
    """``fn`` applied to every logical-axes tuple of a tree of them (dicts,
    NamedTuples, tuples and lists of axes tuples)."""
    if _is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v) for k, v in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(map_axes(fn, v) for v in axes_tree))
    return type(axes_tree)(map_axes(fn, v) for v in axes_tree)


def tree_placements(axes_tree: Any, mesh, rules: AxisRules = DEFAULT_RULES) -> Any:
    """A tree of logical-axes tuples → the tree of their :class:`Layout`\\ s
    on ``mesh``."""
    return map_axes(lambda axes: Layout(mesh, placements(rules.spec(axes, mesh), mesh)),
                    axes_tree)


def distribute_tree(tree: Any, layouts: Any) -> Any:
    """Every tensor of ``tree`` (meta, host or device; or a DTensor) placed
    by the :class:`Layout` at the same position of ``layouts``."""
    from repro_torch.training.tree import leaves, unflatten  # training imports the models

    values, where = leaves(tree), leaves(layouts)
    if len(values) != len(where):
        raise ValueError(f"{len(values)} leaves against {len(where)} layouts")
    return unflatten(tree, (layout.place(t) for t, layout in zip(values, where)))


def local_bytes(tree: Any) -> int:
    """Bytes one rank holds of a tree of DTensors (and plain tensors, held
    whole)."""
    from repro_torch.training.tree import leaves

    total = 0
    for t in leaves(tree):
        local = t.to_local() if isinstance(t, DTensor) else t
        total += math.prod(local.shape) * local.element_size()
    return total


_RULES: contextvars.ContextVar[AxisRules] = contextvars.ContextVar("rules", default=DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(rules: AxisRules) -> Iterator[AxisRules]:
    """Makes ``rules`` the ones :func:`constrain` reads, inside the block."""
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


class _Constrain(torch.autograd.Function):
    """A layout on a value and on its gradient: the transpose of the
    reference's sharding constraint is the same constraint on the
    cotangent. (A bare ``redistribute`` hands the gradient back in the
    input's layout, so a reduced activation's gradient would travel back
    as a partial sum and be reduced piecemeal wherever it is used.)"""

    @staticmethod
    def forward(ctx, x: DTensor, layout: Layout) -> DTensor:
        ctx.layout = layout
        return layout.place(x) if tuple(x.placements) != layout.placements else x.view_as(x)

    @staticmethod
    def backward(ctx, grad: DTensor):
        layout = ctx.layout
        if tuple(grad.placements) != layout.placements:
            grad = layout.place(grad)
        return grad, None


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: Optional[AxisRules] = None) -> torch.Tensor:
    """The activation ``x`` laid out by its logical axes: a plain tensor as
    it is, a DTensor redistributed on its own mesh under ``rules`` (the
    current ones by default), its gradient laid out the same way. A layout
    the mesh cannot take raises."""
    if not isinstance(x, DTensor):
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes for a rank-{x.dim()} tensor")
    mesh = x.device_mesh
    layout = Layout(mesh, placements((rules or _RULES.get()).spec(logical_axes, mesh), mesh))
    return _Constrain.apply(x, layout)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, made by the model itself (positions, RoPE tables, masks), as a
    replicated DTensor on ``like``'s mesh where ``like`` is a DTensor; else
    ``t`` as it is."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
