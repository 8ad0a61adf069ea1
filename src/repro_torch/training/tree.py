"""Trees of tensors as the training path keeps them: nested dicts (keys in
sorted order, as ``jax.tree_util`` flattens a dict), NamedTuples (fields in
order) and tuples or lists, with tensors, numpy arrays or numbers as
leaves. The order of :func:`leaves` is the reference's leaf order, which
the checkpoint format and the carried optimizer states rely on."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in leaf order; a path is spelled as
    ``jax.tree_util.keystr`` spells it (``['p']['w']``, ``.count``,
    ``[0]``)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_with_paths(tree[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from flatten_with_paths(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, node in enumerate(tree):
            yield from flatten_with_paths(node, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in leaf order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, values: Iterator) -> Any:
    """A tree shaped like ``like`` whose leaves are taken from ``values`` in
    leaf order."""
    values = iter(values)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}  # keep the caller's key order
            for key in sorted(node):
                out[key] = build(node[key])
            return out
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        if node is None:
            return None
        return next(values)

    return build(like)


def map_tree(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return unflatten(tree, (fn(x) for x in leaves(tree)))
