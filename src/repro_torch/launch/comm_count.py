"""The collectives a step issues, and their bytes on the wire (the port's
counterpart of ``repro.launch.hlo_parse``).

The reference compiles its step and parses the optimized HLO text for
collectives, scaling each by the trip counts of the ``while`` loops around
it. The port's step is eager: :class:`CommCounter`, a
``torch.distributed.tensor.debug.CommDebugMode``, records every collective
that DTensor issues while the step runs (the op, its tensor's bytes, its
group's size). There are no ``while`` loops, so each collective is recorded
as often as it runs and the reference's trip-count multipliers have
nothing to do: ``counts`` are executed counts.

Wire bytes per rank follow the reference's ring model:

    all-gather           (N-1)/N x output bytes
    reduce-scatter       (N-1)/N x input bytes
    all-reduce           2 (N-1)/N x bytes
    all-to-all           (N-1)/N x bytes
    collective-permute   bytes

A collective over a group of one rank moves nothing and is not counted, as
the reference skips it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor.debug import CommDebugMode

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict  # executed count per op kind
    wire_bytes_per_chip: float
    by_op: dict  # wire bytes per rank per op kind

    def total_ops(self) -> int:
        return sum(self.counts.values())


def wire_bytes(op: str, nbytes: float, n: int) -> float:
    """Ring-model bytes one rank sends for ``op`` over ``n`` ranks:
    ``nbytes`` is the output's for an all-gather, the input's for a
    reduce-scatter, the tensor's for the rest."""
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * nbytes * frac
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * frac
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


def collective_stats(records) -> CollectiveStats:
    """(op, bytes, group size) records → counts and ring-model wire bytes."""
    counts = {c: 0 for c in COLLECTIVE_OPS}
    wire = {c: 0.0 for c in COLLECTIVE_OPS}
    for op, nbytes, n in records:
        if n <= 1:
            continue
        counts[op] += 1
        wire[op] += wire_bytes(op, nbytes, n)
    return CollectiveStats(counts=counts, wire_bytes_per_chip=sum(wire.values()), by_op=wire)


#: Names of the functional collectives; one of them that ``_record`` does not
#: know raises.
_COLLECTIVE_PREFIXES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all", "broadcast")


def _nbytes(t: torch.Tensor) -> int:
    return math.prod(t.shape) * t.element_size()


def _group_size(name: str) -> int:
    return _resolve_process_group(name).size()


def _record(func, args) -> list[tuple[str, int, int]]:
    """(op, bytes, group size) of one functional collective's call (none
    for another op); a collective it cannot count raises rather than go
    uncounted."""
    ops = torch.ops._c10d_functional
    packet = func._overloadpacket
    if getattr(func, "namespace", None) != "_c10d_functional":
        return []
    if packet is ops.all_gather_into_tensor:
        inp, n, _ = args[:3]
        return [("all-gather", _nbytes(inp) * n, n)]
    if packet is ops.all_gather_into_tensor_coalesced:
        inputs, n, _ = args[:3]
        return [("all-gather", _nbytes(t) * n, n) for t in inputs]
    if packet is ops.reduce_scatter_tensor:
        inp, _, n, _ = args[:4]
        return [("reduce-scatter", _nbytes(inp), n)]
    if packet is ops.reduce_scatter_tensor_coalesced:
        inputs, _, n, _ = args[:4]
        return [("reduce-scatter", _nbytes(t), n) for t in inputs]
    if packet is ops.all_reduce:
        inp, _, name = args[:3]
        return [("all-reduce", _nbytes(inp), _group_size(name))]
    if packet is ops.all_reduce_coalesced:
        inputs, _, name = args[:3]
        n = _group_size(name)
        return [("all-reduce", _nbytes(t), n) for t in inputs]
    if packet is ops.all_to_all_single:
        inp, name = args[0], args[3]
        return [("all-to-all", _nbytes(inp), _group_size(name))]
    if packet.__name__.startswith(_COLLECTIVE_PREFIXES):
        raise NotImplementedError(f"comm_count cannot count {func}")
    return []  # the namespace's helpers (wait_tensor, ...)


class CommCounter(CommDebugMode):
    """``CommDebugMode`` that also keeps, for every functional collective
    DTensor issues, (op, tensor bytes, group size): ``records``, and
    :meth:`stats` from them."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not isinstance(func, torch._ops.HigherOrderOperator):
            self.records.extend(_record(func, args))
        return out

    def stats(self) -> CollectiveStats:
        return collective_stats(self.records)
