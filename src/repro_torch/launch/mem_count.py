"""Peak memory of a step, counted from the storages its ops create (the
port's counterpart of the reference dry run's ``memory_analysis()``).

The reference compiles its step and reads XLA's buffer assignment: the
argument bytes and the temporaries. The port's step is eager, so
:class:`MemCounter`, a ``TorchDispatchMode``, watches it run and keeps the
bytes of the storages that are alive: each storage is counted once, on the
first op output that owns it (a view, an in-place op or an ``out=`` op
returns a storage of its inputs, which is not new), and it is freed
through a ``weakref.finalize`` on the storage when the last tensor on it
dies. It runs as well on meta tensors (the dry run: no memory, no device)
as on CPU or CUDA tensors, and counts the same on all three, so a meta run
predicts the card's.

Each storage is charged what the CUDA caching allocator gives a fresh
request (:func:`block_bytes`): a multiple of 512 bytes, at least 512; a
request of 10 MiB or more takes a segment rounded up to 2 MiB, which the
allocator does not split when less than 1 MiB of it would be left, so the
block is the whole segment. What an op allocates inside its kernel and
frees before it returns (a library's workspace) is not seen, nor is a
tensor made from Python data on the device (``torch.tensor(..., device=)``
dispatches no op); make such a tensor on the host and copy it over.

DTensors: the mode returns ``NotImplemented`` for an op on DTensors, so
DTensor runs it as local ops on each rank's shards, which come back through
the mode; a DTensor output is counted by its ``_local_tensor``'s storage.
The collectives a redistribution issues are local ops too: the gathered
buffer of an all-gather is counted where it is made, and ``wait_tensor``
and ``_wrap_tensor_autograd`` return their input on meta tensors too, as
they do on the card (their meta kernels make a new tensor). In the dry run the mode is entered inside
:class:`~repro_torch.launch.comm_count.CommCounter`, which does the same
for DTensors: both see every local op, the counter recording the
collectives and this mode the storages. Ops that DTensor's sharding
propagation runs on fake tensors are skipped.

Usage::

    with MemCounter(held_bytes=storage_bytes(params, opt_state, batch)) as mem:
        step(params, opt_state, batch)
    mem.peak_bytes, mem.temp_bytes
"""

from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: The CUDA caching allocator's rounding and segment sizes.
MIN_BLOCK = 512
SMALL_SIZE = 1 << 20  # requests up to 1 MiB come from small segments
MIN_LARGE_ALLOC = 10 << 20  # from 10 MiB a request gets a segment of its own
ROUND_LARGE = 2 << 20  # ... rounded up to 2 MiB


def block_bytes(nbytes: int) -> int:
    """The block the CUDA caching allocator hands a fresh request of
    ``nbytes`` (0 for an empty storage)."""
    if nbytes <= 0:
        return 0
    size = max(MIN_BLOCK, -(-nbytes // MIN_BLOCK) * MIN_BLOCK)
    if size >= MIN_LARGE_ALLOC:
        segment = -(-size // ROUND_LARGE) * ROUND_LARGE
        if segment - size <= SMALL_SIZE:
            return segment
    return size


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _storage(t):
    """The untyped storage of a tensor (a DTensor's local shard's), or None
    for a tensor without one."""
    if not isinstance(t, torch.Tensor):
        return None
    try:
        return _local(t).untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def storage_bytes(*trees) -> int:
    """Bytes the allocator holds for the distinct storages of the tensors
    in ``trees`` (nested dicts, lists, tuples), each rounded by
    :func:`block_bytes`: what a step's arguments occupy."""
    seen: dict[int, int] = {}
    for leaf in tree_flatten(list(trees))[0]:
        st = _storage(leaf)
        if st is not None:
            seen[id(st)] = block_bytes(st.nbytes())
    return sum(seen.values())


def _aliasing_on_card() -> tuple:
    """Ops that return their input on the card, whose meta kernels make a
    new tensor: a collective's wait, and the wrapper that hands a
    collective's output to autograd (where this torch has it)."""
    ns = torch.ops._c10d_functional
    return tuple(getattr(ns, name).default for name in ("wait_tensor", "_wrap_tensor_autograd")
                 if hasattr(ns, name))


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class MemCounter(TorchDispatchMode):
    """Live and peak bytes of the storages created while the mode is on.

    ``held_bytes`` is what is alive when the mode is entered (the step's
    arguments, from :func:`storage_bytes`); :attr:`peak_bytes` is the most
    that was alive at any point, held bytes included, and
    :attr:`temp_bytes` the peak less the held bytes."""

    def __init__(self, held_bytes: int = 0) -> None:
        super().__init__()
        self.held_bytes = int(held_bytes)
        self.live_bytes = self.held_bytes
        self.peak_bytes = self.held_bytes
        self._live: dict[int, int] = {}  # id(storage) -> bytes charged
        self._aliasing = _aliasing_on_card()

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.held_bytes

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor, inputs: set[int]) -> None:
        st = _storage(t)
        if st is None or id(st) in inputs or id(st) in self._live or _is_fake(t):
            return
        nbytes = block_bytes(st.nbytes())
        self._live[id(st)] = nbytes
        weakref.finalize(st, self._free, id(st))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops, seen below
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in self._aliasing:
            # the card's op returns its input; the meta kernel makes a new tensor
            return args[0] if args[0].device.type == "meta" else out
        inputs = {id(st) for st in map(_storage, tree_flatten((args, kwargs))[0])
                  if st is not None}
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t, inputs)
        return out

    def stats(self) -> dict:
        """``held_bytes``, ``peak_bytes`` and ``temp_bytes``."""
        return {"held_bytes": self.held_bytes, "peak_bytes": self.peak_bytes,
                "temp_bytes": self.temp_bytes}
