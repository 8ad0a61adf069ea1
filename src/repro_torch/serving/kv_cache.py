"""Slot-based KV cache management (counterpart of ``repro.serving.kv_cache``).

Each pool instance reserves ``n_seq`` slots of ``c_max`` tokens — the
provisioning rule of paper Eq. 1–2. The decode state is the model's tree
of tensors (:meth:`Model.init_cache`), each with its slot axis where
:meth:`Model.cache_batch_axes` says (the reference's per-leaf
``batch_axes``): for the dense family ``(k, v)`` or, with an int8 cache,
``(k, v, k_scale, v_scale)``, each ``(n_layers, n_slots, c_max, K, ·)``;
with cross-attention (musicgen) ``(cross_k, cross_v)`` after them, each
``(n_layers, n_slots, cross_mem_len, K, D)``; for the hybrid its shared
attention's k/v and its Mamba blocks' conv and SSD states; for xLSTM the
mLSTM ``(C, n)`` (slot axis 2) and sLSTM ``(c, n, h, m)`` (slot axis 1),
f32 and of no sequence length. A prefill result is copied into its slot
in place: an attention cache's first L positions, any other leaf whole.
Each layer's attention slice is the page pool of the paged decode kernel
(``kernels/ops.slot_decode_attention``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.models.model_zoo import Model


@dataclasses.dataclass
class SlotAllocator:
    """Host-side free-list of sequence slots."""

    n_slots: int

    def __post_init__(self) -> None:
        self.free: list[int] = list(range(self.n_slots))[::-1]
        self.used: set[int] = set()

    def alloc(self) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop()
        self.used.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self.used:
            raise ValueError(f"slot {slot} not allocated")
        self.used.discard(slot)
        self.free.append(slot)

    @property
    def num_free(self) -> int:
        return len(self.free)


class SlotKVCache:
    """Batched decode state with slot-indexed insertion."""

    def __init__(
        self,
        model: Model,
        c_max: int,
        n_slots: int,
        *,
        device: str | torch.device = "cuda",
        act_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        self.model = model
        self.c_max = c_max
        self.n_slots = n_slots
        self.cell = ShapeCell(
            name="serving", kind="decode", seq_len=c_max, global_batch=n_slots
        )
        self.state = model.init_cache(self.cell, device=device, act_dtype=act_dtype)
        self.batch_axes = model.cache_batch_axes()

    def insert_prefill(self, slot: int, prefill_state: Any) -> None:
        """Copy a single-sequence prefill state (slot axis of size 1) into a
        slot, cast to the cache dtype: each leaf whole, or for the attention
        caches their first L ≤ c_max positions."""
        for target, src, axis in zip(_leaves(self.state), _leaves(prefill_state),
                                     _leaves(self.batch_axes)):
            dst = target.select(axis, slot)
            part = src.select(axis, 0)
            dst[tuple(slice(0, n) for n in part.shape)] = part.to(target.dtype)


def _leaves(tree: Any) -> list:
    """Leaves of a tree of dicts and tuples, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def bucket_length(n: int, *, multiple: int = 128, max_len: int = 1 << 20) -> int:
    """Round a prompt length up to the next bucket."""
    b = ((max(1, n) + multiple - 1) // multiple) * multiple
    return min(b, max_len)
