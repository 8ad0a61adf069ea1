"""Slot-based KV cache management (counterpart of ``repro.serving.kv_cache``).

Each pool instance reserves ``n_seq`` slots of ``c_max`` tokens — the
provisioning rule of paper Eq. 1–2. The decode state is one ``(k, v)`` pair
of tensors, each ``(n_layers, n_slots, c_max, K, head_dim)`` in bf16; a
prefill result is copied into its slot in place. Each layer's slice is the
page pool of the paged decode kernel (``kernels/ops.slot_decode_attention``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
        self, model: Model, c_max: int, n_slots: int, *, device: str | torch.device = "cuda"
    ) -> None:
        self.model = model
        self.c_max = c_max
        self.n_slots = n_slots
        self.cell = ShapeCell(
            name="serving", kind="decode", seq_len=c_max, global_batch=n_slots
        )
        self.state = model.init_cache(self.cell, device=device)

    def insert_prefill(self, slot: int, prefill_state: tuple) -> None:
        """Copy a single-sequence prefill state (batch dim 1, length ≤ c_max)
        into a slot, cast to the cache dtype."""
        for target, src in zip(self.state, prefill_state):
            target[:, slot, : src.shape[2]] = src[:, 0].to(target.dtype)


def bucket_length(n: int, *, multiple: int = 128, max_len: int = 1 << 20) -> int:
    """Round a prompt length up to the next bucket."""
    b = ((max(1, n) + multiple - 1) // multiple) * multiple
    return min(b, max_len)
