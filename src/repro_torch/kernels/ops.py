"""Model-layout wrappers around the attention kernels.

Counterpart of ``repro.kernels.ops``: the model code keeps ``(B, L, H, D)``
and the kernels take head-major tensors, so these functions swap the layout
and call the kernel modules, which launch the Hopper kernel on CUDA tensors
and run the plain PyTorch version on CPU tensors.

:func:`slot_decode_attention` is the engine-level mapping that the
reference's slot cache describes: one layer's slot cache
``(n_slots, c_max, K, D)`` is viewed, without a copy, as pages
``(n_slots * c_max / 16, 16, K, D)`` with block table
``bt[b, j] = b * (c_max / 16) + j``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged

#: KV positions per page of the slot-cache view (the vLLM block size).
PAGE = 16


def flash_attention(
    q: torch.Tensor,  # (B, L, H, D) — model layout
    k: torch.Tensor,  # (B, L, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Prefill attention in the model layout; returns (B, L, H, D)."""
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    return _flash.flash_attention(qh, kh, vh, causal=causal).transpose(1, 2)


@functools.lru_cache(maxsize=32)
def slot_block_table(
    n_slots: int, c_max: int, device: torch.device
) -> torch.Tensor:
    """Block table of the slot-cache page view: ``bt[b, j] = b*(c_max/16)+j``."""
    if c_max % PAGE:
        raise ValueError(f"c_max={c_max} must be a multiple of {PAGE}")
    pps = c_max // PAGE
    return torch.arange(n_slots * pps, dtype=torch.int32, device=device).view(
        n_slots, pps
    )


def slot_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, K, D) one layer's slot cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 valid positions per slot
) -> torch.Tensor:
    """Decode attention over one layer's slot cache, as pages; (B, 1, H, D)."""
    b, s, n_kv, d = k_cache.shape
    bt = slot_block_table(b, s, k_cache.device)
    k_pages = k_cache.view(b * s // PAGE, PAGE, n_kv, d)
    v_pages = v_cache.view(b * s // PAGE, PAGE, n_kv, d)
    out = _paged.paged_attention(q[:, 0], k_pages, v_pages, bt, lengths)
    return out[:, None]
