"""Model-layout wrappers around the kernels.

Counterpart of ``repro.kernels.ops``: the model code keeps ``(B, L, H, D)``
and the kernels take head-major tensors, so these functions swap the layout
and call the kernel modules, which launch the Hopper kernel on CUDA tensors
and run the plain PyTorch version on CPU tensors. The flash kernel reads
strides, so prefill hands it head-major views and gets back an output that
is ``(B, L, H, D)`` in memory: no copy either way. Under autograd prefill
goes through the flash kernel's ``torch.autograd.Function``.

:func:`slot_decode_attention` is the engine-level mapping that the
reference's slot cache describes: one layer's slot cache
``(n_slots, c_max, K, D)`` is viewed, without a copy, as pages
``(n_slots * c_max / 16, 16, K, D)`` with block table
``bt[b, j] = b * (c_max / 16) + j``; an int8 cache's scales
``(n_slots, c_max, K, 1)`` are viewed the same way.

:func:`ssd_scan` folds dt into x in f32, as the reference model's
``ssd_chunked`` does (the reference's ``ops.ssd_scan`` folds it in x's
dtype, bf16 in the served model), and hands the kernel f32 x.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_scan as _ssd

#: KV positions per page of the slot-cache view (the vLLM block size).
PAGE = 16


def flash_attention(
    q: torch.Tensor,  # (B, L, H, D) — model layout
    k: torch.Tensor,  # (B, L, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Prefill attention in the model layout; returns (B, L, H, D). With
    grad mode on and an input that requires grad it goes through
    :class:`~repro_torch.kernels.flash_attention.FlashAttention`, whose
    backward is the backward kernel (its plain version on the CPU)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _flash.FlashAttention.apply(qh, kh, vh, causal).transpose(1, 2)
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
    k_scale: Optional[torch.Tensor] = None,  # (B, S, K, 1) for an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over one layer's slot cache, as pages; (B, 1, H, D)."""
    b, s, n_kv, d = k_cache.shape
    bt = slot_block_table(b, s, k_cache.device)

    def pages(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t.view(b * s // PAGE, PAGE, n_kv, t.shape[-1])

    out = _paged.paged_attention(
        q[:, 0], pages(k_cache), pages(v_cache), bt, lengths,
        pages(k_scale), pages(v_scale),
    )
    return out[:, None]


def ssd_scan(
    x: torch.Tensor,  # (B, L, H, P) — model layout
    dt: torch.Tensor,  # (B, L, H) positive
    a_neg: torch.Tensor,  # (H,) negative decay
    b_mat: torch.Tensor,  # (B, L, N)
    c_mat: torch.Tensor,  # (B, L, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    dtf = dt.float()
    xh = (x.float() * dtf[..., None]).transpose(1, 2).contiguous()
    log_a = (a_neg.float()[None, None, :] * dtf).transpose(1, 2).contiguous()
    y, s_final = _ssd.ssd_scan(xh, log_a, b_mat.contiguous(), c_mat.contiguous())
    return y.transpose(1, 2).to(x.dtype), s_final
