"""Output heads (counterpart of ``repro.models.heads``; the training loss
comes with the training slice)."""

from __future__ import annotations

from typing import Optional

import torch


def _mask_padded(logits: torch.Tensor, valid_vocab: Optional[int]) -> torch.Tensor:
    """Megatron-style vocab padding: padded tail logits → f32 min (the
    reference promotes the logits to f32 here, and so does the port)."""
    v = logits.shape[-1]
    if valid_vocab is None or valid_vocab >= v:
        return logits
    idx = torch.arange(v, device=logits.device)
    return torch.where(
        idx < valid_vocab, logits.float(), torch.finfo(torch.float32).min
    )


def lm_logits(
    hidden: torch.Tensor,  # (B, L, D)
    head: torch.Tensor,  # (D, V) — or embed table (V, D) when tied
    *,
    tied: bool = False,
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    logits = hidden @ (head.t() if tied else head)
    return _mask_padded(logits, valid_vocab)


def codebook_logits(
    hidden: torch.Tensor,  # (B, L, D)
    heads: torch.Tensor,  # (K, D, V)
    *,
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    """MusicGen's multi-codebook heads: (B, L, D) x (K, D, V) → (B, L, K, V)."""
    logits = torch.einsum("bld,kdv->blkv", hidden, heads)
    return _mask_padded(logits, valid_vocab)
