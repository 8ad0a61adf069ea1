"""Output heads and the training loss (counterpart of
``repro.models.heads``)."""

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


def softmax_xent(
    logits: torch.Tensor,  # (..., V): (B, L, V) or codebook (B, L, K, V)
    labels: torch.Tensor,  # (...) integer
    *,
    z_loss: float = 0.0,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """Mean cross-entropy in f32, with the optional z-loss regularizer
    ``z_loss * lse**2``; with ``mask``, the mean over its weight (at least
    1). Returns (loss, {"loss", "accuracy"}); accuracy takes the first
    arg-max, as ``jnp.argmax`` does."""
    lf = logits.float()
    labels = torch.as_tensor(labels, device=lf.device).long()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    hit = (lf.argmax(-1) == labels).float()
    if mask is not None:
        mask = torch.as_tensor(mask, device=lf.device).float()
        denom = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / denom
        acc = (hit * mask).sum() / denom
    else:
        loss = nll.mean()
        acc = hit.mean()
    return loss, {"loss": loss, "accuracy": acc}
