"""Output heads and the training loss (counterpart of
``repro.models.heads``); the logits are laid out on the vocab axis
(``constrain``) where the reference constrains them."""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import constrain, replicate_like


def _mask_padded(logits: torch.Tensor, valid_vocab: Optional[int]) -> torch.Tensor:
    """Megatron-style vocab padding: padded tail logits → f32 min (the
    reference promotes the logits to f32 here, and so does the port)."""
    v = logits.shape[-1]
    if valid_vocab is None or valid_vocab >= v:
        return logits
    idx = replicate_like(torch.arange(v, device=logits.device), logits)
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
    return constrain(_mask_padded(logits, valid_vocab), ("batch", None, "vocab"))


def codebook_logits(
    hidden: torch.Tensor,  # (B, L, D)
    heads: torch.Tensor,  # (K, D, V)
    *,
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    """MusicGen's multi-codebook heads: (B, L, D) x (K, D, V) → (B, L, K, V).
    DTensors run the product on each rank's shards (its batch rows, its
    vocab columns): DTensor's own einsum flattens (K, V) with V sharded,
    which some versions refuse."""
    if isinstance(heads, DTensor):
        logits = _codebooks_on_shards(hidden, heads)
    else:
        logits = torch.einsum("bld,kdv->blkv", hidden, heads)
    return constrain(_mask_padded(logits, valid_vocab), ("batch", None, None, "vocab"))


def _codebooks_on_shards(hidden: DTensor, heads: DTensor) -> DTensor:
    """The codebook product through ``local_map``: on a mesh dim that shards
    the heads' vocab the hidden states are whole and their gradient a
    partial sum; on one that shards the hidden states' batch the heads are
    whole and their gradient a partial sum."""
    mesh = heads.device_mesh
    h_pl, w_pl, out_pl, hg_pl, wg_pl = [], [], [], [], []
    for hp, wp in zip(hidden.placements, heads.placements):
        if wp == Shard(2):
            pls = (Replicate(), wp, Shard(3), Partial(), wp)
        elif hp == Shard(0):
            pls = (hp, Replicate(), hp, hp, Partial())
        else:
            pls = (Replicate(),) * 5
        for acc, pl in zip((h_pl, w_pl, out_pl, hg_pl, wg_pl), pls):
            acc.append(pl)
    return local_map(lambda h, w: torch.einsum("bld,kdv->blkv", h, w), out_placements=out_pl,
                     in_placements=(tuple(h_pl), tuple(w_pl)),
                     in_grad_placements=(tuple(hg_pl), tuple(wg_pl)), device_mesh=mesh)(
        hidden.redistribute(mesh, h_pl), heads.redistribute(mesh, w_pl))


class _TakeLabel(torch.autograd.Function):
    """``torch.gather(lf, -1, idx)`` whose gradient is scattered into a
    zero tensor made where it is needed. Autograd's own gather backward
    starts from ``grad.new_zeros(lf.shape)``, which on DTensors is a
    replicated tensor of the global shape: the whole global batch's f32
    logits on every rank (268 GB a rank in yi-6b train_4k's dry run). Here
    the zeros follow ``lf``'s placements, except that a vocab-sharded ``lf``
    gets zeros whole along the vocab (the scatter's dimension, which
    DTensor would otherwise all-gather), made on each rank with no
    collective."""

    @staticmethod
    def forward(ctx, lf, idx):
        ctx.save_for_backward(lf, idx)
        return torch.gather(lf, -1, idx)

    @staticmethod
    def backward(ctx, grad):
        lf, idx = ctx.saved_tensors
        return _zeros_whole_along_last(lf).scatter_add(-1, idx, grad), None


def _zeros_whole_along_last(t: torch.Tensor) -> torch.Tensor:
    """Zeros like ``t``; a DTensor's keep its placements but for a shard of
    the last dimension, which becomes whole (replicated)."""
    if not isinstance(t, DTensor):
        return torch.zeros_like(t)
    last = t.ndim - 1
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim % t.ndim == last else p
                       for p in t.placements)
    local = t.to_local()
    zeros = torch.zeros((*local.shape[:-1], t.shape[-1]), dtype=t.dtype, device=local.device)
    stride = [1] * t.ndim  # the global shape's contiguous strides
    for d in range(t.ndim - 2, -1, -1):
        stride[d] = stride[d + 1] * t.shape[d + 1]
    return DTensor.from_local(zeros, t.device_mesh, placements, run_check=False,
                              shape=t.shape, stride=tuple(stride))


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
    gold = _TakeLabel.apply(lf, labels[..., None])
    # a vocab-sharded gather leaves a masked partial sum: reduce it here
    gold = constrain(gold, ("batch", *[None] * (gold.dim() - 1)))[..., 0]
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
