"""xLSTM model assembly: groups of (slstm_every − 1) mLSTM blocks and one
sLSTM block (counterpart of ``repro.models.xlstm_model``).

xlstm-350m: 24 blocks, an sLSTM at every 8th position → 3 groups of
(7 mLSTM + 1 sLSTM). The groups and their mLSTM blocks are a plain Python
loop over the stacked parameters (the reference ``lax.scan``s over both).

Decode state is O(1) a sequence, with no KV cache at any context length:
``{"mlstm": (C, n), "slstm": (c, n, h, m)}`` with C (groups, sub, B, H,
Dv, Dk), n (groups, sub, B, H, Dk) and each sLSTM leaf (groups, B, H, D),
all f32, as the reference's prefill returns it. ``decode_step`` writes
every new state into those tensors in place (the serving engine keeps the
cache it gave and drops what the step returns) and ignores
``batch["index"]``.

On DTensors the embedding is vocab-parallel
(:func:`~repro_torch.models.layers.embed_lookup`) and laid out as the
reference constrains it, and the blocks shard as :mod:`xlstm` says. The
decode state keeps its heads whole on every rank (the reference's cache
rule), so each rank steps its own heads and writes them back whole.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import heads as heads_lib
from repro_torch.models.layers import embed_lookup, rms_norm
from repro_torch.models.params import ParamDef, stack_tree
from repro_torch.models.remat import remat as remat_layer
from repro_torch.models.xlstm import (
    mlstm_block,
    mlstm_block_defs,
    slstm_block,
    slstm_block_defs,
)


def n_groups(cfg: ArchConfig) -> int:
    if cfg.slstm_every < 2 or cfg.n_layers % cfg.slstm_every:
        raise ValueError("n_layers must divide slstm_every (>=2)")
    return cfg.n_layers // cfg.slstm_every


def xlstm_defs(cfg: ArchConfig) -> dict:
    groups = n_groups(cfg)
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "mlstm": stack_tree(
            stack_tree(mlstm_block_defs(cfg.d_model, cfg.n_heads), cfg.slstm_every - 1, "sub"),
            groups,
        ),
        "slstm": stack_tree(slstm_block_defs(cfg.d_model, cfg.n_heads), groups),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=torch.float32),
        "lm_head": ParamDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), init="scaled"),
    }


def _index(tree: dict, *idx: int) -> dict:
    return {k: v[idx] for k, v in tree.items()}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return constrain(embed_lookup(tokens.long(), params["embed"]), ("batch", None, "embed"))


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, a DTensor ``src`` laid out as ``dst`` first (a
    state whose heads shard on the step's ranks goes back whole)."""
    if isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def _run(params: dict, cfg: ArchConfig, x: torch.Tensor, states: Optional[dict] = None):
    """Every group over ``x``. Without ``states``: the whole sequence from
    the reference's initial states → (x, the decode state). With
    ``states`` (decode, one token): each block steps from its state, which
    is overwritten in place → (x, ``states``)."""
    sub = cfg.slstm_every - 1
    m_c, m_n, s_leaves = [], [], []
    for g in range(n_groups(cfg)):
        for s in range(sub):
            st = None if states is None else tuple(t[g, s] for t in states["mlstm"])
            x, (c, n) = mlstm_block(x, _index(params["mlstm"], g, s), n_heads=cfg.n_heads,
                                    initial_state=st, step=states is not None)
            if states is None:
                m_c.append(c)
                m_n.append(n)
            else:
                _write(st[0], c)
                _write(st[1], n)
        st = None if states is None else tuple(t[g] for t in states["slstm"])
        x, new = slstm_block(x, _index(params["slstm"], g), n_heads=cfg.n_heads,
                             initial_state=st)
        if states is None:
            s_leaves.append(new)
        else:
            for dst, src in zip(st, new):
                _write(dst, src)
    if states is not None:
        return x, states
    groups = n_groups(cfg)
    return x, {
        "mlstm": tuple(torch.stack(t).unflatten(0, (groups, sub)) for t in (m_c, m_n)),
        "slstm": tuple(torch.stack(leaves) for leaves in zip(*s_leaves)),
    }


def _group_full(x: torch.Tensor, g: int, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """Group ``g`` over the whole sequence from the initial states, its
    final states dropped (the forward and the training pass)."""
    for s in range(cfg.slstm_every - 1):
        x, _ = mlstm_block(x, _index(params["mlstm"], g, s), n_heads=cfg.n_heads)
    x, _ = slstm_block(x, _index(params["slstm"], g), n_heads=cfg.n_heads)
    return x


def _finish(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    vv = cfg.vocab if cfg.padded_vocab != cfg.vocab else None
    return heads_lib.lm_logits(x, params["lm_head"], valid_vocab=vv)


def forward(params: dict, cfg: ArchConfig, batch: dict, *, remat: str = "none"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, L, V), aux loss 0). ``remat``
    checkpoints each group, as the reference's ``_group_scan`` does."""
    x = _embed(params, batch["tokens"])
    for g in range(n_groups(cfg)):
        x = remat_layer(lambda h, g=g: _group_full(h, g, params, cfg), remat)(x)
    return _finish(params, cfg, x), torch.zeros((), device=x.device)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *, remat: str = "none", **_
            ) -> tuple[torch.Tensor, dict]:
    """Training loss: cross-entropy against ``batch["labels"]``."""
    logits, _ = forward(params, cfg, batch, remat=remat)
    loss, metrics = heads_lib.softmax_xent(logits, batch["labels"])
    metrics["total_loss"] = loss
    return loss, metrics


def prefill(params: dict, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """Prefill of unpadded prompts, any length → (last-position logits (B,
    V), decode state)."""
    x, states = _run(params, cfg, _embed(params, batch["tokens"]))
    return _finish(params, cfg, x[:, -1:])[:, 0], states


def decode_step(params: dict, cfg: ArchConfig, states: dict, batch: dict) -> tuple[torch.Tensor, Any]:
    """One token a sequence; ``states`` are updated in place and returned."""
    x, states = _run(params, cfg, _embed(params, batch["tokens"]), states)
    return _finish(params, cfg, x)[:, 0], states


def init_cache(
    cfg: ArchConfig,
    batch: int,
    seq_len: int,
    *,
    act_dtype: torch.dtype,
    device: Optional[torch.device] = None,
) -> dict:
    """Zero decode state for ``batch`` sequences, shaped like prefill's (the
    reference's ``init_cache``); ``seq_len`` and ``act_dtype`` play no part,
    the state being O(1) and f32."""
    groups, sub = n_groups(cfg), cfg.slstm_every - 1
    hd_m = 2 * cfg.d_model // cfg.n_heads  # the mLSTM's up-projected head width
    hd_s = cfg.d_model // cfg.n_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "mlstm": (zeros(groups, sub, batch, cfg.n_heads, hd_m, hd_m),
                  zeros(groups, sub, batch, cfg.n_heads, hd_m)),
        "slstm": tuple(zeros(groups, batch, cfg.n_heads, hd_s) for _ in range(4)),
    }


def cache_batch_axes(cfg: ArchConfig) -> dict:
    """The slot axis of each decode-state leaf."""
    return {"mlstm": (2, 2), "slstm": (1, 1, 1, 1)}
