"""Zamba2-style hybrid: Mamba-2 backbone + shared attention blocks
(counterpart of ``repro.models.hybrid``).

Structure (zamba2-2.7b): 54 Mamba-2 blocks; after every ``attn_every`` = 6
blocks one of ``n_shared_attn_blocks`` = 2 *shared* attention+MLP blocks is
applied (round-robin, ``group % n_shared``), with per-invocation LoRA
adapters on its q/k/v and MLP-up projections (9 invocations). The groups
and their Mamba blocks are a plain Python loop over the stacked parameters
(the reference ``lax.scan``s over both).

Decode state, as the reference's prefill returns it:
``{"attn": (k, v), "mamba": {"conv": ..., "ssd": ...}}`` with k/v
``(groups, B, S, K, Dh)``, conv ``(groups, sub, B, K-1, d_inner + 2N)`` and
the SSD state ``(groups, sub, B, H, P, N)`` f32. Decode updates it in
place, each slot at its own position (``batch["index"]`` is per slot).

On DTensors (the sharded path) the embedding and the head are
vocab-parallel as the transformer's, the shared block's heads and MLP shard
as a dense layer's, a Mamba-2 block's SSM heads shard (:mod:`ssm`), and
every sublayer's output is laid out as the residual stream
(:func:`~repro_torch.models.layers.residual`, one all-reduce of its
partial sums). The decode state keeps the SSD state on its heads' shards
and the conv state whole.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain, replicate_like
from repro_torch.kernels.ops import write_slot
from repro_torch.models import heads as heads_lib
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    embed_lookup,
    flash_attention,
    residual,
    rms_norm,
    rope_angles,
)
from repro_torch.models.params import ParamDef, stack_tree
from repro_torch.models.remat import remat as remat_layer
from repro_torch.models.ssm import mamba2_block, mamba2_decode_step, mamba2_param_defs

# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def _shared_block_defs(cfg: ArchConfig) -> dict:
    h, k, dh, d, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
    return {
        "attn_norm": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
        "w_q": ParamDef((d, h, dh), ("embed", "heads", "head_dim"), init="scaled"),
        "w_k": ParamDef((d, k, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "w_v": ParamDef((d, k, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "w_o": ParamDef((h, dh, d), ("heads", "head_dim", "embed"), init="scaled"),
        "mlp_norm": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
        "w_up": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "w_down": ParamDef((f, d), ("ffn", "embed"), init="scaled"),
    }


def _lora_defs(cfg: ArchConfig) -> dict:
    d, r = cfg.d_model, cfg.shared_lora_rank
    h, k, dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    return {
        "a_q": ParamDef((d, r), ("embed", None), init="scaled"),
        "b_q": ParamDef((r, h, dh), (None, "heads", "head_dim"), init="zeros"),
        "a_k": ParamDef((d, r), ("embed", None), init="scaled"),
        "b_k": ParamDef((r, k, dh), (None, "kv_heads", "head_dim"), init="zeros"),
        "a_v": ParamDef((d, r), ("embed", None), init="scaled"),
        "b_v": ParamDef((r, k, dh), (None, "kv_heads", "head_dim"), init="zeros"),
        "a_up": ParamDef((d, r), ("embed", None), init="scaled"),
        "b_up": ParamDef((r, f), (None, "ffn"), init="zeros"),
    }


def _mamba_block_defs(cfg: ArchConfig) -> dict:
    defs = mamba2_param_defs(
        cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_conv
    )
    defs["in_norm"] = ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=torch.float32)
    return defs


def n_groups(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError("n_layers must divide attn_every")
    return cfg.n_layers // cfg.attn_every


def hybrid_defs(cfg: ArchConfig) -> dict:
    groups = n_groups(cfg)
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "mamba": stack_tree(stack_tree(_mamba_block_defs(cfg), cfg.attn_every, "sub"), groups),
        "shared": stack_tree(_shared_block_defs(cfg), cfg.n_shared_attn_blocks, "layers"),
        "lora": stack_tree(_lora_defs(cfg), groups),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=torch.float32),
        "lm_head": ParamDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), init="scaled"),
    }


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------


def _index(tree: dict, *idx: int) -> dict:
    return {k: v[idx] for k, v in tree.items()}


def _lora_proj(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """x @ w + (x @ a) @ b, with w (d, ...) and b (r, ...) flattened."""
    bsz, length, d = x.shape
    base = x @ w.reshape(d, -1)
    low = (x @ a) @ b.reshape(b.shape[0], -1)
    return (base + low).view(bsz, length, *w.shape[1:])


def _shared_attn_apply(x, base: dict, lora: dict, cfg: ArchConfig, cos, sin, *,
                       cache=None, rows=None, write=None, lengths=None):
    """Shared attention + MLP block. Without ``cache``: prefill over the
    whole sequence (the flash kernel), returning this invocation's (k, v).
    With ``cache`` (one group's (k, v) slot caches): write each slot's new
    K/V at ``write`` in place and attend over its first ``lengths``
    positions (the paged kernel)."""
    xn = rms_norm(x, base["attn_norm"], cfg.norm_eps)
    q = _lora_proj(xn, base["w_q"], lora["a_q"], lora["b_q"])
    k = _lora_proj(xn, base["w_k"], lora["a_k"], lora["b_k"])
    v = _lora_proj(xn, base["w_v"], lora["a_v"], lora["b_v"])
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cache is None:
        q = constrain(q, ("batch", None, "heads", None))
        k = constrain(k, ("batch", None, "kv_heads", None))
        o = flash_attention(q, k, v, causal=True)
        new_cache = (k, v)
    else:
        k_cache, v_cache = cache
        write_slot(k_cache, k[:, 0].to(k_cache.dtype), rows, write)
        write_slot(v_cache, v[:, 0].to(v_cache.dtype), rows, write)
        o = decode_attention(q, k_cache, v_cache, lengths)
        new_cache = cache
    bsz, length = o.shape[:2]
    w_o = base["w_o"]
    x = residual(x, o.reshape(bsz, length, -1) @ w_o.reshape(-1, w_o.shape[-1]))

    xn = rms_norm(x, base["mlp_norm"], cfg.norm_eps)
    up = _lora_proj(xn, base["w_up"], lora["a_up"], lora["b_up"])
    up = constrain(up, ("batch", None, "ffn"))
    x = residual(x, F.gelu(up, approximate="tanh") @ base["w_down"])
    return x, new_cache


def _mamba_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_ssm_heads, head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state)


def _group_full(x: torch.Tensor, g: int, params: dict, cfg: ArchConfig, cos, sin,
                keep_state: bool):
    """Group ``g`` (its Mamba blocks, then its shared-attention invocation)
    over the whole sequence → (x, (conv states, SSD states, k, v) or None
    without ``keep_state``)."""
    kw = _mamba_kw(cfg)
    g_conv, g_ssd = [], []
    for s in range(cfg.attn_every):
        p = _index(params["mamba"], g, s)
        out, st = mamba2_block(rms_norm(x, p["in_norm"], cfg.norm_eps), p, **kw,
                               keep_state=keep_state)
        x = residual(x, out)
        if keep_state:
            g_conv.append(st["conv"])
            g_ssd.append(st["ssd"])
    base = _index(params["shared"], g % cfg.n_shared_attn_blocks)
    x, (k, v) = _shared_attn_apply(x, base, _index(params["lora"], g), cfg, cos, sin)
    if not keep_state:
        return x, None
    return x, (torch.stack(g_conv), torch.stack(g_ssd), k, v)


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = embed_lookup(tokens.long(), params["embed"])
    return constrain(x, ("batch", None, "embed"))


def _run_full(params: dict, cfg: ArchConfig, tokens: torch.Tensor, remat: str = "none",
              keep_state: bool = False):
    """Every group over the whole sequence → (x, decode state). Each group
    runs under the rematerialization mode ``remat`` (the training pass's),
    as the reference's ``_group_scan`` checkpoints a group; the state is
    built only with ``keep_state`` (prefill), else it is None."""
    x = _embed(params, tokens)
    bsz, length = tokens.shape
    pos = replicate_like(torch.arange(length, device=x.device).expand(bsz, length), x)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    groups = []
    for g in range(n_groups(cfg)):
        x, leaves = remat_layer(
            lambda h, g=g: _group_full(h, g, params, cfg, cos, sin, keep_state), remat)(x)
        if keep_state:
            groups.append(leaves)
    if not keep_state:
        return x, None
    convs, ssds, ks, vs = (torch.stack(t) for t in zip(*groups))
    state = {
        "attn": (ks, vs),
        "mamba": {"conv": convs, "ssd": ssds},
    }
    return x, state


def _finish(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    vv = cfg.vocab if cfg.padded_vocab != cfg.vocab else None
    return heads_lib.lm_logits(x, params["lm_head"], valid_vocab=vv)


def forward(params: dict, cfg: ArchConfig, batch: dict, *, remat: str = "none"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, L, V), aux_loss); ``remat`` as
    :func:`repro_torch.models.transformer.forward`'s."""
    x, _ = _run_full(params, cfg, batch["tokens"], remat)
    return _finish(params, cfg, x), torch.zeros((), device=x.device)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *, remat: str = "none", **_
            ) -> tuple[torch.Tensor, dict]:
    """Training loss: cross-entropy against ``batch["labels"]``."""
    logits, _ = forward(params, cfg, batch, remat=remat)
    loss, metrics = heads_lib.softmax_xent(logits, batch["labels"])
    metrics["total_loss"] = loss
    return loss, metrics


def prefill(params: dict, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """Prefill of unpadded prompts → (last-position logits (B, V), decode
    state of the prompt's length)."""
    x, state = _run_full(params, cfg, batch["tokens"], keep_state=True)
    return _finish(params, cfg, x[:, -1:])[:, 0], state


def decode_step(params: dict, cfg: ArchConfig, states: Any, batch: dict) -> tuple[torch.Tensor, Any]:
    """One decode iteration over a slot batch. ``batch["index"]`` is the
    write position, a scalar or one per slot; ``states`` are updated in
    place and returned."""
    x = _embed(params, batch["tokens"])
    bsz = x.shape[0]
    index = replicate_like(torch.as_tensor(batch["index"], device=x.device), x).long().expand(bsz)
    cos, sin = rope_angles(index[:, None], cfg.head_dim, cfg.rope_theta)
    k_all, v_all = states["attn"]
    conv_all, ssd_all = states["mamba"]["conv"], states["mamba"]["ssd"]
    lengths = (index + 1).to(torch.int32)
    # the reference's dynamic_update_slice clamps the write into the cache
    write = index.clamp(max=k_all.shape[2] - 1)
    rows = torch.arange(bsz, device=x.device)
    kw = _mamba_kw(cfg)
    for g in range(n_groups(cfg)):
        for s in range(cfg.attn_every):
            p = _index(params["mamba"], g, s)
            st = {"conv": conv_all[g, s], "ssd": ssd_all[g, s]}
            out, new = mamba2_decode_step(rms_norm(x, p["in_norm"], cfg.norm_eps), p, st, **kw)
            x = residual(x, out)
            conv_all[g, s].copy_(new["conv"])
            ssd_all[g, s].copy_(new["ssd"])
        base = _index(params["shared"], g % cfg.n_shared_attn_blocks)
        x, _ = _shared_attn_apply(
            x, base, _index(params["lora"], g), cfg, cos, sin,
            cache=(k_all[g], v_all[g]), rows=rows, write=write, lengths=lengths,
        )
    return _finish(params, cfg, x)[:, 0], states


def init_cache(
    cfg: ArchConfig,
    batch: int,
    seq_len: int,
    *,
    act_dtype: torch.dtype,
    device: Optional[torch.device] = None,
) -> dict:
    """Zero decode state for ``batch`` slots of ``seq_len`` positions: the
    shared attention's k/v in bf16, the conv state in the activations'
    dtype (as the reference's decode leaves it), the SSD state in f32."""
    kv_dtype = torch.bfloat16
    groups, sub = n_groups(cfg), cfg.attn_every
    kv = (groups, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    conv = (groups, sub, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    ssd = (groups, sub, batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return {
        "attn": (
            torch.zeros(kv, dtype=kv_dtype, device=device),
            torch.zeros(kv, dtype=kv_dtype, device=device),
        ),
        "mamba": {
            "conv": torch.zeros(conv, dtype=act_dtype, device=device),
            "ssd": torch.zeros(ssd, dtype=torch.float32, device=device),
        },
    }


def cache_batch_axes(cfg: ArchConfig) -> dict:
    """The slot axis of each decode-state leaf."""
    return {"attn": (1, 1), "mamba": {"conv": 2, "ssd": 2}}
