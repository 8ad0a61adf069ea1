"""Attention-transformer assembly, dense and MoE families (counterpart of
``repro.models.transformer``).

Covers the llama-style stack the reference shares with yi-6b,
granite-3-8b, granite-34b, gemma-2b and llama3-70b (dense) and with
qwen3-235b-a22b, llama4-scout and llama4-maverick (MoE, :mod:`moe`): RMS
norm, GQA self-attention with half-split RoPE, a gated or plain MLP or an
MoE layer, and a bf16 KV cache or (``kv_dtype="int8"``) an int8 one with
one f16 scale per (position, head). The layer stack is a Python loop over
the stacked ``blocks`` parameters (the reference ``lax.scan``s over them):
``blocks`` is the dense layers' tree, or for MoE ``{"moe_block": …}``, with
a ``"dense_block"`` beside it when ``moe_every == 2`` (maverick), each
stacked over ``n_layers // moe_every`` steps; a step runs its dense block,
then its MoE block. Cross-attention, M-RoPE and codebook heads (vlm,
audio) are later slices (ROADMAP.md, A11).

MoE groups: ``forward`` and ``prefill`` route ``moe_group`` tokens a group
(capacity factors 1.25 and 2.0); ``decode_step`` routes each sequence's
token as its own group (factor 4.0), as the reference's engine does by
``vmap``ping a one-token decode over its slots, so a free slot's stale row
never changes a busy slot's result.

The KV cache is one layer-ordered ``(n_layers, B, S, K, D)`` pair for every
family: for ``moe_every == 2``, layer 2i is step i's dense block and 2i + 1
its MoE block (the reference keeps ``{"dense_block": (k, v), "moe_block":
(k, v)}``, each over the steps). Decode updates the KV cache tensors in
place (the reference returns new arrays); the caches it returns are the
ones it was given.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import heads as heads_lib
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    flash_attention,
    mlp,
    rms_norm,
    rope_angles,
)
from repro_torch.models.moe import (
    DECODE_CAPACITY_FACTOR,
    PREFILL_CAPACITY_FACTOR,
    TRAIN_CAPACITY_FACTOR,
    moe_layer,
    moe_param_defs,
)
from repro_torch.models.params import ParamDef, stack_tree

#: dtype of a KV cache that is not int8.
KV_DTYPE = torch.bfloat16

# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def attention_defs(cfg: ArchConfig) -> dict:
    h, k, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "attn_norm": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
        "w_q": ParamDef((d, h, dh), ("embed", "heads", "head_dim"), init="scaled"),
        "w_k": ParamDef((d, k, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "w_v": ParamDef((d, k, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "w_o": ParamDef((h, dh, d), ("heads", "head_dim", "embed"), init="scaled"),
    }


def mlp_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "mlp_norm": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
        "w_up": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "w_down": ParamDef((f, d), ("ffn", "embed"), init="scaled"),
    }
    if cfg.activation in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f), ("embed", "ffn"), init="scaled")
    return defs


def moe_layer_defs(cfg: ArchConfig) -> dict:
    return {
        **attention_defs(cfg),
        "mlp_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=torch.float32),
        "moe": moe_param_defs(cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                              cfg.n_shared_experts, cfg.activation),
    }


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the port's transformer does not cover yet."""
    if cfg.family not in ("dense", "moe") or cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md, queue A, item A11)"
        )
    if cfg.pos_type != "rope" or cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: pos_type {cfg.pos_type!r} / frontend "
            f"{cfg.frontend!r} are not ported yet (ROADMAP.md, A11)"
        )
    if cfg.n_codebooks > 0:
        raise NotImplementedError(f"{cfg.name}: codebook heads are not ported yet")


def transformer_defs(cfg: ArchConfig) -> dict:
    """Full parameter tree for a dense or MoE attention architecture."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    dense = {**attention_defs(cfg), **mlp_defs(cfg)}
    if cfg.is_moe:
        if cfg.moe_every not in (1, 2):
            raise ValueError("moe_every must be 1 or 2")
        step = {"moe_block": moe_layer_defs(cfg)}
        if cfg.moe_every == 2:
            step["dense_block"] = dense
        blocks = stack_tree(step, cfg.n_layers // cfg.moe_every)
    else:
        blocks = stack_tree(dense, cfg.n_layers)
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="normal"),
        "blocks": blocks,
        "final_norm": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"), init="scaled")
    return defs


def init_cache(
    cfg: ArchConfig,
    batch: int,
    seq_len: int,
    *,
    act_dtype: torch.dtype,
    kv_dtype: str,
    device: torch.device,
) -> tuple:
    """Zero slot caches: ``(k, v)``, each (n_layers, B, S, K, head_dim) in
    bf16 whatever the activations' dtype ``act_dtype`` (the reference
    derives its cache from the bf16 abstract parameters); for int8 ``(k, v,
    k_scale, v_scale)``, the scales (n_layers, B, S, K, 1) f16. The layer
    axis is in layer order (dense and MoE blocks interleaved for
    ``moe_every == 2``)."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        scale = (*shape[:-1], 1)
        return tuple(
            torch.zeros(sh, dtype=dt, device=device)
            for sh, dt in ((shape, torch.int8), (shape, torch.int8),
                           (scale, torch.float16), (scale, torch.float16))
        )
    return tuple(torch.zeros(shape, dtype=KV_DTYPE, device=device) for _ in range(2))


def cache_batch_axes(kv_dtype: str = "bf16") -> tuple:
    """The slot axis of each cache tensor."""
    return (1,) * (4 if kv_dtype == "int8" else 2)


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------


def _unbind(tree):
    """Per-step views of a tree of tensors stacked on axis 0."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(t) for k, t in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: views[i] for k, views in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def _layers(params: dict) -> list[tuple[dict, bool]]:
    """Per-layer views of the stacked ``blocks`` parameters in layer order,
    each with whether it is an MoE layer."""
    blocks = params["blocks"]
    if "moe_block" not in blocks:
        return [(p, False) for p in _unbind(blocks)]
    moe = [(p, True) for p in _unbind(blocks["moe_block"])]
    if "dense_block" not in blocks:
        return moe
    dense = [(p, False) for p in _unbind(blocks["dense_block"])]
    return [layer for step in zip(dense, moe) for layer in step]


def _project_qkv(x: torch.Tensor, p: dict):
    b, l, d = x.shape
    q = (x @ p["w_q"].reshape(d, -1)).view(b, l, *p["w_q"].shape[1:])
    k = (x @ p["w_k"].reshape(d, -1)).view(b, l, *p["w_k"].shape[1:])
    v = (x @ p["w_v"].reshape(d, -1)).view(b, l, *p["w_v"].shape[1:])
    return q, k, v


def _out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    b, l = o.shape[:2]
    w_o = p["w_o"]
    return o.reshape(b, l, -1) @ w_o.reshape(-1, w_o.shape[-1])


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) symmetric int8 quantization over the last axis:
    f32 amax, round half to even, clip to ±127; the scale (..., 1) in f16."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale.float()).to(torch.bfloat16)


def _self_attention_full(x, p, cos, sin, cfg: ArchConfig, kv_dtype: str = "bf16"):
    """Train/prefill self-attention over the whole sequence; the cache it
    returns is (k, v), or quantized (k, v, k_scale, v_scale) for int8."""
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(xn, p)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True)
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return x + _out_proj(o, p), (kq, vq, ks, vs)
    return x + _out_proj(o, p), (k, v)


def _self_attention_decode(x, p, cos, sin, cfg: ArchConfig, cache, rows, write, lengths):
    """Single-token decode: write this token's K/V (quantized, for an int8
    cache) at ``write`` in place, then attend over the first ``lengths``
    positions of each slot; the paged kernel reads int8 pages and their
    scales as they are."""
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(xn, p)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    k_cache, v_cache = cache[:2]
    scales = cache[2:]
    if scales:
        kvq, kvs = quantize_kv(torch.stack([k[:, 0], v[:, 0]]))  # both in one pass
        k_cache[rows, write], v_cache[rows, write] = kvq[0], kvq[1]
        scales[0][rows, write], scales[1][rows, write] = kvs[0], kvs[1]
    else:
        k_cache[rows, write] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, write] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, lengths, *scales)
    return x + _out_proj(o, p)


def _ffn_sublayer(x, p, cfg: ArchConfig, is_moe: bool, group: int, capacity_factor: float):
    """The MLP or MoE sublayer → (x, aux loss or None)."""
    xn = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if not is_moe:
        return x + mlp(xn, p, cfg.activation), None
    out, aux = moe_layer(xn, p["moe"], n_experts=cfg.n_experts, top_k=cfg.top_k,
                         activation=cfg.activation, group_size=group,
                         capacity_factor=capacity_factor)
    return x + out, aux


# ---------------------------------------------------------------------------
# Whole-model passes
# ---------------------------------------------------------------------------


def _embed_input(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:  # gemma-style sqrt(d) scaling
        x = x * torch.tensor(float(cfg.d_model), dtype=x.dtype).sqrt().to(x.device)
    return x


def _head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    vv = cfg.vocab if cfg.padded_vocab != cfg.vocab else None
    if cfg.tie_embeddings:
        return heads_lib.lm_logits(x, params["embed"], tied=True, valid_vocab=vv)
    return heads_lib.lm_logits(x, params["lm_head"], valid_vocab=vv)


def _run_full(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *, kv_dtype: str = "bf16",
              moe_group: int = 512, moe_cf: float = TRAIN_CAPACITY_FACTOR):
    """Embedding + every layer over the whole sequence → (x, per-layer
    caches, summed MoE aux loss)."""
    x = _embed_input(params, cfg, tokens)
    b, length = tokens.shape
    pos = torch.arange(length, device=x.device).expand(b, length)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    kvs = []
    aux = torch.zeros((), device=x.device)
    for p, is_moe in _layers(params):
        x, kv = _self_attention_full(x, p, cos, sin, cfg, kv_dtype)
        x, a = _ffn_sublayer(x, p, cfg, is_moe, moe_group, moe_cf)
        aux = aux if a is None else aux + a
        kvs.append(kv)
    return x, kvs, aux


def forward(
    params: dict, cfg: ArchConfig, batch: dict, *, moe_group: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, L, V), the MoE layers' summed
    aux loss, 0 for dense)."""
    x, _, aux = _run_full(params, cfg, batch["tokens"], moe_group=moe_group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x), aux


def prefill(
    params: dict, cfg: ArchConfig, batch: dict, *, kv_dtype: str = "bf16",
    moe_group: int = 512,
) -> tuple[torch.Tensor, tuple]:
    """Prefill pass → (last-position logits (B, V), caches stacked over
    layers: (k, v), each (n_layers, B, L, K, D); for int8, (k, v, k_scale,
    v_scale) with the scales (n_layers, B, L, K, 1) f16)."""
    x, kvs, _ = _run_full(params, cfg, batch["tokens"], kv_dtype=kv_dtype,
                          moe_group=moe_group, moe_cf=PREFILL_CAPACITY_FACTOR)
    # "last_pos" supports right-padded prompts (serving buckets): logits are
    # taken at the true last prompt token, not the padded end.
    if "last_pos" in batch:
        last = torch.as_tensor(batch["last_pos"], device=x.device).long()
        x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    else:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, cfg, x)
    caches = tuple(torch.stack(leaves) for leaves in zip(*kvs))
    return logits[:, 0], caches


def decode_step(
    params: dict, cfg: ArchConfig, caches: tuple, batch: dict, *, kv_dtype: str = "bf16"
) -> tuple[torch.Tensor, tuple]:
    """One decode iteration. ``batch["index"]`` is the write position, a
    scalar or one per sequence; caches are ``(k, v)``, each
    ``(n_layers, B, S, K, D)``, or for int8 ``(k, v, k_scale, v_scale)``,
    and are updated in place. Each sequence's token is its own MoE group."""
    if len(caches) != (4 if kv_dtype == "int8" else 2):
        raise ValueError(f"{len(caches)} cache tensors for kv_dtype {kv_dtype!r}")
    k_all = caches[0]
    x = _embed_input(params, cfg, batch["tokens"])
    b = x.shape[0]
    index = torch.as_tensor(batch["index"], device=x.device).long().expand(b)
    cos, sin = rope_angles(index[:, None], cfg.head_dim, cfg.rope_theta)
    lengths = (index + 1).to(torch.int32)
    # the reference's dynamic_update_slice clamps the write into the cache
    write = index.clamp(max=k_all.shape[2] - 1)
    rows = torch.arange(b, device=x.device)
    for i, (p, is_moe) in enumerate(_layers(params)):
        x = _self_attention_decode(x, p, cos, sin, cfg, [c[i] for c in caches], rows, write, lengths)
        x, _ = _ffn_sublayer(x, p, cfg, is_moe, 1, DECODE_CAPACITY_FACTOR)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x)[:, 0], caches
