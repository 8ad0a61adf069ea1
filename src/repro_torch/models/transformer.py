"""Attention-transformer assembly: the dense, MoE, vlm and audio families
(counterpart of ``repro.models.transformer``).

Covers the llama-style stack the reference shares with yi-6b,
granite-3-8b, granite-34b, gemma-2b and llama3-70b (dense), with
qwen3-235b-a22b, llama4-scout and llama4-maverick (MoE, :mod:`moe`), with
qwen2-vl-7b (vlm: M-RoPE over three position streams, an embeddings
frontend) and with musicgen-medium (audio: an embeddings frontend,
cross-attention to a conditioning memory in every layer, four codebook
heads): RMS norm, GQA self-attention with half-split RoPE, a gated or
plain MLP or an MoE layer, and a bf16 KV cache or (``kv_dtype="int8"``) an
int8 one with one f16 scale per (position, head). The layer stack is a
Python loop over the stacked ``blocks`` parameters (the reference
``lax.scan``s over them): ``blocks`` is the dense layers' tree, or for MoE
``{"moe_block": …}``, with a ``"dense_block"`` beside it when
``moe_every == 2`` (maverick), each stacked over ``n_layers // moe_every``
steps; a step runs its dense block, then its MoE block.

The embeddings frontend takes ``batch["embeds"]`` (B, L, d_model) in the
model's dtype. The conditioning ``batch["memory"]`` (B, cross_mem_len,
d_model) is bf16 in the reference's ``input_specs`` whatever the model's
dtype: its projections cast it to the weights' dtype, where the reference's
einsums promote it. M-RoPE takes ``batch["positions"]`` (3, B, L) at
prefill and (3, B, 1), one column a sequence, at decode.

MoE groups: ``forward`` and ``prefill`` route ``moe_group`` tokens a group
(capacity factors 1.25 and 2.0); ``decode_step`` routes each sequence's
token as its own group (factor 4.0), as the reference's engine does by
``vmap``ping a one-token decode over its slots, so a free slot's stale row
never changes a busy slot's result.

The KV cache is one layer-ordered ``(n_layers, B, S, K, D)`` pair for every
family: for ``moe_every == 2``, layer 2i is step i's dense block and 2i + 1
its MoE block (the reference keeps ``{"dense_block": (k, v), "moe_block":
(k, v)}``, each over the steps). With cross-attention the cache is ``(k, v,
cross_k, cross_v)`` (int8: ``(k, v, k_scale, v_scale, cross_k, cross_v)``),
the cross leaves ``(n_layers, B, cross_mem_len, K, D)``: the memory's
projections, written at prefill and only read at decode, through the
flash kernel (non-causal, q of the prompt's length against the memory's)
and then the paged kernel (every memory position valid). Decode updates
the KV cache tensors in place (the reference returns new arrays); the
caches it returns are the ones it was given.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain, replicate_like
from repro_torch.kernels.ops import write_slot
from repro_torch.models import heads as heads_lib
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    embed_lookup,
    flash_attention,
    mlp,
    mrope_angles,
    residual,
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
from repro_torch.models.remat import remat as remat_layer

#: dtype of a KV cache that is not int8.
KV_DTYPE = torch.bfloat16

# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def attention_defs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    h, k, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    pre = "cross_" if cross else ""
    return {
        f"{pre}attn_norm": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
        f"{pre}w_q": ParamDef((d, h, dh), ("embed", "heads", "head_dim"), init="scaled"),
        f"{pre}w_k": ParamDef((d, k, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        f"{pre}w_v": ParamDef((d, k, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        f"{pre}w_o": ParamDef((h, dh, d), ("heads", "head_dim", "embed"), init="scaled"),
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


def _with_cross(cfg: ArchConfig, defs: dict) -> dict:
    """A layer's defs, with the cross-attention sublayer's where the config
    has one."""
    return {**defs, **attention_defs(cfg, cross=True)} if cfg.cross_attention else defs


def moe_layer_defs(cfg: ArchConfig) -> dict:
    return _with_cross(cfg, {
        **attention_defs(cfg),
        "mlp_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=torch.float32),
        "moe": moe_param_defs(cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                              cfg.n_shared_experts, cfg.activation),
    })


FAMILIES = ("dense", "moe", "vlm", "audio")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the reference's transformer rejects too."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")
    if cfg.pos_type not in ("rope", "mrope", "none"):
        raise ValueError(f"{cfg.name}: unknown pos_type {cfg.pos_type!r}")
    if cfg.frontend not in ("tokens", "embeddings"):
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")


def transformer_defs(cfg: ArchConfig) -> dict:
    """Full parameter tree for an attention-family architecture."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    dense = _with_cross(cfg, {**attention_defs(cfg), **mlp_defs(cfg)})
    if cfg.is_moe:
        if cfg.moe_every not in (1, 2):
            raise ValueError("moe_every must be 1 or 2")
        step = {"moe_block": moe_layer_defs(cfg)}
        if cfg.moe_every == 2:
            step["dense_block"] = dense
        blocks = stack_tree(step, cfg.n_layers // cfg.moe_every)
    else:
        blocks = stack_tree(dense, cfg.n_layers)
    defs: dict[str, Any] = {}
    if cfg.frontend == "tokens":
        defs["embed"] = ParamDef((v, d), ("vocab", "embed"), init="normal")
    defs["blocks"] = blocks
    defs["final_norm"] = ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32)
    if cfg.n_codebooks > 0:
        defs["codebook_heads"] = ParamDef(
            (cfg.n_codebooks, d, v), ("codebooks", "embed", "vocab"), init="scaled"
        )
    elif not cfg.tie_embeddings:
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
    ``moe_every == 2``). With cross-attention ``(cross_k, cross_v)``
    follow, each (n_layers, B, cross_mem_len, K, head_dim) in bf16."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        scale = (*shape[:-1], 1)
        specs = [(shape, torch.int8), (shape, torch.int8),
                 (scale, torch.float16), (scale, torch.float16)]
    else:
        specs = [(shape, KV_DTYPE)] * 2
    if cfg.cross_attention:
        cross = (cfg.n_layers, batch, cfg.cross_mem_len, cfg.n_kv_heads, cfg.head_dim)
        specs += [(cross, KV_DTYPE)] * 2
    return tuple(torch.zeros(sh, dtype=dt, device=device) for sh, dt in specs)


def cache_batch_axes(cfg: ArchConfig, kv_dtype: str = "bf16") -> tuple:
    """The slot axis of each cache tensor."""
    return (1,) * ((4 if kv_dtype == "int8" else 2) + 2 * cfg.cross_attention)


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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, L, d) x (d, heads, D) → (B, L, heads, D), x cast to w's dtype
    (where the reference's einsum promotes a bf16 input)."""
    b, l, d = x.shape
    return (x.to(w.dtype) @ w.reshape(d, -1)).view(b, l, *w.shape[1:])


def _project_qkv(x: torch.Tensor, p: dict):
    return _proj(x, p["w_q"]), _proj(x, p["w_k"]), _proj(x, p["w_v"])


def _out_proj(o: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    b, l = o.shape[:2]
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


def _rope(q, k, cos, sin):
    if cos is None:  # pos_type "none"
        return q, k
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _self_attention_full(x, p, cos, sin, cfg: ArchConfig, kv_dtype: str = "bf16"):
    """Train/prefill self-attention over the whole sequence; the cache it
    returns is (k, v), or quantized (k, v, k_scale, v_scale) for int8."""
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(xn, p)
    q, k = _rope(q, k, cos, sin)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    o = flash_attention(q, k, v, causal=True)
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return residual(x, _out_proj(o, p["w_o"])), (kq, vq, ks, vs)
    return residual(x, _out_proj(o, p["w_o"])), (k, v)


def _self_attention_decode(x, p, cos, sin, cfg: ArchConfig, cache, rows, write, lengths):
    """Single-token decode: write this token's K/V (quantized, for an int8
    cache) at ``write`` in place, then attend over the first ``lengths``
    positions of each slot; the paged kernel reads int8 pages and their
    scales as they are."""
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(xn, p)
    q, k = _rope(q, k, cos, sin)
    k_cache, v_cache = cache[:2]
    scales = cache[2:]
    if scales:
        kvq, kvs = quantize_kv(torch.stack([k[:, 0], v[:, 0]]))  # both in one pass
        write_slot(k_cache, kvq[0], rows, write)
        write_slot(v_cache, kvq[1], rows, write)
        write_slot(scales[0], kvs[0], rows, write)
        write_slot(scales[1], kvs[1], rows, write)
    else:
        write_slot(k_cache, k[:, 0].to(k_cache.dtype), rows, write)
        write_slot(v_cache, v[:, 0].to(v_cache.dtype), rows, write)
    o = decode_attention(q, k_cache, v_cache, lengths, *scales)
    return residual(x, _out_proj(o, p["w_o"]))


def _memory_kv(p: dict, memory: torch.Tensor):
    """The conditioning memory's cross-attention K/V, (B, M, K, D) each."""
    return _proj(memory, p["cross_w_k"]), _proj(memory, p["cross_w_v"])


def _cross_attention(x, p, memory_kv, cfg: ArchConfig, lengths=None):
    """Cross-attention to the memory's K/V: over the whole prompt at
    prefill (the flash kernel, non-causal), or, given ``lengths`` (every
    slot's memory length), one token a slot over the cross cache (the paged
    kernel)."""
    mk, mv = memory_kv
    xn = rms_norm(x, p["cross_attn_norm"], cfg.norm_eps)
    q = _proj(xn, p["cross_w_q"])
    if lengths is None:
        o = flash_attention(q, mk, mv, causal=False)
    else:
        o = decode_attention(q, mk, mv, lengths)
    return residual(x, _out_proj(o, p["cross_w_o"]))


def _ffn_sublayer(x, p, cfg: ArchConfig, is_moe: bool, group: int, capacity_factor: float):
    """The MLP or MoE sublayer → (x, aux loss or None)."""
    xn = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if not is_moe:
        return residual(x, mlp(xn, p, cfg.activation)), None
    out, aux = moe_layer(xn, p["moe"], n_experts=cfg.n_experts, top_k=cfg.top_k,
                         activation=cfg.activation, group_size=group,
                         capacity_factor=capacity_factor)
    return residual(x, out), aux


# ---------------------------------------------------------------------------
# Whole-model passes
# ---------------------------------------------------------------------------


def _embed_input(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if cfg.frontend != "tokens":
        return constrain(batch["embeds"], ("batch", None, "embed"))
    x = embed_lookup(batch["tokens"].long(), params["embed"])
    if cfg.tie_embeddings:  # gemma-style sqrt(d) scaling
        x = x * torch.tensor(float(cfg.d_model), dtype=x.dtype).sqrt().to(x.device)
    return constrain(x, ("batch", None, "embed"))


def _angles(cfg: ArchConfig, batch: dict, positions: torch.Tensor):
    """cos/sin of every position (``positions`` (B, L)), or of M-RoPE's
    three streams in ``batch["positions"]``; (None, None) for pos_type
    "none"."""
    if cfg.pos_type == "none":
        return None, None
    if cfg.pos_type == "mrope":
        pos = torch.as_tensor(batch["positions"], device=positions.device)
        return mrope_angles(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    vv = cfg.vocab if cfg.padded_vocab != cfg.vocab else None
    if cfg.n_codebooks > 0:
        return heads_lib.codebook_logits(x, params["codebook_heads"], valid_vocab=vv)
    if cfg.tie_embeddings:
        return heads_lib.lm_logits(x, params["embed"], tied=True, valid_vocab=vv)
    return heads_lib.lm_logits(x, params["lm_head"], valid_vocab=vv)


def _layer_full(x, p, is_moe: bool, cos, sin, memory, cfg: ArchConfig, kv_dtype: str,
                moe_group: int, moe_cf: float):
    """One layer over the whole sequence → (x, its cache leaves, MoE aux
    loss or None)."""
    x, kv = _self_attention_full(x, p, cos, sin, cfg, kv_dtype)
    if cfg.cross_attention:
        mkv = _memory_kv(p, memory)
        x = _cross_attention(x, p, mkv, cfg)
        kv = (*kv, *mkv)
    x, a = _ffn_sublayer(x, p, cfg, is_moe, moe_group, moe_cf)
    return x, kv, a


def _run_full(params: dict, cfg: ArchConfig, batch: dict, *, kv_dtype: str = "bf16",
              moe_group: int = 512, moe_cf: float = TRAIN_CAPACITY_FACTOR,
              remat: str = "none", keep_cache: bool = False):
    """Embedding + every layer over the whole sequence → (x, per-layer
    caches, summed MoE aux loss). Each layer runs under the
    rematerialization mode ``remat`` (the training pass's); the caches are
    kept only with ``keep_cache`` (prefill), else the list is empty."""
    x = _embed_input(params, cfg, batch)
    b, length = x.shape[:2]
    positions = replicate_like(torch.arange(length, device=x.device).expand(b, length), x)
    cos, sin = _angles(cfg, batch, positions)
    memory = batch.get("memory")
    kvs = []
    aux = torch.zeros((), device=x.device)
    for p, is_moe in _layers(params):
        args = (p, is_moe, cos, sin, memory, cfg, kv_dtype, moe_group, moe_cf)
        x, kv, a = remat_layer(lambda h, args=args: _layer_full(h, *args), remat)(x)
        if keep_cache:
            kvs.append(kv)
        aux = aux if a is None else aux + a
    return x, kvs, aux


def forward(
    params: dict, cfg: ArchConfig, batch: dict, *, moe_group: int = 512,
    remat: str = "none",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, L, V), or (B, L, n_codebooks, V)
    with codebook heads; the MoE layers' summed aux loss, 0 for dense).
    ``remat`` ("none", "full", "dots") is the training pass's per-layer
    rematerialization (:mod:`repro_torch.models.remat`). The reference's
    ``causal_mode`` has no counterpart: the flash kernel never visits the
    key blocks above the diagonal."""
    x, _, aux = _run_full(params, cfg, batch, moe_group=moe_group, remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x), aux


def loss_fn(
    params: dict, cfg: ArchConfig, batch: dict, *, remat: str = "none",
    aux_coeff: float = 0.01, moe_group: int = 512,
) -> tuple[torch.Tensor, dict]:
    """Training loss: cross-entropy of the forward's logits against
    ``batch["labels"]`` plus ``aux_coeff`` times the MoE aux loss → (total,
    metrics with ``loss``, ``accuracy``, ``aux_loss``, ``total_loss``)."""
    logits, aux = forward(params, cfg, batch, moe_group=moe_group, remat=remat)
    loss, metrics = heads_lib.softmax_xent(logits, batch["labels"])
    total = loss + aux_coeff * aux
    metrics["aux_loss"] = aux
    metrics["total_loss"] = total
    return total, metrics


def prefill(
    params: dict, cfg: ArchConfig, batch: dict, *, kv_dtype: str = "bf16",
    moe_group: int = 512,
) -> tuple[torch.Tensor, tuple]:
    """Prefill pass → (last-position logits (B, V) or (B, n_codebooks, V),
    caches stacked over layers: (k, v), each (n_layers, B, L, K, D); for
    int8, (k, v, k_scale, v_scale) with the scales (n_layers, B, L, K, 1)
    f16; with cross-attention (cross_k, cross_v) after them, each
    (n_layers, B, cross_mem_len, K, D))."""
    x, kvs, _ = _run_full(params, cfg, batch, kv_dtype=kv_dtype, moe_group=moe_group,
                          moe_cf=PREFILL_CAPACITY_FACTOR, keep_cache=True)
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
    scalar or one per sequence; M-RoPE's ``batch["positions"]`` are (3, B,
    1), one column a sequence. Caches are ``(k, v)``, each ``(n_layers, B,
    S, K, D)``, or for int8 ``(k, v, k_scale, v_scale)``, with ``(cross_k,
    cross_v)`` after them for cross-attention; the self-attention caches
    are updated in place. Each sequence's token is its own MoE group."""
    n_self = 4 if kv_dtype == "int8" else 2
    if len(caches) != n_self + 2 * cfg.cross_attention:
        raise ValueError(f"{len(caches)} cache tensors for kv_dtype {kv_dtype!r}")
    k_all = caches[0]
    x = _embed_input(params, cfg, batch)
    b = x.shape[0]
    index = replicate_like(torch.as_tensor(batch["index"], device=x.device), x).long().expand(b)
    cos, sin = _angles(cfg, batch, index[:, None])
    lengths = (index + 1).to(torch.int32)
    # the reference's dynamic_update_slice clamps the write into the cache
    write = index.clamp(max=k_all.shape[2] - 1)
    rows = torch.arange(b, device=x.device)
    if cfg.cross_attention:
        mem_lengths = replicate_like(torch.full((b,), caches[n_self].shape[2],
                                                dtype=torch.int32, device=x.device), x)
    for i, (p, is_moe) in enumerate(_layers(params)):
        layer = [c[i] for c in caches]
        x = _self_attention_decode(x, p, cos, sin, cfg, layer[:n_self], rows, write, lengths)
        if cfg.cross_attention:
            x = _cross_attention(x, p, layer[n_self:], cfg, mem_lengths)
        x, _ = _ffn_sublayer(x, p, cfg, is_moe, 1, DECODE_CAPACITY_FACTOR)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x)[:, 0], caches
