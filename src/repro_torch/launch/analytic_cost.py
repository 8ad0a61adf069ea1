"""Analytic whole-program cost model: exact FLOPs and an HBM-traffic
estimate (the port's copy of ``repro.launch.analytic_cost``, over
``repro_torch.configs``; the arithmetic is the reference's, term for term).

Every einsum of the model zoo is known, so the FLOP count here is exact;
HBM bytes follow a standard traffic model (weights read per pass,
residual-stream activations, flash-KV restreaming, cache reads, optimizer
state), each term annotated below. The reference needed it because XLA's
``cost_analysis`` counts a ``while`` body once; the port's eager step has
no such count at all, so this is its only whole-step FLOP and byte count.

All numbers are GLOBAL (whole step, all ranks); the roofline divides by the
rank count. Collective bytes are not modelled here: they come from the
collectives the step issues (:mod:`repro_torch.launch.comm_count`).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, ShapeCell


@dataclasses.dataclass
class CellCost:
    flops_fwd: float
    flops_total: float  # with train multiplier if applicable
    hbm_bytes: float
    detail: dict

    def as_dict(self) -> dict:
        return {
            "flops_fwd": self.flops_fwd,
            "flops_total": self.flops_total,
            "hbm_bytes": self.hbm_bytes,
            "detail": self.detail,
        }


def _attn_layer_flops(cfg, b, l, l_kv, *, causal_frac, decode=False):
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = 2 * b * l * d * (h + 2 * k) * dh
    if decode:
        attn = 4 * b * h * dh * l_kv
    else:
        attn = 4 * b * h * dh * l * l_kv * causal_frac
    o = 2 * b * l * h * dh * d
    return qkv + attn + o


def _mlp_flops(cfg, b, l):
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return 2 * mats * b * l * cfg.d_model * cfg.d_ff


def _moe_flops(cfg, b, l, capacity_factor):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    tokens = b * l
    g = min(512, tokens)
    n_groups = tokens // g
    cap = max(cfg.top_k, min(g, int(g * cfg.top_k * capacity_factor / e)))
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    router = 2 * tokens * d * e
    dispatch = 2 * n_groups * g * e * cap * d * 2  # dispatch + combine
    experts = 2 * mats * n_groups * e * cap * d * f
    shared = (
        2 * mats * tokens * d * f * cfg.n_shared_experts
        if cfg.n_shared_experts
        else 0
    )
    return router + dispatch + experts + shared


def _cross_attn_flops(cfg, b, l):
    d, h, k, dh, m = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.cross_mem_len,
    )
    return (
        2 * b * l * d * h * dh  # q
        + 2 * b * m * d * 2 * k * dh  # k, v (per layer; no caching assumed)
        + 4 * b * h * dh * l * m  # scores + pv
        + 2 * b * l * h * dh * d  # o
    )


def _mamba_flops(cfg, b, l, decode=False):
    d, di, n, hs = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    p = cfg.ssm_head_dim
    proj = 2 * b * l * d * (2 * di + 2 * n + hs)
    conv = 2 * b * l * (di + 2 * n) * cfg.ssm_conv
    if decode:
        ssd = 4 * b * hs * p * n  # single-step state update + read
    else:
        q = min(128, l)
        ssd = (
            2 * b * hs * l * q * n  # C·B Gram
            + 2 * b * hs * l * q * p  # intra combine
            + 4 * b * hs * l * p * n  # state in + cross read
        )
    out = 2 * b * l * di * d
    return proj + conv + ssd + out


def _mlstm_flops(cfg, b, l, decode=False):
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads
    hd = di // h
    up = 2 * b * l * d * 2 * di
    qkv = 3 * 2 * b * l * di * (di // h)  # block-diagonal per head
    gates = 2 * 2 * b * l * di * h
    if decode:
        cell = 4 * b * h * hd * hd
    else:
        q = min(128, l)
        cell = 4 * b * h * l * q * hd + 4 * b * h * l * hd * hd
    down = 2 * b * l * di * d
    return up + qkv + gates + cell + down


def _slstm_flops(cfg, b, l):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    d_up = (((4 * d) // 3 + 127) // 128) * 128
    gates = 4 * 2 * b * l * d * d
    recur = 4 * 2 * b * l * h * hd * hd
    out = 2 * b * l * d * d
    mlp = 2 * 2 * b * l * d * d_up
    return gates + recur + out + mlp


def forward_flops(
    cfg: ArchConfig,
    cell: ShapeCell,
    *,
    causal_mode: str = "masked",
    moe_cf: float = 1.25,
) -> dict:
    """Global forward FLOPs, by component."""
    b = cell.global_batch
    decode = cell.kind == "decode"
    l = 1 if decode else cell.seq_len
    l_kv = cell.seq_len
    causal_frac = 0.5 if causal_mode == "triangle" else 1.0

    detail: dict[str, float] = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        attn = cfg.n_layers * _attn_layer_flops(
            cfg, b, l, l_kv if decode else l,
            causal_frac=causal_frac, decode=decode,
        )
        detail["attention"] = attn
        if cfg.is_moe:
            n_moe = cfg.n_layers // cfg.moe_every
            n_dense = cfg.n_layers - n_moe
            detail["moe"] = n_moe * _moe_flops(cfg, b, l, moe_cf)
            detail["mlp"] = n_dense * _mlp_flops(cfg, b, l)
        else:
            detail["mlp"] = cfg.n_layers * _mlp_flops(cfg, b, l)
        if cfg.cross_attention:
            detail["cross_attention"] = cfg.n_layers * _cross_attn_flops(
                cfg, b, l
            )
    elif cfg.family == "hybrid":
        n_inv = cfg.n_layers // cfg.attn_every
        detail["mamba"] = cfg.n_layers * _mamba_flops(cfg, b, l, decode)
        detail["attention"] = n_inv * (
            _attn_layer_flops(
                cfg, b, l, l_kv if decode else l,
                causal_frac=causal_frac, decode=decode,
            )
            + _mlp_flops(cfg, b, l)
        )
    elif cfg.family == "ssm":
        n_groups = cfg.n_layers // cfg.slstm_every
        n_m = n_groups * (cfg.slstm_every - 1)
        detail["mlstm"] = n_m * _mlstm_flops(cfg, b, l, decode)
        detail["slstm"] = n_groups * _slstm_flops(cfg, b, l)
    else:
        raise ValueError(cfg.family)

    head_positions = b * (l if cell.kind == "train" else 1)
    heads = max(1, cfg.n_codebooks)
    detail["head"] = 2 * head_positions * cfg.d_model * cfg.padded_vocab * heads
    if cell.kind == "train":
        detail["xent"] = 3 * b * l * cfg.padded_vocab * heads
    return detail


def hbm_bytes(
    cfg: ArchConfig,
    cell: ShapeCell,
    param_count: int,
    *,
    optimizer: str = "adamw",
    kv_dtype: str = "bf16",
) -> dict:
    """Global HBM traffic model (bytes), by component.

    weights      — one full bf16 read per forward pass; train does fwd +
                   remat-fwd + bwd (3 reads) + grad write/read (2+2) and
                   optimizer traffic (AdamW: m,v fp32 read+write = 16 B/p +
                   param write 2; Adafactor ≈ 2 B/p).
    activations  — residual-stream traffic ≈ 8 reads/writes of (B,L,D)
                   per layer per pass (qkv/attn/mlp boundaries).
    flash_kv     — prefill/train attention restreams K,V once per q-chunk.
    kv_cache     — decode reads the whole cache once per step (+tiny write);
                   prefill writes it once.
    logits       — written + read by the loss (train), or last-position
                   only (serve).
    """
    b = cell.global_batch
    decode = cell.kind == "decode"
    l = 1 if decode else cell.seq_len
    s = cell.seq_len
    d = cfg.d_model
    bpe = 2  # bf16
    train = cell.kind == "train"

    detail: dict[str, float] = {}
    w_bytes = param_count * bpe
    if train:
        opt_traffic = 18.0 if optimizer == "adamw" else 4.0
        detail["weights"] = w_bytes * (3 + 2 + 2) + param_count * opt_traffic
    else:
        detail["weights"] = w_bytes

    act_passes = 3 if train else 1
    detail["activations"] = 8.0 * cfg.n_layers * b * l * d * bpe * act_passes

    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid") and not decode:
        n_attn = (
            cfg.n_layers
            if cfg.family != "hybrid"
            else cfg.n_layers // cfg.attn_every
        )
        nq = max(1, l // 512)
        kv_bytes_layer = 2 * b * l * cfg.n_kv_heads * cfg.head_dim * bpe
        detail["flash_kv"] = n_attn * nq * kv_bytes_layer * act_passes
        detail["kv_cache_write"] = (
            n_attn * kv_bytes_layer if cell.kind == "prefill" else 0.0
        )
    if decode:
        n_attn = (
            cfg.n_layers
            if cfg.family in ("dense", "moe", "vlm", "audio")
            else (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0)
        )
        # int8 KV: 1 byte/element + fp16 scale per (pos, head) ≈ 1.02 B/elem
        kv_bpe = (1.0 + 2.0 / cfg.head_dim) if kv_dtype == "int8" else bpe
        detail["kv_cache_read"] = (
            n_attn * 2 * b * s * cfg.n_kv_heads * cfg.head_dim * kv_bpe
        )
        if cfg.family == "hybrid":
            detail["ssm_state"] = (
                2 * cfg.n_layers * b * cfg.n_ssm_heads * cfg.ssm_head_dim
                * cfg.ssm_state * 4
            )
        if cfg.family == "ssm":
            di = 2 * d
            hd = di // cfg.n_heads
            detail["mlstm_state"] = (
                2 * cfg.n_layers * b * cfg.n_heads * hd * hd * 4
            )

    heads = max(1, cfg.n_codebooks)
    logit_positions = b * (l if train else 1)
    detail["logits"] = 2.0 * logit_positions * cfg.padded_vocab * heads * bpe
    return detail


def cell_cost(
    cfg: ArchConfig,
    cell: ShapeCell,
    param_count: int,
    *,
    causal_mode: str = "masked",
    moe_cf: float = 1.25,
    optimizer: str = "adamw",
    remat: str = "full",
    kv_dtype: str = "bf16",
) -> CellCost:
    fwd = forward_flops(cfg, cell, causal_mode=causal_mode, moe_cf=moe_cf)
    fwd_total = sum(fwd.values())
    if cell.kind == "train":
        # fwd (1×) + bwd (2×) + remat recompute: full policy recomputes the
        # whole forward (1×); dots-saved policy recomputes only the cheap
        # non-matmul ops (~0.2×); no remat recomputes nothing.
        mult = {"full": 4.0, "dots": 3.2, "none": 3.0}.get(str(remat), 4.0)
        total = fwd_total * mult
    else:
        total = fwd_total
    mem = hbm_bytes(
        cfg, cell, param_count, optimizer=optimizer, kv_dtype=kv_dtype
    )
    return CellCost(
        flops_fwd=fwd_total,
        flops_total=total,
        hbm_bytes=sum(mem.values()),
        detail={"flops": fwd, "bytes": mem},
    )
