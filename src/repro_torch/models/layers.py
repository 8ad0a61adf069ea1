"""Shared neural building blocks (counterpart of ``repro.models.layers``).

bf16 compute with f32 accumulation, as in the reference. Attention goes
through :mod:`repro_torch.kernels.ops`: prefill to the flash kernel, decode
to the paged kernel over the slot cache viewed as pages. On DTensors every
tensor made here (RoPE tables, decode lengths) is replicated on the
inputs' mesh, and the reference's ``constrain`` points call the port's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import constrain, replicate_like
from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the reference's ``(1 + w)`` scaling, computed in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor table sharded on its vocab rows looks up
    on each rank the tokens its rows hold (the rest are zero) and returns
    a partial sum over the vocab's mesh axes, as Megatron's vocab-parallel
    embedding does; its gradient stays with the rows."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    tokens = replicate_like(tokens, table)
    t_pl = tuple(Shard(0) if p == Shard(0) and i not in vocab_dims else Replicate()
                 for i, p in enumerate(tokens.placements))
    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(t_pl)]
    grad_pl = tuple(table.placements[i] if i in vocab_dims
                    else Partial() if p == Shard(0) else Replicate() for i, p in enumerate(t_pl))

    def local(tok: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        first = 0
        for i in vocab_dims:  # DTensor nests the shards of one dim in mesh order
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        rel = tok - first * rows.shape[0]
        inside = ((rel >= 0) & (rel < rows.shape[0]))[..., None]
        picked = rows[rel.clamp(0, rows.shape[0] - 1)]
        return torch.where(inside, picked, torch.zeros((), dtype=rows.dtype, device=rows.device))

    return local_map(local, out_placements=out_pl, in_placements=(t_pl, table.placements),
                     in_grad_placements=(t_pl, grad_pl), device_mesh=mesh)(
        tokens.redistribute(mesh, t_pl), table)


def mlp(x: torch.Tensor, params: dict, activation: str) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain (gelu) feed-forward."""
    if activation in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        up = x @ params["w_up"]
        act = F.silu(gate) if activation == "swiglu" else F.gelu(gate, approximate="tanh")
        hidden = act * up
    elif activation == "gelu":
        hidden = F.gelu(x @ params["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    # the reference names the batch dimension None here, which would gather
    # the batch shards of every hidden activation; the port keeps them
    hidden = constrain(hidden, ("batch", None, "ffn"))
    return hidden @ params["w_down"]


def residual(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``x + out``, a sublayer's output laid out as the residual stream
    first: on DTensors that is the all-reduce of its partial sums over the
    model axis (left alone, DTensor would carry the whole residual stream
    as a partial sum and reduce it piecemeal at every use)."""
    return x + constrain(out, ("batch", None, "embed"))


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., L) → cos/sin (..., L, head_dim/2) in f32."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = replicate_like(1.0 / (theta ** exponents), positions)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(
    positions: torch.Tensor,  # (3, B, L): temporal / height / width streams
    head_dim: int,
    theta: float,
    sections: tuple[int, ...],
) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): the rotary pairs are split into ``sections``, each
    driven by its own position stream. Returns cos/sin (B, L, head_dim/2)
    in f32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    exponents = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = replicate_like(1.0 / (theta ** exponents), positions).split(list(sections))
    # each section's pairs driven by its own stream: (B, L, half)
    ang = torch.cat([positions[i].float()[..., None] * f for i, f in enumerate(freqs)], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding; x (..., L, H, D), cos/sin (..., L, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :] if cos.dim() == x.dim() - 1 else cos
    s = sin[..., None, :] if sin.dim() == x.dim() - 1 else sin
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, D)
    k: torch.Tensor,  # (B, Lk, K, D)
    v: torch.Tensor,  # (B, Lk, K, D)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Prefill attention, any length (the reference's chunked jnp version
    needs L to divide its 512-token chunk)."""
    return ops.flash_attention(q, k, v, causal=causal)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, K, D)
    v_cache: torch.Tensor,  # (B, S, K, D)
    cur_len: torch.Tensor | int,  # valid cache length (scalar or (B,))
    k_scale: torch.Tensor | None = None,  # (B, S, K, 1) for an int8 cache
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-step attention over the slot cache; positions ≥ cur_len are
    masked (and never read by the kernel)."""
    b = q.shape[0]
    if isinstance(cur_len, int):
        lengths = replicate_like(torch.full((b,), cur_len, dtype=torch.int32, device=q.device), q)
    else:
        lengths = cur_len.to(device=q.device, dtype=torch.int32).expand(b).contiguous()
    return ops.slot_decode_attention(q, k_cache, v_cache, lengths, k_scale, v_scale)
