"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``).

Top-k routing with capacity-bounded dispatch and combine products, tokens
taken in groups of ``group_size`` in token order, as the reference does:
f32 router logits and softmax, the top-k gates renormalised, the Switch
load-balancing loss, a capacity of ``max(top_k, min(g, int(g * top_k *
cf / E)))`` rows an expert and group, drops in token order, and the
shared expert added on the whole group. Every expert runs on its whole
capacity buffer (empty rows included), so the layer reads every expert's
weights and needs no per-expert count on the host.

One deliberate difference: where the reference counts each of the top-k
passes' buffer positions from zero (``moe.py:120-135``), so that with
``top_k > 1`` two tokens of a group can share an (expert, position) row
and the expert is fed the sum of their inputs, the port numbers a group's
choices token-major: token t's choices come after every choice of the
tokens before it, so no two share a row, and drops follow token order
(a right-padded prompt's pad tokens, last in the group, never push out
a prompt token's choice). For ``top_k = 1``, or one token a group, the two
are the same function; for ``top_k > 1`` the port equals the reference
called one token at a time wherever capacity does not bind (ROADMAP.md,
C, R2).

A last group shorter than ``group_size`` (the reference raises) takes its
capacity from its own length.

Used by llama4-scout (16 experts, top-1, one shared), llama4-maverick (128
experts, top-1, one shared, every other layer) and qwen3-235b (128 experts,
top-8).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import mlp
from repro_torch.models.params import ParamDef

#: Capacity factors per mode: the GShard standard in training, factors
#: large enough at serving that drops are rare (vLLM's dropless MoE).
TRAIN_CAPACITY_FACTOR = 1.25
PREFILL_CAPACITY_FACTOR = 2.0
DECODE_CAPACITY_FACTOR = 4.0


def moe_param_defs(
    d_model: int, d_ff: int, n_experts: int, n_shared: int, activation: str
) -> dict:
    """Parameter declarations for one MoE layer (the router stays f32)."""
    e3, e3_t = ("experts", "embed", "ffn"), ("experts", "ffn", "embed")
    gated = activation in ("swiglu", "geglu")
    defs: dict = {
        "router": ParamDef((d_model, n_experts), ("embed", None), init="scaled",
                           dtype=torch.float32),
        "w_up": ParamDef((n_experts, d_model, d_ff), e3, init="scaled"),
        "w_down": ParamDef((n_experts, d_ff, d_model), e3_t, init="scaled"),
    }
    if gated:
        defs["w_gate"] = ParamDef((n_experts, d_model, d_ff), e3, init="scaled")
    if n_shared > 0:
        f = n_shared * d_ff
        sh = {
            "w_up": ParamDef((d_model, f), ("embed", "ffn"), init="scaled"),
            "w_down": ParamDef((f, d_model), ("ffn", "embed"), init="scaled"),
        }
        if gated:
            sh["w_gate"] = ParamDef((d_model, f), ("embed", "ffn"), init="scaled")
        defs["shared"] = sh
    return defs


def _route(xg: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int):
    """Router of one set of equal groups xg (G, g, d) → (combine (G, g, E, C)
    f32, per-group Σ_e f_e·p_e (G,))."""
    n_groups, g, _ = xg.shape
    n_exp = router.shape[1]
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)  # (G, g, E)
    experts = torch.arange(n_exp, device=xg.device)
    # Switch §2.2: the mean router probability times the fraction of tokens
    # whose first choice is each expert
    frac = (probs.argmax(-1)[..., None] == experts).float().mean(1)
    balance = (probs.mean(1) * frac).sum(-1)

    gate, idx = probs.topk(top_k, dim=-1)  # (G, g, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # buffer positions token-major: a choice's position is how many choices
    # of earlier tokens (and of its own token's earlier passes) picked its
    # expert
    hits = (idx.reshape(n_groups, g * top_k, 1) == experts).int()  # (G, g*k, E)
    pos = ((hits.cumsum(1) * hits).sum(-1) - 1).view(n_groups, g, top_k)
    kept = pos < capacity
    # A token's k choices are k distinct experts, so its kept targets never
    # collide; a dropped choice goes to a spare last column, cut off below.
    target = torch.where(kept, idx * capacity + pos, n_exp * capacity)
    combine = torch.zeros(n_groups, g, n_exp * capacity + 1, device=xg.device)
    combine.scatter_(2, target, gate * kept)
    return combine[..., :-1].view(n_groups, g, n_exp, capacity), balance


def _grouped(xg: torch.Tensor, params: dict, *, n_exp: int, top_k: int, activation: str,
             capacity_factor: float):
    """One set of equal groups xg (G, g, d) → (out (G, g, d), per-group
    balance terms (G,)). The experts' FFN is the dense MLP batched over
    the expert axis: (E, G*C, d) against (E, d, f) weights."""
    n_groups, g, d = xg.shape
    capacity = max(top_k, min(g, int(g * top_k * capacity_factor / n_exp)))
    combine, balance = _route(xg, params["router"], top_k, capacity)

    flat = combine.view(n_groups, g, n_exp * capacity)
    dispatch = (flat > 0).to(xg.dtype)
    expert_in = torch.bmm(dispatch.transpose(1, 2), xg)  # (G, E*C, d)
    per_expert = expert_in.view(n_groups, n_exp, capacity, d).transpose(0, 1)
    eo = mlp(per_expert.reshape(n_exp, n_groups * capacity, d), params, activation)
    eo = eo.view(n_exp, n_groups, capacity, d).transpose(0, 1).reshape(n_groups, -1, d)
    out = torch.bmm(flat.to(xg.dtype), eo)  # (G, g, d)

    if "shared" in params:
        out = out + mlp(xg, params["shared"], activation)
    return out, balance


def moe_layer(
    x: torch.Tensor,  # (B, L, d_model)
    params: dict,
    *,
    n_experts: int,
    top_k: int,
    activation: str,
    group_size: int = 512,
    capacity_factor: float = TRAIN_CAPACITY_FACTOR,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, L, d_model) in x's dtype, the load-balancing loss
    E·mean over groups of Σ_e f_e·p_e, f32)."""
    b, l, d = x.shape
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    g = min(group_size, n_tok)
    n_full = n_tok // g * g
    parts = [tokens[:n_full].view(-1, g, d)]
    if n_full < n_tok:  # the ragged last group
        parts.append(tokens[n_full:][None])
    kw = dict(n_exp=n_experts, top_k=top_k, activation=activation,
              capacity_factor=capacity_factor)
    outs, balances = zip(*(_grouped(p, params, **kw) for p in parts))
    out = torch.cat([o.reshape(-1, d) for o in outs]).view(b, l, d)
    aux = n_experts * torch.cat(balances).mean()
    return out.to(x.dtype), aux.float()
