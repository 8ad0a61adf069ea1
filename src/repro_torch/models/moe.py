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

On DTensors (the sharded path) the layer runs on each rank's shards
through ``local_map``: the tokens whole over the model axis (their batch
shards kept), the router whole, the expert weights on the shards they were
placed on (``experts``, the reference's constraint on ``expert_in`` and
``eo``; or ``ffn`` where the experts do not divide the axis) and the shared
expert on its ``ffn`` shards. Each rank routes its tokens over every
expert, as one process does, takes its own experts' columns of the combine
tensor, runs their FFN and combines: its output is a partial sum over the
ranks, which the caller's residual reduces in one all-reduce, and no
expert weight moves. The load-balancing terms come from the first rank of
the model axis (the others add zeros), so their gradient is counted once.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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
             capacity_factor: float, first: int):
    """One set of equal groups xg (G, g, d) → (out (G, g, d), per-group
    balance terms (G,)). The experts' FFN is the dense MLP batched over
    the expert axis: (E, G*C, d) against (E, d, f) weights. Given the
    weights of ``E_l`` < ``n_exp`` experts (one rank's shard), those are
    experts ``first`` to ``first + E_l - 1``, and only their columns of the
    combine tensor are dispatched and combined."""
    n_groups, g, d = xg.shape
    capacity = max(top_k, min(g, int(g * top_k * capacity_factor / n_exp)))
    combine, balance = _route(xg, params["router"], top_k, capacity)
    n_loc = params["w_up"].shape[0]
    if n_loc != n_exp:
        combine = combine[:, :, first:first + n_loc]

    flat = combine.reshape(n_groups, g, n_loc * capacity)
    dispatch = (flat > 0).to(xg.dtype)
    expert_in = torch.bmm(dispatch.transpose(1, 2), xg)  # (G, E*C, d)
    per_expert = expert_in.view(n_groups, n_loc, capacity, d).transpose(0, 1)
    eo = mlp(per_expert.reshape(n_loc, n_groups * capacity, d), params, activation)
    eo = eo.view(n_loc, n_groups, capacity, d).transpose(0, 1).reshape(n_groups, -1, d)
    out = torch.bmm(flat.to(xg.dtype), eo)  # (G, g, d)

    if "shared" in params:
        out = out + mlp(xg, params["shared"], activation)
    return out, balance


def _moe(x: torch.Tensor, params: dict, *, group: int, first: int = 0, **kw):
    """The layer on plain tensors, tokens in groups of ``group`` and a
    ragged last one → (out (B, L, d) in x's dtype, balance terms a group
    (G,) f32)."""
    b, l, d = x.shape
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    n_full = n_tok // group * group
    parts = [tokens[:n_full].view(-1, group, d)]
    if n_full < n_tok:  # the ragged last group
        parts.append(tokens[n_full:][None])
    outs, balances = zip(*(_grouped(p, params, first=first, **kw) for p in parts))
    out = torch.cat([o.reshape(-1, d) for o in outs]).view(b, l, d)
    return out.to(x.dtype), torch.cat(balances)


def _moe_on_shards(x: DTensor, params: dict, *, group: int, **kw):
    """:func:`_moe` on each rank's shards (the module docstring) → (out,
    balance terms), each a partial sum over the mesh dims the weights
    shard and batch-sharded as ``x``."""
    from repro_torch.training.tree import leaves, unflatten  # training imports the models

    mesh = x.device_mesh
    weights = leaves(params)
    router = [w is params["router"] for w in weights]
    ep = sorted({i for w, r in zip(weights, router) if not r
                 for i, p in enumerate(w.placements) if isinstance(p, Shard)})
    for w, r in zip(weights, router):
        if not r and any(not isinstance(w.placements[i], Shard) for i in ep):
            raise ValueError(f"an MoE weight {tuple(w.shape)} is not sharded on every mesh dim "
                             f"another is ({w.placements}): its output would not be a partial sum")
    batch = [i for i, p in enumerate(x.placements) if p == Shard(0) and i not in ep]

    def layout(on_ep, on_batch) -> tuple:
        """Placements: ``on_ep`` (one, or one a mesh dim) on the weights'
        dims, ``on_batch`` on x's batch dims, replicated elsewhere."""
        return tuple((on_ep[i] if isinstance(on_ep, tuple) else on_ep) if i in ep
                     else on_batch if i in batch else Replicate() for i in range(mesh.ndim))

    x_pl, out_pl = layout(Replicate(), Shard(0)), layout(Partial(), Shard(0))
    w_in = [layout(Replicate() if r else tuple(w.placements), Replicate())
            for w, r in zip(weights, router)]
    w_grad = [layout(Partial() if r else tuple(w.placements), Partial())
              for w, r in zip(weights, router)]
    w_up = params["w_up"]
    expert_dims = [i for i in ep if w_up.placements[i] == Shard(0)]
    n_batch = math.prod(mesh.size(i) for i in batch)
    if n_batch > 1 and (x.shape[0] // n_batch * x.shape[1]) % group:
        raise ValueError(f"groups of {group} tokens would straddle the batch shards of "
                         f"{tuple(x.shape)} over {n_batch} ranks")

    def local(x_l, *w_l):
        tree = unflatten(params, w_l)
        rank = 0
        for i in expert_dims:  # DTensor nests the shards of one dim in mesh order
            rank = rank * mesh.size(i) + mesh.get_local_rank(i)
        out, balances = _moe(x_l, tree, group=group, first=rank * tree["w_up"].shape[0], **kw)
        lead = all(mesh.get_local_rank(i) == 0 for i in ep)
        return out, balances if lead else torch.zeros_like(balances)

    return local_map(
        local, out_placements=(list(out_pl), list(out_pl)),
        in_placements=(x_pl, *w_in), in_grad_placements=(out_pl, *w_grad), device_mesh=mesh,
    )(x.redistribute(mesh, x_pl), *(w.redistribute(mesh, p) for w, p in zip(weights, w_in)))


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
    E·mean over groups of Σ_e f_e·p_e, f32). DTensors run on their shards
    (the module docstring): the output is then a partial sum over the
    model axis."""
    b, l, _ = x.shape
    kw = dict(n_exp=n_experts, top_k=top_k, activation=activation,
              capacity_factor=capacity_factor, group=min(group_size, b * l))
    out, balances = (_moe_on_shards if isinstance(x, DTensor) else _moe)(x, params, **kw)
    aux = n_experts * balances.mean()
    return out, aux.float()
