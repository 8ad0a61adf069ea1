"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, recurrent) [arXiv:2405.04517] (counterpart of
``repro.models.xlstm``).

mLSTM recurrence per head (state C ∈ R^{dv×dk}, normalizer n ∈ R^{dk}):

    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t · q_t|, 1)

with sigmoid forget gates and soft-capped exponential input gates (|ĩ| ≤ 5
through a tanh cap), as the reference. The chunkwise form is the SSD
scan's dual form with a normalizer; the state and every gate are f32.

One deliberate difference: the reference's :func:`mlstm_chunked` raises
when ``chunk`` does not divide L (so it cannot prefill a 200-token
prompt). The port pads the last chunk, and pads exactly: at a pad position
the input gate is 0 and log f is 0, so a pad adds nothing to C or n and
decays nothing, and the pads' outputs are dropped. (Padding the gate's
preactivation could not do it: the capped gate exp(5·tanh(ĩ/5)) is never
0.)

The causal decay inside a chunk, exp(cum_t − cum_j), is taken only where
j ≤ t: above the diagonal the exponent is ≥ 0 and may overflow, so it is
masked to −inf before the exp, never multiplied by a 0/1 mask.

sLSTM keeps per-head-channel scalar state with block-diagonal recurrent
weights, which forces a sequential loop over positions (the reference's
``lax.scan``).

On DTensors (the sharded path) the blocks shard as the reference lays
them out: the up-projections and ``skip`` on "ffn", the per-head weights
on "heads" (replicated where the heads do not divide the model axis). The
mLSTM and sLSTM recurrences, independent per (sequence, head), run on each
rank's local shards (:func:`~repro_torch.kernels.ops.on_head_shards`), so
their loops dispatch plain tensor ops and their constants stay plain; the
gate preactivations, which read the whole up-projection, are reduced onto
the heads' shards first. Each block's output is a partial sum over the
model axis that the residual reduces
(:func:`~repro_torch.models.layers.residual`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.ops import on_head_shards
from repro_torch.models.layers import residual, rms_norm
from repro_torch.models.params import ParamDef

GATE_CAP = 5.0


def _capped_exp_gate(pre: torch.Tensor) -> torch.Tensor:
    """exp of the tanh-capped preactivation, in f32."""
    return torch.exp(GATE_CAP * torch.tanh(pre.float() / GATE_CAP))


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel and single step
# ---------------------------------------------------------------------------


def mlstm_chunked(
    q: torch.Tensor,  # (B, L, H, Dk)
    k: torch.Tensor,  # (B, L, H, Dk)
    v: torch.Tensor,  # (B, L, H, Dv)
    i_pre: torch.Tensor,  # (B, L, H) input-gate preactivation
    f_pre: torch.Tensor,  # (B, L, H) forget-gate preactivation
    *,
    chunk: int = 128,
    initial_state: Optional[tuple[torch.Tensor, torch.Tensor]] = None,  # (C, n)
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (h (B, L, H, Dv) in v's dtype, (C (B, H, Dv, Dk), n (B, H,
    Dk)) in f32). Any L: the last chunk is padded exactly."""
    bsz, length, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, length)
    nck = -(-length // chunk)
    pad = nck * chunk - length

    qf = q.float() / math.sqrt(dk)
    kf, vf = k.float(), v.float()
    ig = _capped_exp_gate(i_pre)
    log_f = F.logsigmoid(f_pre.float())
    if pad:  # pads: gate 0, log f 0 (no input, no decay); outputs dropped
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        ig, log_f = (F.pad(t, (0, 0, 0, pad)) for t in (ig, log_f))

    qc = qf.reshape(bsz, nck, chunk, h, dk)
    kc = kf.reshape(bsz, nck, chunk, h, dk)
    vc = vf.reshape(bsz, nck, chunk, h, dv)
    ic = ig.reshape(bsz, nck, chunk, h)
    cum = log_f.reshape(bsz, nck, chunk, h).cumsum(dim=2)  # inclusive

    # intra-chunk: h_intra[t] = Σ_{j≤t} (q_t·k_j) exp(cum_t − cum_j) i_j v_j
    qk = torch.einsum("bkthd,bkjhd->bkhtj", qc, kc)
    cum_h = cum.permute(0, 1, 3, 2)  # (B, nck, H, Q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]  # (B, nck, H, t, j)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    decay = seg.masked_fill(~causal, float("-inf")).exp()
    w = qk * decay * ic.permute(0, 1, 3, 2)[:, :, :, None, :]  # i_j on axis j
    h_intra = torch.einsum("bkhtj,bkjhv->bkthv", w, vc)
    norm_intra = w.sum(dim=-1).permute(0, 1, 3, 2)  # (B, nck, t, H)

    total = cum[:, :, -1, :]  # (B, nck, H)
    state_w = torch.exp(total[:, :, None, :] - cum) * ic  # (B, nck, Q, H)
    c_in = torch.einsum("bkjhv,bkjhd,bkjh->bkhvd", vc, kc, state_w)
    n_in = torch.einsum("bkjhd,bkjh->bkhd", kc, state_w)
    read_w = torch.exp(cum)  # (B, nck, Q, H)

    if initial_state is None:
        c_prev = torch.zeros(bsz, h, dv, dk, dtype=torch.float32, device=q.device)
        n_prev = torch.zeros(bsz, h, dk, dtype=torch.float32, device=q.device)
    else:
        c_prev, n_prev = (t.float() for t in initial_state)
    outs = []
    for c in range(nck):
        q_blk, r_w = qc[:, c], read_w[:, c]
        h_num = h_intra[:, c] + torch.einsum("bthd,bhvd->bthv", q_blk, c_prev) * r_w[..., None]
        nm = norm_intra[:, c] + torch.einsum("bthd,bhd->bth", q_blk, n_prev) * r_w
        outs.append(h_num / nm.abs().clamp_min(1.0)[..., None])
        dec = torch.exp(total[:, c])
        c_prev = dec[:, :, None, None] * c_prev + c_in[:, c]
        n_prev = dec[:, :, None] * n_prev + n_in[:, c]
    h_out = torch.stack(outs, dim=1).reshape(bsz, nck * chunk, h, dv)[:, :length]
    return h_out.to(v.dtype), (c_prev, n_prev)


def mlstm_step(
    q: torch.Tensor,  # (B, H, Dk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, Dv)
    i_pre: torch.Tensor,  # (B, H)
    f_pre: torch.Tensor,
    state: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One token of the recurrence → (h (B, H, Dv) in v's dtype, (C, n))."""
    c_prev, n_prev = state
    qf = q.float() / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    ig = _capped_exp_gate(i_pre)
    fg = torch.sigmoid(f_pre.float())
    c_new = fg[..., None, None] * c_prev + ig[..., None, None] * vf[..., :, None] * kf[..., None, :]
    n_new = fg[..., None] * n_prev + ig[..., None] * kf
    num = torch.einsum("bhd,bhvd->bhv", qf, c_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new).abs().clamp_min(1.0)
    return (num / den[..., None]).to(v.dtype), (c_new, n_new)


# ---------------------------------------------------------------------------
# sLSTM cell: sequential loop
# ---------------------------------------------------------------------------


def slstm_scan(
    z_pre: torch.Tensor,  # (B, L, H, D) cell-input preactivation
    i_pre: torch.Tensor,  # (B, L, H, D)
    f_pre: torch.Tensor,
    o_pre: torch.Tensor,
    r_z: torch.Tensor,  # (H, D, D) block-diagonal recurrent weights
    r_i: torch.Tensor,
    r_f: torch.Tensor,
    r_o: torch.Tensor,
    *,
    initial_state: Optional[tuple] = None,  # (c, n, h, m)
) -> tuple[torch.Tensor, tuple]:
    """Stabilized exponential-gated scalar LSTM (per head-channel state).
    Without ``initial_state`` it starts from (c, n, h, m) = (0, 1e-6, 0,
    -10), as the reference does. Returns (h (B, L, H, D) in z_pre's dtype,
    the final (c, n, h, m) in f32)."""
    bsz, length, h, d = z_pre.shape
    if z_pre.device.type == "meta":  # shapes only, as the dry run runs it
        out = _SLSTMShapes.apply(z_pre, i_pre, f_pre, o_pre, r_z, r_i, r_f, r_o,
                                 *(initial_state or ()))
        return out[0], out[1:]
    if initial_state is None:
        zeros = torch.zeros(bsz, h, d, dtype=torch.float32, device=z_pre.device)
        c, n, h_prev, m = zeros, zeros + 1e-6, zeros, zeros - 10.0
    else:
        c, n, h_prev, m = (s.float() for s in initial_state)
    recs = torch.stack([r.float() for r in (r_z, r_i, r_f, r_o)], dim=1)  # (H, 4, D, D)
    pres = torch.stack([t.float() for t in (z_pre, i_pre, f_pre, o_pre)], dim=3)  # (B, L, H, 4, D)
    hs = []
    for t in range(length):
        rec = torch.einsum("bhd,hgde->bhge", h_prev, recs)
        zp, ip, fp, op = (pres[:, t] + rec).unbind(dim=2)
        zt = torch.tanh(zp)
        # stabilizer: m_t = max(log f + m, log i)
        log_f = F.logsigmoid(fp)
        m_new = torch.maximum(log_f + m, ip)
        i_g = torch.exp(ip - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        h_prev = torch.sigmoid(op) * (c / n.clamp_min(1e-6))
        m = m_new
        hs.append(h_prev)
    return torch.stack(hs, dim=1).to(z_pre.dtype), (c, n, h_prev, m)


#: Why a dry-run cell that runs the sLSTM on meta tensors has a peak that
#: is a lower bound: what :class:`_SLSTMShapes` saves for the backward.
SLSTM_SHAPES_ONLY = (
    "the sLSTM loop is shapes only on meta tensors (models/xlstm.py::_SLSTMShapes): "
    "it does not save the per-position activations the card's loop saves for the backward"
)


def slstm_shapes_calls() -> int:
    """Calls of the sLSTM's shapes-only path on meta tensors in this
    process."""
    return _SLSTMShapes.calls


class _SLSTMShapes(torch.autograd.Function):
    """:func:`slstm_scan`'s outputs and its inputs' gradients as meta
    tensors of their shapes and dtypes, without the loop (one position at
    a time, it would dispatch every op of every position on meta tensors:
    minutes for a 4,096-token dry-run cell). It saves none of the loop's
    activations, so a peak counted through it is a lower bound
    (:data:`SLSTM_SHAPES_ONLY`); :attr:`calls` counts its forwards."""

    calls = 0

    @staticmethod
    def forward(ctx, z_pre, *rest):
        _SLSTMShapes.calls += 1
        ctx.like = (z_pre, *rest)
        bsz, _, h, d = z_pre.shape
        state = tuple(z_pre.new_empty((bsz, h, d), dtype=torch.float32) for _ in range(4))
        return (torch.empty_like(z_pre), *state)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(torch.empty_like(t) for t in ctx.like)


# ---------------------------------------------------------------------------
# Block-level param defs (pre-up-projection mLSTM / post-up sLSTM)
# ---------------------------------------------------------------------------


def mlstm_block_defs(d_model: int, n_heads: int) -> dict:
    d_in = 2 * d_model  # pf = 2 up-projection
    hd = d_in // n_heads
    return {
        "norm": ParamDef((d_model,), ("embed",), init="zeros", dtype=torch.float32),
        "w_up": ParamDef((d_model, 2 * d_in), ("embed", "ffn"), init="scaled"),
        # block-diagonal per-head q/k/v (xLSTM repo's qkv_proj_blocksize)
        "w_q": ParamDef((n_heads, hd, hd), ("heads", None, None), init="scaled"),
        "w_k": ParamDef((n_heads, hd, hd), ("heads", None, None), init="scaled"),
        "w_v": ParamDef((n_heads, hd, hd), ("heads", None, None), init="scaled"),
        "w_i": ParamDef((d_in, n_heads), (None, "heads"), init="scaled"),
        "w_f": ParamDef((d_in, n_heads), (None, "heads"), init="scaled"),
        "f_bias": ParamDef((n_heads,), ("heads",), init="ones", dtype=torch.float32),
        "skip": ParamDef((d_in,), ("ffn",), init="ones", dtype=torch.float32),
        "w_down": ParamDef((d_in, d_model), ("ffn", "embed"), init="scaled"),
    }


def slstm_block_defs(d_model: int, n_heads: int) -> dict:
    hd = d_model // n_heads
    # pf = 4/3 post-up MLP, rounded to a 128 multiple
    d_up = (((4 * d_model) // 3 + 127) // 128) * 128
    gates = {
        f"w_{g}": ParamDef((d_model, n_heads, hd), (None, "heads", "head_dim"), init="scaled")
        for g in ("z", "i", "f", "o")
    }
    recs = {
        f"r_{g}": ParamDef((n_heads, hd, hd), ("heads", None, None), init="scaled")
        for g in ("z", "i", "f", "o")
    }
    return {
        "norm": ParamDef((d_model,), ("embed",), init="zeros", dtype=torch.float32),
        **gates,
        **recs,
        "w_o_proj": ParamDef((d_model, d_model), (None, "embed"), init="scaled"),
        "mlp_norm": ParamDef((d_model,), ("embed",), init="zeros", dtype=torch.float32),
        "w_mlp_up": ParamDef((d_model, d_up), ("embed", "ffn"), init="scaled"),
        "w_mlp_down": ParamDef((d_up, d_model), ("ffn", "embed"), init="scaled"),
    }


#: The logical axes of a block's per-head activations (B, L, H, D), of
#: its gate preactivations (B, L, H) or a (B, L, H·D) activation laid out
#: by head, and of its up-projected (B, L, d_in) activations.
_HEADS = ("batch", None, "heads", None)
_BY_HEAD = ("batch", None, "heads")
_FFN = ("batch", None, "ffn")


def _up_halves(xn: torch.Tensor, w_up: torch.Tensor) -> tuple:
    """The up-projection's two column halves (u, z), each (B, L, d_in).
    Plain tensors split the product. On DTensors each half is sharded on
    "ffn", which a rank's shard of the product is not (it holds columns of
    u or of z), so something is gathered. Where the tokens outnumber
    d_model (a prefill or training pass, where the product is the larger)
    it is the weight: its columns are reordered so that each rank's shard
    holds its own u columns and then its own z columns, and one product a
    rank splits locally (at one rank, the plain product). Else (a decode
    step) it is the product."""
    if not isinstance(w_up, DTensor) or Shard(1) not in w_up.placements:
        return (xn @ w_up).chunk(2, dim=-1)
    d, d_in = w_up.shape[0], w_up.shape[1] // 2
    if xn.numel() // xn.shape[-1] < d:
        up = xn @ w_up
        return tuple(constrain(t, _FFN) for t in (up[..., :d_in], up[..., d_in:]))
    mesh = w_up.device_mesh
    ranks = math.prod(mesh.size(i) for i, p in enumerate(w_up.placements) if p == Shard(1))
    whole = w_up.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                     for p in w_up.placements])
    cols = (whole[:, :d_in].view(d, ranks, -1), whole[:, d_in:].view(d, ranks, -1))
    w = constrain(torch.stack(cols, dim=2).reshape(d, 2 * d_in), ("embed", "ffn"))
    up = (xn @ w).unflatten(-1, (ranks, 2, -1))
    return tuple(constrain(up[..., i, :].flatten(-2), _FFN) for i in (0, 1))


def _mlstm_heads(uh, w_q, w_k, w_v, i_pre, f_pre, state, *, step: bool, chunk: int):
    """The per-head q/k/v projections of ``uh`` (B, L, H, hd) and the mLSTM
    recurrence (``step``: L = 1, one token from ``state``) → (h (B, L, H,
    Dv), (C, n)). DTensors run on each rank's (sequence, head) shards, the
    projection weights' gradient a partial sum over the sequence shards."""
    if isinstance(uh, DTensor):
        st = tuple(state or ())

        def local(*a):
            h, (c, n) = _mlstm_heads(*a[:6], a[6:] or None, step=step, chunk=chunk)
            return h, c, n

        h, c, n = on_head_shards(local, (uh, w_q, w_k, w_v, i_pre, f_pre, *st),
                                 ((0, 2),) + ((None, 0),) * 3 + ((0, 2),) * 2
                                 + ((0, 1),) * len(st),
                                 ((0, 2), (0, 1), (0, 1)))
        return h, (c, n)
    q = torch.einsum("blhe,hed->blhd", uh, w_q)
    k = torch.einsum("blhe,hed->blhd", uh, w_k)
    v = torch.einsum("blhe,hed->blhd", uh, w_v)
    if step:
        h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0], state)
        return h[:, None], state
    return mlstm_chunked(q, k, v, i_pre, f_pre, chunk=chunk, initial_state=state)


def _slstm_cell(pre: list, recs: list, state):
    """:func:`slstm_scan` of the four preactivations (B, L, H, D) and
    recurrent weights (H, D, D); DTensors run on each rank's (sequence,
    head) shards, the recurrent weights' gradient a partial sum over the
    sequence shards."""
    if isinstance(pre[0], DTensor):
        st = tuple(state or ())

        def local(*a):
            h, new = slstm_scan(*a[:8], initial_state=a[8:] or None)
            return (h, *new)

        h, *new = on_head_shards(local, (*pre, *recs, *st),
                                 ((0, 2),) * 4 + ((None, 0),) * 4 + ((0, 1),) * len(st),
                                 ((0, 2),) + ((0, 1),) * 4)
        return h, tuple(new)
    return slstm_scan(*pre, *recs, initial_state=state)


def mlstm_block(
    x: torch.Tensor,
    params: dict,
    *,
    n_heads: int,
    chunk: int = 128,
    initial_state=None,
    step: bool = False,
):
    """Pre-up-projection mLSTM block → (out, (C, n)). ``step``: one token
    from ``initial_state`` (decode)."""
    bsz, length, _ = x.shape
    d_in = params["skip"].shape[0]
    hd = d_in // n_heads
    xn = rms_norm(x, params["norm"])
    u, zgate = _up_halves(xn, params["w_up"])
    # u's "ffn" shards are not whole heads where the heads do not divide
    # the model axis: lay it out by head first
    uh = constrain(u, _BY_HEAD).reshape(bsz, length, n_heads, hd)
    ip = constrain(u @ params["w_i"], _BY_HEAD)
    fp = constrain(u @ params["w_f"] + params["f_bias"], _BY_HEAD)
    h, state = _mlstm_heads(uh, params["w_q"], params["w_k"], params["w_v"], ip, fp,
                            initial_state, step=step, chunk=chunk)
    # by head, then on "ffn": the gradient reaches the reshape by head too
    h = constrain(constrain(h.reshape(bsz, length, d_in), _BY_HEAD), _FFN)
    h = h + u * params["skip"].to(h.dtype)
    h = h * F.silu(zgate)
    return residual(x, h @ params["w_down"]), state


def slstm_block(x: torch.Tensor, params: dict, *, n_heads: int, initial_state=None):
    """Post-up-projection sLSTM block → (out, (c, n, h, m))."""
    bsz, length, d = x.shape
    xn = rms_norm(x, params["norm"])
    pre = [
        constrain((xn @ params[f"w_{g}"].reshape(d, -1))
                  .view(bsz, length, *params[f"w_{g}"].shape[1:]), _HEADS)
        for g in ("z", "i", "f", "o")
    ]
    h, state = _slstm_cell(pre, [params[f"r_{g}"] for g in ("z", "i", "f", "o")],
                           initial_state)
    y = residual(x, h.reshape(bsz, length, d) @ params["w_o_proj"])
    yn = rms_norm(y, params["mlp_norm"])
    hidden = F.gelu(yn @ params["w_mlp_up"], approximate="tanh")  # jax.nn.gelu's default
    return residual(y, constrain(hidden, _FFN) @ params["w_mlp_down"]), state
