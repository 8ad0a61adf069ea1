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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
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
    u, zgate = (xn @ params["w_up"]).chunk(2, dim=-1)
    uh = u.reshape(bsz, length, n_heads, hd)
    q = torch.einsum("blhe,hed->blhd", uh, params["w_q"])
    k = torch.einsum("blhe,hed->blhd", uh, params["w_k"])
    v = torch.einsum("blhe,hed->blhd", uh, params["w_v"])
    ip = u @ params["w_i"]
    fp = u @ params["w_f"] + params["f_bias"]
    if step:
        h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ip[:, 0], fp[:, 0], initial_state)
        h = h[:, None]
    else:
        h, state = mlstm_chunked(q, k, v, ip, fp, chunk=chunk, initial_state=initial_state)
    h = h.reshape(bsz, length, d_in)
    h = h + u * params["skip"].to(h.dtype)
    h = h * F.silu(zgate)
    return x + h @ params["w_down"], state


def slstm_block(x: torch.Tensor, params: dict, *, n_heads: int, initial_state=None):
    """Post-up-projection sLSTM block → (out, (c, n, h, m))."""
    bsz, length, d = x.shape
    xn = rms_norm(x, params["norm"])
    pre = [
        (xn @ params[f"w_{g}"].reshape(d, -1)).view(bsz, length, *params[f"w_{g}"].shape[1:])
        for g in ("z", "i", "f", "o")
    ]
    h, state = slstm_scan(
        *pre, params["r_z"], params["r_i"], params["r_f"], params["r_o"],
        initial_state=initial_state,
    )
    y = x + h.reshape(bsz, length, d) @ params["w_o_proj"]
    yn = rms_norm(y, params["mlp_norm"])
    hidden = F.gelu(yn @ params["w_mlp_up"], approximate="tanh")  # jax.nn.gelu's default
    return y + hidden @ params["w_mlp_down"], state
