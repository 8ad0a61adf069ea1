"""Mamba-2 (SSD) blocks (counterpart of ``repro.models.ssm``).

The sequence mixer of the hybrid family (zamba2). At prefill a block runs
the chunked SSD scan through :func:`repro_torch.kernels.ops.ssd_scan` (the
Hopper kernel on CUDA, its plain version on the CPU); at decode it runs the
one-token recurrence :func:`ssd_step` in plain PyTorch, which the reference
computes as ``ssd_chunked`` with ``chunk=1`` and an initial state (equal:
the reference's ``tests/test_layers.py::test_ssd_chunked_equals_stepwise``).

On DTensors (the sharded path) the block's heads shard over the model
axis: ``w_z``, ``w_x``, ``w_dt``, ``conv_x`` and the per-head vectors on
``ssm_heads``, ``w_b``, ``w_c``, ``conv_b``, ``conv_c`` whole. The scan,
the decode recurrence and the causal convs run on each rank's local shards
(:func:`repro_torch.kernels.ops.on_head_shards`); the convs take the x
channels on their shard and the B/C channels whole, and the conv state
they return is whole, as the decode state keeps it. The gated norm's mean
over ``d_inner`` is a partial sum over the ranks, reduced once, and the
output projection's a partial sum that the caller's residual reduces.

Dimensions: B batch, L seq, H ssm heads, P head dim, G groups, N state.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import constrain, replicate_like
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef

#: The logical axes of a block's (B, L, d_inner) or (B, L, H) activations.
_INNER = ("batch", None, "ssm_heads")

# ---------------------------------------------------------------------------
# Core SSD scan
# ---------------------------------------------------------------------------


def ssd_step(
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    a_neg: torch.Tensor,  # (H,)
    b_t: torch.Tensor,  # (B, G, N)
    c_t: torch.Tensor,  # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence: S ← a S + dt B x;  y = C·S (f32 state).
    DTensors run on their local shards of heads."""
    if isinstance(x_t, DTensor):
        return ops.on_head_shards(
            ssd_step, (x_t, dt_t, a_neg, b_t, c_t, state),
            ((0, 1), (0, 1), (None, 0), (0, None), (0, None), (0, 1)), ((0, 1), (0, 1)))
    h = x_t.shape[1]

    def per_head(t: torch.Tensor) -> torch.Tensor:  # (B, G, N) → (B, H or 1, N)
        g = t.shape[1]
        return t.float() if g == 1 else t.float().repeat_interleave(h // g, dim=1)

    bh, ch = per_head(b_t), per_head(c_t)
    dtf = dt_t.float()
    a = torch.exp(a_neg.float()[None] * dtf)
    s_new = (
        a[..., None, None] * state.float()
        + dtf[..., None, None] * x_t.float()[..., None] * bh[:, :, None, :]
    )
    y = (s_new @ ch[..., None])[..., 0]
    return y.to(x_t.dtype), s_new


# ---------------------------------------------------------------------------
# Mamba-2 block (projections + conv + SSD + gate)
# ---------------------------------------------------------------------------


def mamba2_param_defs(
    d_model: int, d_inner: int, n_heads: int, d_state: int, d_conv: int
) -> dict:
    di_ax = ("embed", "ssm_heads")
    return {
        "w_z": ParamDef((d_model, d_inner), di_ax, init="scaled"),
        "w_x": ParamDef((d_model, d_inner), di_ax, init="scaled"),
        "w_b": ParamDef((d_model, d_state), ("embed", None), init="scaled"),
        "w_c": ParamDef((d_model, d_state), ("embed", None), init="scaled"),
        "w_dt": ParamDef((d_model, n_heads), ("embed", "ssm_heads"), init="scaled"),
        "conv_x": ParamDef((d_conv, d_inner), (None, "ssm_heads"), init="scaled"),
        "conv_b": ParamDef((d_conv, d_state), (None, None), init="scaled"),
        "conv_c": ParamDef((d_conv, d_state), (None, None), init="scaled"),
        "a_log": ParamDef((n_heads,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "d_skip": ParamDef((n_heads,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "dt_bias": ParamDef((n_heads,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "norm": ParamDef((d_inner,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "w_out": ParamDef((d_inner, d_model), ("ssm_heads", "embed"), init="scaled"),
    }


def _causal_conv(
    x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along L. x (B,L,C), w (K,C). Returns (y, the
    last K-1 inputs)."""
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    length = x.shape[1]
    y = xp[:, 0:length] * w[0]
    for i in range(1, k):
        y = y + xp[:, i : i + length] * w[i]
    return y, xp[:, length:]


def _ssm_gated_norm(
    y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """RMSNorm(y * silu(z)) — the Mamba-2 gated output norm. On DTensors
    the mean over the sharded ``d_inner`` is one all-reduce of (B, L, 1),
    and so is its gradient's (left alone, DTensor reduce-scatters the
    gradient onto the batch and gathers the activations back)."""
    hf = (y * F.silu(z)).float()
    var = constrain(hf.square().mean(dim=-1, keepdim=True), ("batch", None, None))
    return (hf * torch.rsqrt(var + eps) * (1.0 + w)).to(y.dtype)


def _conv_silu(xs, bproj, cproj, conv_x, conv_b, conv_c, cache=None, keep_state=True):
    """The x, B and C channels' causal convs as one depthwise conv over
    their concatenated channels (the conv state's layout; the reference's
    three convs channel by channel), then SiLU → (xs, B, C, the last K-1
    inputs of every channel, or None without ``keep_state``). On DTensors
    each rank convolves its x channels and the B/C channels whole, and the
    state comes back whole (a gather of the x channels' K-1 inputs, which
    ``keep_state=False`` spares)."""
    if isinstance(xs, DTensor):
        return _conv_silu_on_shards(xs, bproj, cproj, conv_x, conv_b, conv_c, cache,
                                    keep_state)
    xbc = torch.cat([xs, bproj, cproj], dim=-1)
    w = torch.cat([conv_x, conv_b, conv_c], dim=-1)
    xbc, tail = _causal_conv(xbc, w, cache)
    n = bproj.shape[-1]
    return (*F.silu(xbc).split([xbc.shape[-1] - 2 * n, n, n], dim=-1),
            tail if keep_state else None)


def _conv_silu_on_shards(xs, bproj, cproj, conv_x, conv_b, conv_c, cache, keep_state):
    di = xs.shape[-1]

    def local(xs, bproj, cproj, conv_x, conv_b, conv_c, *cache_parts):
        cache = torch.cat(cache_parts, dim=-1) if cache_parts else None
        *out, tail = _conv_silu(xs, bproj, cproj, conv_x, conv_b, conv_c, cache)
        return (*out, tail[..., :xs.shape[-1]], tail[..., xs.shape[-1]:])

    args = (xs, bproj, cproj, conv_x, conv_b, conv_c)
    dims = ((0, 2), (0, None), (0, None), (None, 1), (None, None), (None, None))
    if cache is not None:  # the whole state: each rank takes its x channels
        args += (cache[..., :di], cache[..., di:])
        dims += ((0, 2), (0, None))
    xs, bproj, cproj, tail_x, tail_bc = ops.on_head_shards(
        local, args, dims, ((0, 2), (0, None), (0, None), (0, 2), (0, None)),
        whole_grads=(1, 2, 4, 5, 7))
    if not keep_state:
        return xs, bproj, cproj, None
    tail = torch.cat([tail_x.redistribute(tail_x.device_mesh, tail_bc.placements), tail_bc],
                     dim=-1)
    return xs, bproj, cproj, tail


def _projections(x: torch.Tensor, params: dict, state: Optional[dict], keep_state: bool = True):
    """The block's input projections and causal convs → (z, xs, B, C, dt,
    new conv state or None)."""
    z = constrain(x @ params["w_z"], _INNER)
    dt = constrain(x @ params["w_dt"], _INNER)
    xs, bproj, cproj, new_conv = _conv_silu(
        x @ params["w_x"], x @ params["w_b"], x @ params["w_c"], params["conv_x"],
        params["conv_b"], params["conv_c"], None if state is None else state["conv"], keep_state)
    return z, xs, bproj, cproj, dt, new_conv


def _output(y, xh, z, params):
    bsz, length = y.shape[:2]
    y = y + xh * params["d_skip"][None, None, :, None].to(y.dtype)
    y = constrain(y.reshape(bsz, length, -1), _INNER)
    return constrain(_ssm_gated_norm(y, z, params["norm"]), _INNER) @ params["w_out"]


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    """A 0-dim f32 zero on ``device``, made once (``logaddexp`` takes no
    Python scalar, and a new zero would be one fill launch a block)."""
    return torch.zeros((), device=device)


def _dt_decay(dt: torch.Tensor, params: dict):
    """softplus(dt + dt_bias) in f32 (``jax.nn.softplus`` = logaddexp(x, 0))
    and the negative decay ``-exp(a_log)``."""
    dtp = torch.logaddexp(dt.float() + params["dt_bias"], replicate_like(_zero(dt.device), dt))
    return dtp, -torch.exp(params["a_log"])


def mamba2_block(
    x: torch.Tensor,  # (B, L, d_model)
    params: dict,
    *,
    n_heads: int,
    head_dim: int,
    d_state: int,
    keep_state: bool = True,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba-2 mixer over a prompt (no carried state), the scan through
    ``ops.ssd_scan``. Returns (out, {"conv": (B, K-1, C), "ssd": (B, H, P,
    N)}), or (out, None) without ``keep_state`` (training)."""
    z, xs, bproj, cproj, dt, conv = _projections(x, params, None, keep_state)
    bsz, length, _ = x.shape
    xh = xs.reshape(bsz, length, n_heads, head_dim)
    dtp, a_neg = _dt_decay(dt, params)
    y, s_final = ops.ssd_scan(xh, dtp, a_neg, bproj, cproj)
    return _output(y, xh, z, params), {"conv": conv, "ssd": s_final} if keep_state else None


def mamba2_decode_step(
    x_t: torch.Tensor,  # (B, 1, d_model)
    params: dict,
    state: dict,  # {"conv": (B, K-1, C), "ssd": (B, H, P, N)}
    *,
    n_heads: int,
    head_dim: int,
    d_state: int,
) -> tuple[torch.Tensor, dict]:
    """O(1) per-token recurrence for serving decode → (out, new state)."""
    z, xs, bproj, cproj, dt, conv = _projections(x_t, params, state)
    bsz = x_t.shape[0]
    xh = xs.reshape(bsz, 1, n_heads, head_dim)
    dtp, a_neg = _dt_decay(dt, params)
    y, s_new = ssd_step(xh[:, 0], dtp[:, 0], a_neg, bproj[:, 0, None], cproj[:, 0, None],
                        state["ssd"])
    return _output(y[:, None], xh, z, params), {"conv": conv, "ssd": s_new}
