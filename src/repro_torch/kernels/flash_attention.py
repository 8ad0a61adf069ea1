"""Prefill attention: the Hopper kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``:
head-major q ``(B, H, Lq, D)`` against k/v ``(B, K, Lk, D)``, GQA by
``kv_head = h // (H // K)`` with no KV replication, online softmax in f32
with scale ``1/sqrt(D)``, output in q's dtype. Unlike the TPU kernel it
takes any length (its blocks are 64 rows; the ragged edge is masked).

The kernel reads its operands through strides (head_dim contiguous), so a
head-major view of the model's ``(B, L, H, D)`` tensors needs no copy, and
the output takes q's memory layout. It has two variants, which the C entry
point picks by dtype and head dim: tensor cores (``wgmma`` on TMA-fed tiles;
bf16 at head dims 64, 80, 128 and 256) and CUDA cores (f32, and head dim
32). Each launch counts on ``flash_attention.launches`` and on its
variant's own counter, ``launches_tc`` or ``launches_simt``.

:func:`flash_attention` launches the kernel on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors.

The gradient: :class:`FlashAttention` (a ``torch.autograd.Function``) runs
the forward kernel with its per-row log-sum-exp (f32 (B, H, Lq)) and, in
its backward, :func:`flash_attention_backward`, which launches
``csrc/flash_attention_bwd.cu`` on CUDA tensors and runs
:func:`flash_attention_backward_plain` on CPU tensors; each backward call
counts one on ``flash_attention_backward.launches`` and on its variant's
counter (:func:`backward_variant`: tensor cores for bf16 at head dims 64,
80 and 128, CUDA cores otherwise). The reference has no
Pallas backward: it differentiates its jnp attention
(``repro.models.layers.flash_attention``) with ``jax.grad``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Masked ``scale * q k^T`` in f32, grouped (B, K, G, Lq, Lk)."""
    b, h, lq, d = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if causal and lq != lk:
        raise ValueError(f"causal attention needs Lq == Lk, got {lq}, {lk}")
    qg = q.reshape(b, n_kv, h // n_kv, lq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.contiguous().float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, K, Lk, D)
    v: torch.Tensor,  # (B, K, Lk, D)
    *,
    causal: bool = True,
    return_lse: bool = False,
):
    """Dense masked softmax attention in f32 (the kernel's plain version).
    With ``return_lse`` also each row's log-sum-exp of its scaled scores,
    f32 (B, H, Lq), as the kernel writes it for the backward."""
    b, h, lq, d = q.shape
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.contiguous().float())
    o = o.reshape(b, h, lq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, lq)


def flash_attention_backward_plain(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, K, Lk, D)
    v: torch.Tensor,  # (B, K, Lk, D)
    o: torch.Tensor,  # (B, H, Lq, D), the forward's output
    lse: torch.Tensor,  # (B, H, Lq) f32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, H, Lq, D), the output's gradient
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's plain version, in f32: ``P = exp(S - lse)``,
    ``dV = P^T dO``, ``dS = P (dO V^T - delta)`` with ``delta =
    rowsum(dO O)``, ``dQ = scale dS K``, ``dK = scale dS^T Q``; dK and dV sum
    over each kv head's G query heads. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, h, lq, d = q.shape
    n_kv = k.shape[1]
    g, scale = h // n_kv, 1.0 / math.sqrt(d)
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.float().reshape(b, n_kv, g, lq, 1))
    dof = do.float().reshape(b, n_kv, g, lq, d)
    delta = (dof * o.float().reshape(b, n_kv, g, lq, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, v.contiguous().float())
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.contiguous().float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.reshape(b, n_kv, g, lq, d).float()) * scale
    return dq.reshape(b, h, lq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B,H,L,D) and k, v (B,K,L,D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, lq, d = q.shape
    kb, n_kv, lk, kd = k.shape
    if kb != b or kd != d or n_kv == 0 or h % n_kv or lq == 0 or lk == 0:
        raise ValueError(
            f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if causal and lq != lk:
        raise ValueError(f"causal attention needs Lq == Lk, got {lq}, {lk}")
    step = 16 // q.element_size()  # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % step for st in _strides(t)):
            raise ValueError(
                f"flash_attention needs {name} contiguous along head_dim with "
                f"its other strides multiples of 16 bytes, got strides "
                f"{tuple(t.stride())}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention needs a 16-byte aligned {name}")


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides (b, head, l) of a (B, heads, L, D) operand; a dim of
    size 1 is never stepped, so it gets the tensor's size as its stride."""
    return tuple(t.stride(i) if t.shape[i] > 1 else t.numel() for i in range(3))


@functools.lru_cache(maxsize=None)
def variant(head_dim: int, dtype: torch.dtype) -> str:
    """The kernel variant a call takes, as the C entry point decides:
    ``"tc"`` (tensor cores) or ``"simt"`` (CUDA cores). Builds the library."""
    fn = _build.library("flash_attention").flash_attention_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    code = fn(head_dim, DTYPE_CODES[dtype])
    if code not in (0, 1):
        raise ValueError(f"flash_attention takes no {dtype} at head_dim {head_dim}")
    return "tc" if code == 1 else "simt"


@functools.lru_cache(maxsize=None)
def backward_variant(head_dim: int, dtype: torch.dtype) -> str:
    """The backward kernel's variant for a call, as its C entry point
    decides: ``"tc"`` (mma.sync) or ``"simt"``. Builds the library."""
    fn = _build.library("flash_attention_bwd").flash_attention_bwd_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    code = fn(head_dim, DTYPE_CODES[dtype])
    if code not in (0, 1):
        raise ValueError(f"the flash backward takes no {dtype} at head_dim {head_dim}")
    return "tc" if code == 1 else "simt"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    return_lse: bool = False,
):
    """Head-major prefill attention: the kernel on CUDA, the plain version
    on the CPU. The output has q's memory layout where q is dense (a
    head-major view of a (B, L, H, D) tensor gives one that is (B, L, H, D)
    in memory). With ``return_lse`` the kernel also writes each row's
    log-sum-exp, f32 (B, H, Lq), and the call returns (out, lse); serving
    leaves it off and its launches do no more work than before. No
    gradient: :class:`FlashAttention` is the differentiable call."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, return_lse=return_lse)
    _check(q, k, v, causal)
    b, h, lq, d = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device) if return_lse else None
    kind = variant(d, q.dtype)
    fn = _build.kernel_fn("flash_attention")
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        b, h, n_kv, lq, lk, d, int(causal), 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], *_strides(q), *_strides(k), *_strides(v),
        *_strides(out), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    if kind == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_simt += 1
    return (out, lse) if return_lse else out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it through its strides, else a dense
    copy."""
    step = 16 // t.element_size()
    if t.stride(3) == 1 and not any(st % step for st in _strides(t)) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of head-major attention: the backward kernel on CUDA,
    :func:`flash_attention_backward_plain` on the CPU. The gradients take
    the layouts of q, k and v (``empty_like``)."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal)
    _check(q, k, v, causal)
    b, h, lq, d = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(
            f"o {tuple(o.shape)} {o.dtype} and dO {tuple(do.shape)} {do.dtype} must match "
            f"q {tuple(q.shape)} {q.dtype}"
        )
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b, h, lq)}, got {tuple(lse.shape)}")
    o, do = _aligned(o), _aligned(do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    kind = backward_variant(d, q.dtype)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in _strides(t))
    )
    fn = _build.kernel_fn("flash_attention_bwd")
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, n_kv, lq, lk, d, int(causal), 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype],
        strides, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention_bwd", code)
    flash_attention_backward.launches += 1
    if kind == "tc":
        flash_attention_backward.launches_tc += 1
    else:
        flash_attention_backward.launches_simt += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable head-major attention: the forward kernel (with its
    log-sum-exp) and, for the gradient, the backward kernel; on CPU tensors
    their plain versions. ``FlashAttention.apply(q, k, v, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def reset_counters() -> None:
    """Sets the launch counters to 0."""
    flash_attention.launches = 0
    flash_attention.launches_tc = 0
    flash_attention.launches_simt = 0
    flash_attention_backward.launches = 0
    flash_attention_backward.launches_tc = 0
    flash_attention_backward.launches_simt = 0


#: Kernel launches since the last reset (plain-version calls not counted),
#: in all and by variant; backward calls that launched the backward kernel,
#: in all and by variant.
flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0
flash_attention_backward.launches = 0
flash_attention_backward.launches_tc = 0
flash_attention_backward.launches_simt = 0
