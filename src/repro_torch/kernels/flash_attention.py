"""Prefill attention: the Hopper kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``:
head-major q ``(B, H, Lq, D)`` against k/v ``(B, K, Lk, D)``, GQA by
``kv_head = h // (H // K)`` with no KV replication, online softmax in f32
with scale ``1/sqrt(D)``, output in q's dtype. Unlike the TPU kernel it
takes any length (its blocks are 64 rows; the ragged edge is masked).

:func:`flash_attention` launches the kernel on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, K, Lk, D)
    v: torch.Tensor,  # (B, K, Lk, D)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Dense masked softmax attention in f32 (the kernel's plain version)."""
    b, h, lq, d = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if causal and lq != lk:
        raise ValueError(f"causal attention needs Lq == Lk, got {lq}, {lk}")
    g = h // n_kv
    qg = q.reshape(b, n_kv, g, lq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, lq, d).to(q.dtype)


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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Head-major prefill attention: the kernel on CUDA, the plain version
    on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v, causal)
    b, h, lq, d = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.kernel_fn("flash_attention")
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, n_kv, lq, lk, d, int(causal), 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return out


#: Kernel launches since the last reset (plain-version calls not counted).
flash_attention.launches = 0
