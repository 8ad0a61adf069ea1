"""Decode attention over KV pages: the Hopper kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention.paged_attention_pallas``:
one query token per sequence ``(B, H, D)`` against a page pool
``(P, page, K, D)`` reached through an int32 block table ``(B, pps)``;
positions at or past ``lengths`` are masked, and the kernel never loads
them. Online softmax in f32, output in q's dtype; where asked, also each
row's log-sum-exp, f32 ``(B, H)``: the log of its softmax denominator in
the scaled-score units (−inf, and an output of 0, for a row of length 0).
Pages are bf16 or f32, or int8 with one scale per (position, head),
``(P, page, K, 1)`` in f16 or f32. The plain version dequantizes each int8 value in f32 (``value *
scale``), as the TPU kernel does after its page read; the kernel applies
the same f32 scales per position, K's to the dot product and V's to the
probability.

The kernel splits each sequence's positions, for each KV head, over
:func:`split_count` CTAs of one thread-block cluster, which combine their
partial softmax states in the same launch; a CTA serves up to eight query
heads of its KV head.

:func:`paged_attention` launches the kernel on CUDA tensors and runs
:func:`paged_attention_plain` on CPU tensors. :func:`combine_partials`
merges the outputs and log-sum-exps of disjoint sets of positions (the
shards of a sequence-sharded cache) into the whole set's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.flash_attention import DTYPE_CODES, SUPPORTED_HEAD_DIMS

#: Codes of the page and scale dtypes in ``csrc/paged_attention.cu``.
PAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SCALE_CODES = {torch.float32: 0, torch.float16: 2}

_TILE = 64  # cache positions per kernel tile
#: Most CTAs (one portable thread-block cluster) per (sequence, KV head).
MAX_SPLIT = 8
#: Most query heads one CTA serves.
_HEADS_PER_CTA = 8


def paged_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, page, K, D)
    v_pages: torch.Tensor,  # (P, page, K, D)
    block_tables: torch.Tensor,  # (B, pps) int32
    lengths: torch.Tensor,  # (B,) int32
    k_scales: Optional[torch.Tensor] = None,  # (P, page, K, 1) for int8 pages
    v_scales: Optional[torch.Tensor] = None,
    *,
    return_lse: bool = False,
):
    """Gathers each sequence's pages (dequantized in f32 where they are
    int8) and runs masked softmax in f32. A row of length 0 gives 0 (and
    an lse of −inf). With ``return_lse``: (out, lse (B, H) f32)."""
    b, h, d = q.shape
    _, page, n_kv, _ = k_pages.shape
    pps = block_tables.shape[1]
    g = h // n_kv
    idx = block_tables.long()
    kg = k_pages[idx].float()
    vg = v_pages[idx].float()
    if k_pages.dtype == torch.int8:
        if k_scales is None or v_scales is None:
            raise ValueError("int8 pages need k_scales and v_scales")
        kg = kg * k_scales[idx].float()
        vg = vg * v_scales[idx].float()
    kg = kg.reshape(b, pps * page, n_kv, d)
    vg = vg.reshape(b, pps * page, n_kv, d)
    qg = q.reshape(b, n_kv, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, kg) * (1.0 / math.sqrt(d))
    pos = torch.arange(pps * page, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    # a row with no valid position would be softmax's 0/0: it gives 0
    p = torch.softmax(s, dim=-1).masked_fill(~valid.any(-1)[:, None, None, None], 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, vg).reshape(b, h, d).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h)
    return o


def combine_partials(out: torch.Tensor, lse: torch.Tensor, reduce) -> tuple:
    """The attention output and log-sum-exp over the union of disjoint sets
    of positions, from each set's: ``out`` (..., H, D) f32 and ``lse``
    (..., H); ``reduce(x, op)`` reduces ``x`` over the sets, ``op`` "max"
    or "sum" (a max over a stacked leading axis, or an all-reduce over
    the ranks that hold a sequence's shards). Each set weighs exp(lse −
    max lse); sets of no position (lse −inf) weigh 0, and a row with no
    position in any set gives 0 and −inf. One "max" and one "sum" (the
    weighted outputs and the weights together) → (out, lse), f32."""
    m = reduce(lse, "max")
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    tot = reduce(torch.cat([out * w[..., None], w[..., None]], dim=-1), "sum")
    num, den = tot[..., :-1], tot[..., -1:]
    return torch.where(den > 0, num / den, torch.zeros_like(num)), m + torch.log(den[..., 0])


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_count(b: int, h: int, n_kv: int, mapped: int, sms: int) -> int:
    """CTAs per (sequence, KV head, group of up to 8 query heads): the
    largest power of two S, at most :data:`MAX_SPLIT`, that keeps the
    ``S * b * n_kv * groups`` CTAs within one per SM, and at most one per
    64-position tile of the ``mapped`` (= pps * page) positions. A CTA
    costs a fixed few microseconds (the length, block-table and first-tile
    reads in series, the merge), so one wave of fatter CTAs beats more
    waves of thinner ones. Uses only shapes, so it needs no device sync;
    the kernel cuts each sequence's actual length into S shares of
    ceil(length / S) positions."""
    groups = -(-(h // n_kv) // _HEADS_PER_CTA)
    s = 1
    while s < MAX_SPLIT and b * n_kv * groups * s * 2 <= sms:
        s *= 2
    return max(1, min(s, mapped // _TILE))


def _check(q, k_pages, v_pages, block_tables, lengths, k_scales=None, v_scales=None) -> None:
    dev = q.device
    tensors = (k_pages, v_pages, block_tables, lengths)
    scales = tuple(t for t in (k_scales, v_scales) if t is not None)
    if not (q.is_cuda and all(t.device == dev for t in tensors + scales)):
        raise ValueError("all paged_attention operands must lie on one CUDA device")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype not in PAGE_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(
            f"pages must be float32, bfloat16 or int8 of one dtype, got "
            f"{k_pages.dtype}, {v_pages.dtype}"
        )
    if k_pages.dtype == torch.int8:
        if len(scales) != 2:
            raise ValueError("int8 pages need k_scales and v_scales")
        if k_scales.dtype not in SCALE_CODES or v_scales.dtype != k_scales.dtype:
            raise TypeError(
                f"scales must be float16 or float32 of one dtype, got "
                f"{k_scales.dtype}, {v_scales.dtype}"
            )
        want = (*k_pages.shape[:3], 1)
        if k_scales.shape != want or v_scales.shape != want:
            raise ValueError(
                f"scales must be {want}, got {tuple(k_scales.shape)}, "
                f"{tuple(v_scales.shape)}"
            )
    elif scales:
        raise ValueError(f"{k_pages.dtype} pages take no scales")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"expected q (B,H,D) and pages (P,page,K,D), got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    b, h, d = q.shape
    _, page, n_kv, kd = k_pages.shape
    if kd != d or n_kv == 0 or h % n_kv or page == 0:
        raise ValueError(
            f"incompatible shapes q {tuple(q.shape)}, pages {tuple(k_pages.shape)}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != b or block_tables.shape[1] == 0:
        raise ValueError(f"block_tables must be (B, pps), got {tuple(block_tables.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, *tensors, *scales)):
        raise ValueError("paged_attention needs contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention needs 16-byte aligned pages")


def output_buffers(q: torch.Tensor, return_lse: bool):
    """What a launch allocates, on the card and on meta tensors alike: the
    output (B, H, D) in q's dtype and, with ``return_lse``, the f32 (B, H)
    log-sum-exp (else None). The splits combine inside the kernel's
    cluster, so there is no workspace, whatever the pages' dtype."""
    b, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if return_lse else None
    return out, lse


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    *,
    return_lse: bool = False,
):
    """Decode attention over pages: the kernel on CUDA, the plain version
    on the CPU. Block-table entries are trusted to name pages of the pool;
    a length past ``pps * page`` counts as ``pps * page``. With
    ``return_lse``: (out, lse (B, H) f32), the kernel writing the lse
    where its cluster combines its shares. Decode has no
    backward kernel: on CUDA inputs that require grad, with grad mode on,
    it raises rather than return an output with no gradient."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
            return_lse=return_lse,
        )
    refuse_grad("paged_attention (decode attention's backward kernel)",
                q, k_pages, v_pages, k_scales, v_scales)
    meta = q.device.type == "meta"
    if not meta:
        _check(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales)
    out, lse = output_buffers(q, return_lse)
    if meta:  # the dry run: what the launch allocates, no launch
        return (out, lse) if return_lse else out
    b, h, d = q.shape
    _, page, n_kv, _ = k_pages.shape
    pps = block_tables.shape[1]
    splits = split_count(b, h, n_kv, pps * page, _sm_count(q.device))
    quant = k_pages.dtype == torch.int8
    fn = _build.kernel_fn("paged_attention")
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, h, n_kv, d, page, pps, splits, 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], PAGE_CODES[k_pages.dtype],
        SCALE_CODES[k_scales.dtype] if quant else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("paged_attention", code)
    paged_attention.launches += 1
    return (out, lse) if return_lse else out


#: Kernel launches since the last reset (plain-version calls not counted).
paged_attention.launches = 0
