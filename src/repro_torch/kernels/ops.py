"""Model-layout wrappers around the kernels.

Counterpart of ``repro.kernels.ops``: the model code keeps ``(B, L, H, D)``
and the kernels take head-major tensors, so these functions swap the layout
and call the kernel modules, which launch the Hopper kernel on CUDA tensors
and run the plain PyTorch version on CPU tensors. The flash kernel reads
strides, so prefill hands it head-major views and gets back an output that
is ``(B, L, H, D)`` in memory: no copy either way. Under autograd prefill
goes through the flash kernel's ``torch.autograd.Function``.

:func:`slot_decode_attention` is the engine-level mapping that the
reference's slot cache describes: one layer's slot cache
``(n_slots, c_max, K, D)`` is viewed, without a copy, as pages
``(n_slots * c_max / 16, 16, K, D)`` with block table
``bt[b, j] = b * (c_max / 16) + j``; an int8 cache's scales
``(n_slots, c_max, K, 1)`` are viewed the same way.

:func:`ssd_scan` folds dt into x in f32, as the reference model's
``ssd_chunked`` does (the reference's ``ops.ssd_scan`` folds it in x's
dtype, bf16 in the served model), and hands the kernel f32 x. Under
autograd it goes through the scan's ``torch.autograd.Function``, and the
fold and ``log_a = A·dt`` stay torch ops, so dt and A get their gradients
from autograd.

Attention also takes DTensors (the dense family's sharded path): the call
runs on each rank's local shards through ``local_map``, so the kernels
(their plain versions on CPU or meta tensors) see plain tensors. The batch
and head dimensions may be sharded or replicated; any other sharded
dimension is redistributed to replicated first. A decode cache sharded
along its sequence (``kv_seq``) is the exception, and is not gathered:
:func:`slot_decode_attention` runs the paged kernel on each rank's own
positions and merges the ranks' partial outputs by their log-sum-exps (one
all-reduce of the max, one of the weighted sums). Where the query heads
are sharded and the KV heads replicated (KV heads that do not divide the
mesh axis), each rank takes the KV heads its query heads read, and their
gradient is a partial sum over the ranks. :func:`write_slot` writes a
decode step's K/V (or int8 K/V and their scales) into a cache shard,
sequence-sharded ones included. The SSD scan takes DTensors too (the
hybrid family's sharded path): :func:`on_head_shards` hands each rank its
SSM heads, and B and C, which every head reads, whole, their gradient a
partial sum over the ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_scan as _ssd

#: KV positions per page of the slot-cache view (the vLLM block size).
PAGE = 16


_BATCH, _HEADS = 0, 2  # of (B, L, H, D) activations and (B, S, K, D) caches


def _kv_heads_for(q: torch.Tensor, kv: tuple, mesh, mesh_dim: int) -> tuple:
    """The KV heads (dim 2) that this rank's shard of query heads reads,
    from replicated KV operands."""
    h_local, n_kv = q.shape[_HEADS], kv[0].shape[_HEADS]
    group = h_local * mesh.size(mesh_dim) // n_kv  # query heads a KV head
    first = mesh.get_local_rank(mesh_dim) * h_local
    if h_local % group == 0:
        sl = slice(first // group, (first + h_local) // group)
    elif group % h_local == 0:
        sl = slice(first // group, first // group + 1)
    else:
        raise ValueError(
            f"{h_local} query heads a rank cannot take whole KV heads of {group} query heads"
        )
    return tuple(t[:, :, sl] for t in kv)


def on_head_shards(fn, args: tuple, dims: tuple, out_dims: tuple, *, whole_grads: tuple = ()):
    """``fn(*args)`` on each rank's local shards → DTensors. ``dims[i]`` is
    the (batch dim, head dim) of ``args[i]``, either None; ``out_dims`` the
    same for each output (one output: a DTensor, several: a tuple). The
    first argument sets the layout: the mesh dims that shard its batch dim
    shard every batch dim, those that shard its head dim every head dim,
    and its other shardings are gathered first. An argument without a head
    dim is whole on every rank, and its gradient over the head shards is a
    partial sum (each rank's heads add theirs), unless its index is in
    ``whole_grads`` (it feeds only outputs without a head dim, which every
    rank computes whole); an argument without a batch dim likewise has a
    partial gradient over the batch shards."""
    lead = args[0]
    mesh = lead.device_mesh
    role = [next((k for k, d in zip(("batch", "heads"), dims[0])
                  if isinstance(p, Shard) and p.dim == d), None) for p in lead.placements]

    def layout(i_dims, grad: bool = False, whole: bool = False) -> tuple:
        out = []
        for r in role:
            dim = None if r is None else i_dims[r == "heads"]
            if dim is not None:
                out.append(Shard(dim))
            elif grad and r is not None and not (whole and r == "heads"):
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)

    in_pl = tuple(layout(d) for d in dims)
    grad_pl = tuple(layout(d, True, i in whole_grads) for i, d in enumerate(dims))
    outs = [list(layout(d)) for d in out_dims]
    return local_map(
        fn, out_placements=outs[0] if len(outs) == 1 else tuple(outs),
        in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh,
    )(*(t.redistribute(mesh, p) for t, p in zip(args, in_pl)))


def _on_shards(fn, q: DTensor, kv: tuple, extra: tuple = ()):
    """``fn(q, *kv, *extra)`` on each rank's local shards → a DTensor laid
    out as ``q`` (:func:`on_head_shards`). ``q`` and ``kv`` keep their
    batch and head sharding, everything else is replicated first; ``extra``
    (per-sequence vectors) follow ``q``'s batch sharding. Where the KV
    heads are not sharded as the query heads are, they are whole on every
    rank, which takes the ones its query heads read."""
    head_dims = [i for i, p in enumerate(q.placements) if p == Shard(_HEADS)]
    sliced = [i for i in head_dims if any(t.placements[i] != Shard(_HEADS) for t in kv)]
    if sliced and len(head_dims) > 1:
        raise ValueError(f"query heads sharded over mesh dims {head_dims}, KV heads replicated")
    mesh = q.device_mesh

    def local(q_l, *rest):
        kv_l, extra_l = rest[:len(kv)], rest[len(kv):]
        if sliced:
            kv_l = _kv_heads_for(q_l, kv_l, mesh, sliced[0])
        return fn(q_l, *kv_l, *extra_l)

    kv_dims = (_BATCH, None if sliced else _HEADS)
    return on_head_shards(local, (q, *kv, *extra),
                          ((_BATCH, _HEADS), *(kv_dims,) * len(kv), *((0, None),) * len(extra)),
                          ((_BATCH, _HEADS),))


def flash_attention(
    q: torch.Tensor,  # (B, L, H, D) — model layout
    k: torch.Tensor,  # (B, L, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Prefill attention in the model layout; returns (B, L, H, D). With
    grad mode on and an input that requires grad it goes through
    :class:`~repro_torch.kernels.flash_attention.FlashAttention`, whose
    backward is the backward kernel (its plain version on the CPU).
    DTensors run on their local shards."""
    if isinstance(q, DTensor):
        return _on_shards(functools.partial(flash_attention, causal=causal), q, (k, v))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _flash.FlashAttention.apply(qh, kh, vh, causal).transpose(1, 2)
    return _flash.flash_attention(qh, kh, vh, causal=causal).transpose(1, 2)


@functools.lru_cache(maxsize=32)
def slot_block_table(
    n_slots: int, c_max: int, device: torch.device, page: int = PAGE
) -> torch.Tensor:
    """Block table of the slot-cache page view: ``bt[b, j] = b*(c_max/page)+j``."""
    if c_max % page:
        raise ValueError(f"c_max={c_max} must be a multiple of {page}")
    pps = c_max // page
    return torch.arange(n_slots * pps, dtype=torch.int32, device=device).view(
        n_slots, pps
    )


def slot_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, K, D) one layer's slot cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 valid positions per slot
    k_scale: Optional[torch.Tensor] = None,  # (B, S, K, 1) for an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over one layer's slot cache, as pages; (B, 1, H, D).
    DTensors run on their local shards; a cache sharded along its
    sequence runs :func:`_on_sequence_shards`."""
    if isinstance(q, DTensor):
        kv = (k_cache, v_cache) + ((k_scale, v_scale) if k_scale is not None else ())
        if Shard(1) in k_cache.placements:
            return _on_sequence_shards(q, kv, lengths)
        return _on_shards(
            lambda q_l, *rest: slot_decode_attention(q_l, *rest[:2], rest[-1], *rest[2:-1]),
            q, kv, (lengths,),
        )
    out = _paged_over_slots(q[:, 0], k_cache, v_cache, lengths, k_scale, v_scale)
    return out[:, None]


def _paged_over_slots(q, k_cache, v_cache, lengths, k_scale=None, v_scale=None, *,
                      page: int = PAGE, return_lse: bool = False):
    """The paged kernel on q (B, H, D) over a slot cache (B, S, K, D)
    viewed as pages of ``page`` positions."""
    b, s, n_kv, _ = k_cache.shape
    bt = slot_block_table(b, s, k_cache.device, page)

    def pages(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t.view(b * s // page, page, n_kv, t.shape[-1])

    return _paged.paged_attention(q, pages(k_cache), pages(v_cache), bt, lengths,
                                  pages(k_scale), pages(v_scale), return_lse=return_lse)


def _seq_offset(mesh, seq_dims: list, s_local: int) -> int:
    """The first position of this rank's shard of a sequence sharded over
    the mesh dims ``seq_dims`` (DTensor nests the shards of one dim in mesh
    order)."""
    offset = 0
    for i in seq_dims:
        offset = offset * mesh.size(i) + mesh.get_local_rank(i)
    return offset * s_local


def _on_sequence_shards(q: DTensor, kv: tuple, lengths: DTensor) -> DTensor:
    """Decode attention over a cache sharded along its sequence (dim 1 of
    (B, S, K, D); its batch may shard too, its heads not): q's heads are
    gathered over the sequence's mesh dims (q is one token a slot), each
    rank runs the paged kernel in f32 on its own positions (its local
    length ``clamp(length - offset, 0, S_local)``), and
    :func:`~repro_torch.kernels.paged_attention.combine_partials` merges the
    ranks' outputs by their log-sum-exps through two all-reduces over those
    mesh dims; the output, cast once to q's dtype, is laid out as q."""
    cache = kv[0]
    mesh = cache.device_mesh
    seq_dims = [i for i, p in enumerate(cache.placements) if p == Shard(1)]
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in cache.placements):
        raise ValueError(f"a sequence-sharded cache placed {cache.placements}: its heads "
                         "cannot shard too")
    q_pl = tuple(p if p == Shard(0) else Replicate() for p in cache.placements)

    def reduce(x: torch.Tensor, op: str) -> torch.Tensor:
        for i in seq_dims:
            x = funcol.all_reduce(x, op, (mesh, i))
        return x

    def local(q_l, *rest):
        kv_l, len_l = rest[:-1], rest[-1]
        s_local = kv_l[0].shape[1]
        offset = _seq_offset(mesh, seq_dims, s_local)
        len_l = (len_l - offset).clamp(0, s_local).to(torch.int32)
        # a shard shorter than a page, or not a whole number of pages,
        # takes smaller pages
        o, lse = _paged_over_slots(q_l[:, 0].float(), *kv_l[:2], len_l, *kv_l[2:],
                                   page=math.gcd(s_local, PAGE), return_lse=True)
        out, _ = _paged.combine_partials(o, lse, reduce)
        return out[:, None].to(q_l.dtype)

    out = local_map(local, out_placements=list(q_pl),
                    in_placements=(q_pl, *(t.placements for t in kv), q_pl),
                    device_mesh=mesh)(q.redistribute(mesh, q_pl), *kv,
                                      lengths.redistribute(mesh, q_pl))
    return out.redistribute(mesh, q.placements)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
                write: torch.Tensor, offset: int, sharded: bool) -> None:
    if not sharded:
        cache[rows, write] = new
        return
    # a sequence shard holds positions [offset, offset + S_local): write
    # only the slots whose position falls there
    pos = write - offset
    inside = ((pos >= 0) & (pos < cache.shape[1])).view(-1, *[1] * (new.dim() - 1))
    pos = pos.clamp(0, cache.shape[1] - 1)
    cache[rows, pos] = torch.where(inside, new, cache[rows, pos])


def write_slot(cache: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
               write: torch.Tensor) -> None:
    """``cache[rows[b], write[b]] = new[b]`` for every slot ``b``, in place:
    one layer's cache (B, S, ...) takes a decode step's (B, ...) at position
    ``write`` (B,); ``rows`` is ``arange(B)``, made once a step by the
    caller. A DTensor cache is written shard by shard (its own rows), ``new``
    and ``write`` laid out to follow it; a sequence-sharded shard takes
    only the positions it holds."""
    if not isinstance(cache, DTensor):
        _write_rows(cache, new, rows, write, 0, False)
        return
    mesh = cache.device_mesh
    new_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
                   else p if p == Shard(0) else Replicate() for p in cache.placements)
    w_pl = tuple(p if p == Shard(0) else Replicate() for p in cache.placements)
    seq_dims = [i for i, p in enumerate(cache.placements) if p == Shard(1)]
    local = cache.to_local()
    _write_rows(local, new.redistribute(mesh, new_pl).to_local(),
                torch.arange(local.shape[0], device=local.device),
                write.redistribute(mesh, w_pl).to_local(),
                _seq_offset(mesh, seq_dims, local.shape[1]), bool(seq_dims))


def ssd_scan(
    x: torch.Tensor,  # (B, L, H, P) — model layout
    dt: torch.Tensor,  # (B, L, H) positive
    a_neg: torch.Tensor,  # (H,) negative decay
    b_mat: torch.Tensor,  # (B, L, N)
    c_mat: torch.Tensor,  # (B, L, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N) f32).
    With grad mode on and an input that requires grad the scan goes through
    :class:`~repro_torch.kernels.ssd_scan.SSDScan` (``ssd_scan`` routes it
    there), whose backward is the backward kernel (its plain version on
    the CPU). DTensors run on their local shards of heads (x, dt on dim 2,
    a_neg on dim 0; the final state on dim 1), B and C whole."""
    if isinstance(x, DTensor):
        return on_head_shards(ssd_scan, (x, dt, a_neg, b_mat, c_mat),
                              ((0, 2), (0, 2), (None, 0), (0, None), (0, None)),
                              ((0, 2), (0, 1)))
    dtf = dt.float()
    xh = (x.float() * dtf[..., None]).transpose(1, 2).contiguous()
    log_a = (a_neg.float()[None, None, :] * dtf).transpose(1, 2).contiguous()
    y, s_final = _ssd.ssd_scan(xh, log_a, b_mat.contiguous(), c_mat.contiguous())
    return y.transpose(1, 2).to(x.dtype), s_final
