"""Distributed-optimization collectives (counterpart of
``repro.distributed.collectives``).

:func:`compressed_all_reduce` is an int8-quantized all-reduce mean with
error feedback, for bandwidth-bound gradient synchronization: each rank
quantizes its local gradient to int8 with a per-tensor scale, the ranks
agree on the largest scale, renormalize their int8 payload to it, sum it
as int32 and dequantize. The quantization residual is carried to the next
round in an error-feedback buffer, so the scheme is unbiased over time
(Seide et al. 2014; Karimireddy et al. 2019, EF-SGD). It is the reference's
``compressed_psum``, point for point, over a ``torch.distributed`` group
in place of a ``shard_map`` axis.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization in f32 → (q int8, scale f32
    scalar): ``scale = max(amax, 1e-12) / 127``, ``q = clip(round(x /
    scale), ±127)`` (round half to even)."""
    xf = x.float()
    amax = torch.clamp(xf.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(
    x: torch.Tensor,
    group: Optional[dist.ProcessGroup] = None,
    error: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce mean over ``group`` with error feedback → (mean f32,
    new error f32). ``error`` is this rank's quantization residual from the
    previous round."""
    xf = x.float()
    if error is not None:
        xf = xf + error
    q, scale = quantize_int8(xf)
    new_error = xf - dequantize_int8(q, scale)
    # the ranks renormalize their payload to the largest scale, so it stays
    # within int8 on every rank; the sum accumulates in int32
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    total = torch.round(q.float() * (scale / scale_max)).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    mean = total.float() * scale_max / n
    return mean, new_error


def make_compressed_grad_sync(mesh, axis_names: Sequence[str] = ("data",)):
    """A synchronizer ``sync(grads, errors) → (means, new errors)`` for trees
    of local gradients: each leaf goes through :func:`compressed_all_reduce`
    over each of the mesh's named axes in turn (axes the mesh lacks are
    skipped), its error carried from one axis to the next, as the
    reference's ``shard_map``'d synchronizer does."""
    from repro_torch.training.tree import leaves, unflatten  # training imports the models

    names = tuple(mesh.mesh_dim_names)
    groups = [mesh.get_group(a) for a in axis_names if a in names]

    def sync(grads: Any, errors: Any) -> tuple[Any, Any]:
        out = []
        for g, e in zip(leaves(grads), leaves(errors)):
            for group in groups:
                g, e = compressed_all_reduce(g, group, e)
            out.append((g, e))
        return (unflatten(grads, (m for m, _ in out)),
                unflatten(grads, (e for _, e in out)))

    return sync
