"""Mamba-2 SSD chunk scan: the Hopper kernel ``csrc/ssd_scan.cu`` and its
plain PyTorch version.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan_pallas``: per (batch,
head) the chunks in order, carrying a ``(P, N)`` f32 state; inside a chunk
the quadratic dual form. Inputs are pre-projected as the TPU kernel takes
them: ``x`` ``(B, H, L, P)`` already multiplied by dt, ``log_a = A·dt``
``(B, H, L)`` f32, single-group ``B``/``C`` ``(B, L, N)``. Returns ``y``
``(B, H, L, P)`` in x's dtype and the final state ``(B, H, P, N)`` f32.

Unlike the TPU kernel (and the reference's ``ssd_chunked``) it takes any
length L: the tail chunk is padded with ``x = 0`` and ``log_a = 0``, which
leaves y and the final state exact. The chunk length is the kernel's own
choice (64), and the plain version uses it too; only rounding depends on
it.

:func:`ssd_scan` launches the kernel on CUDA tensors and runs
:func:`ssd_scan_plain` on CPU tensors.

The gradient: :class:`SSDScan` (a ``torch.autograd.Function``) runs the
forward kernel with the state entering each chunk written out (f32
``(B, H, nck, P, N)``, only when asked) and, in its backward,
:func:`ssd_scan_backward`, which launches ``csrc/ssd_scan_bwd.cu`` on CUDA
tensors and runs :func:`ssd_scan_backward_plain` on CPU tensors. The
reference has no Pallas backward: it differentiates its jnp
``repro.models.ssm.ssd_chunked`` with ``jax.grad``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES, H100_SMS

#: Shared memory a CTA may use on sm_90 (bytes).
MAX_SMEM = 232_448
#: Steps per chunk in the kernel (``kQ`` in ``csrc/ssd_scan.cu``).
KERNEL_CHUNK = 64
#: Columns of P a CTA takes (``kPT``): a (batch, head) runs on
#: ``ceil(P / P_TILE)`` CTAs.
P_TILE = 16
#: The largest N the backward kernel takes.
BWD_MAX_N = 256
#: P and N up to this take the backward's tensor-core chunk kernel
#: (``chunk_tc_kernel``); above it, the CUDA-core one (``chunk_simt_kernel``).
BWD_TC_MAX = 64
#: CTAs of the tensor-core chunk kernel an SM holds (registers and shared
#: memory allow two).
BWD_TC_CTAS_PER_SM = 2


def _chunked(x, log_a, b_mat, c_mat):
    """The operands in f32, padded to whole chunks of the kernel's length
    (x = 0, log_a = 0, B = C = 0 past L): x ``(B, H, nck, Q, P)``, log_a
    ``(B, H, nck, Q)``, B and C ``(B, nck, Q, N)``."""
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    q = min(KERNEL_CHUNK, length)
    nck = -(-length // q)
    pad = nck * q - length
    xc = F.pad(x.float(), (0, 0, 0, pad)).view(bsz, h, nck, q, p)
    lac = F.pad(log_a.float(), (0, pad)).view(bsz, h, nck, q)
    bc = F.pad(b_mat.float(), (0, 0, 0, pad)).view(bsz, nck, q, n)
    cc = F.pad(c_mat.float(), (0, 0, 0, pad)).view(bsz, nck, q, n)
    return xc, lac, bc, cc


def ssd_scan_plain(
    x: torch.Tensor,  # (B, H, L, P) — dt already folded in
    log_a: torch.Tensor,  # (B, H, L) — A·dt per step
    b_mat: torch.Tensor,  # (B, L, N)
    c_mat: torch.Tensor,  # (B, L, N)
    *,
    return_states: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The chunked scan in f32, from a zero state (the kernel's plain
    version, at the kernel's chunk length). With ``return_states`` it also
    returns the state entering each chunk, ``(B, H, nck, P, N)`` f32."""
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    xc, lac, bc, cc = _chunked(x, log_a, b_mat, c_mat)
    nck, q = lac.shape[2:]

    cum = lac.cumsum(-1)  # inclusive, (B, H, nck, Q)
    # intra-chunk: y_i = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) x_j
    cb = torch.einsum("bkin,bkjn->bkij", cc, bc)  # (B, nck, Q, Q)
    seg = cum[..., :, None] - cum[..., None, :]  # (B, H, nck, Q, Q)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # exp(-inf) = 0 above the diagonal, where exp(seg) may overflow: the
    # values are exp(seg)'s, and autograd through them gives no NaN
    decay = torch.where(causal, seg, -torch.inf).exp()
    y_intra = torch.einsum("bkij,bhkij,bhkjp->bhkip", cb, decay, xc)
    # chunk aggregates: S += Σ_j exp(total − cum_j) x_j B_jᵀ
    total = cum[..., -1]  # (B, H, nck)
    w = (total[..., None] - cum).exp()
    state_in = torch.einsum("bkjn,bhkjp,bhkj->bhkpn", bc, xc, w)
    read_w = cum.exp()

    s = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    ys, states = [], []
    for k in range(nck):
        states.append(s)
        y_cross = torch.einsum("bin,bhpn->bhip", cc[:, k], s) * read_w[:, :, k, :, None]
        ys.append(y_intra[:, :, k] + y_cross)
        s = total[:, :, k].exp()[..., None, None] * s + state_in[:, :, k]
    y = torch.stack(ys, dim=2).reshape(bsz, h, nck * q, p)[:, :, :length]
    if return_states:
        return y.to(x.dtype), s, torch.stack(states, dim=2)
    return y.to(x.dtype), s


def ssd_scan_backward_plain(
    x: torch.Tensor,  # (B, H, L, P)
    log_a: torch.Tensor,  # (B, H, L)
    b_mat: torch.Tensor,  # (B, L, N)
    c_mat: torch.Tensor,  # (B, L, N)
    dy: torch.Tensor,  # (B, H, L, P)
    ds_final: Optional[torch.Tensor],  # (B, H, P, N); None is zero
    states: torch.Tensor,  # (B, H, nck, P, N), the forward's
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`ssd_scan_plain`'s (y, final state) with
    respect to (x, log_a, B, C), written out in f32 at the kernel's chunk
    length (the backward kernel's plain version; not autograd). Per (batch,
    head) and chunk k, with ``cum`` the inclusive cumsum of log_a in the
    chunk, ``S_{k-1}`` the state entering it (``states``, as
    ``ssd_scan_plain(..., return_states=True)`` gives them) and ``dS_k`` the
    gradient of the state leaving it, carried from ``ds_final`` back to the
    first chunk:

    * ``dS_{k-1} = e^{cum_Q} dS_k + Σ_i e^{cum_i} dy_i C_iᵀ``
    * ``dx_j = Σ_{i≥j} (C_i·B_j) e^{cum_i−cum_j} dy_i + e^{cum_Q−cum_j} dS_k B_j``
    * ``dC_i = Σ_{j≤i} e^{cum_i−cum_j} (dy_i·x_j) B_j + e^{cum_i} dy_i S_{k-1}``
    * ``dB_j = Σ_{i≥j} e^{cum_i−cum_j} (dy_i·x_j) C_i + e^{cum_Q−cum_j} x_j dS_k``
    * ``dlog_a_t = Σ_{i≥t} dcum_i`` over the chunk, where ``dcum`` gathers the
      decays' gradients: the intra-chunk ``(dy_i·x_j) M_ij`` (+ on row i,
      − on column j), the cross-chunk read ``e^{cum_i} dy_i·(S_{k-1} C_i)``,
      and the state update's terms on ``cum_Q`` and on each ``cum_j``.

    B and C are shared by every head (one group), so dB and dC sum over H.
    Returns (dx in x's dtype, dlog_a f32, dB, dC in B's and C's dtypes)."""
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    xc, lac, bc, cc = _chunked(x, log_a, b_mat, c_mat)
    nck, q = lac.shape[2:]
    dyc = F.pad(dy.float(), (0, 0, 0, nck * q - length)).view(bsz, h, nck, q, p)

    cum = lac.cumsum(-1)
    total = cum[..., -1]
    e_cum = cum.exp()  # e^{cum_i}
    w = (total[..., None] - cum).exp()  # e^{cum_Q − cum_j}
    # the reverse sweep: ds[:, :, k] is the gradient of the state leaving chunk k
    u = torch.einsum("bhkip,bkin->bhkpn", dyc * e_cum[..., None], cc)
    s = (torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
         if ds_final is None else ds_final.float())
    ds = []
    for k in reversed(range(nck)):
        ds.append(s)
        s = total[:, :, k].exp()[..., None, None] * s + u[:, :, k]
    ds = torch.stack(ds[::-1], dim=2)

    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    decay = torch.where(causal, seg, -torch.inf).exp()  # L_ij
    m = torch.einsum("bkin,bkjn->bkij", cc, bc)[:, None] * decay  # M_ij = (C_i·B_j) L_ij
    dm = torch.einsum("bhkip,bhkjp->bhkij", dyc, xc)  # dy_i·x_j
    dseg = dm * m
    dcb = dm * decay
    dsb = torch.einsum("bkjn,bhkpn->bhkjp", bc, ds)  # dS_k B_j
    dx = torch.einsum("bhkij,bhkip->bhkjp", m, dyc) + w[..., None] * dsb
    dys = torch.einsum("bhkip,bhkpn->bhkin", dyc, states)  # dy_i S_{k-1}
    xds = torch.einsum("bhkjp,bhkpn->bhkjn", xc, ds)  # x_j dS_k
    dc = torch.einsum("bhkij,bkjn->bhkin", dcb, bc) + e_cum[..., None] * dys
    db = torch.einsum("bhkij,bkin->bhkjn", dcb, cc) + w[..., None] * xds
    dw = (bc[:, None] * xds).sum(-1)  # x_jᵀ dS_k B_j
    dcum = dseg.sum(-1) - dseg.sum(-2) + e_cum * (cc[:, None] * dys).sum(-1) - w * dw
    dcum[..., -1] += (w * dw).sum(-1) + total.exp() * (ds * states).sum((-2, -1))
    dla = dcum.flip(-1).cumsum(-1).flip(-1)

    dx = dx.reshape(bsz, h, nck * q, p)[:, :, :length]
    dla = dla.reshape(bsz, h, nck * q)[:, :, :length]
    db = db.sum(1).reshape(bsz, nck * q, n)[:, :length]
    dc = dc.sum(1).reshape(bsz, nck * q, n)[:, :length]
    return dx.to(x.dtype), dla, db.to(b_mat.dtype), dc.to(c_mat.dtype)


def smem_bytes(n: int, x_size: int, bc_size: int, nbuf: int) -> int:
    """Dynamic shared memory one CTA asks for (``Layout`` in
    ``csrc/ssd_scan.cu``): ``nbuf`` buffers of the chunk's x (``P_TILE``
    columns), B and C tiles and the state (at N = 64 f32 and its two TF32
    parts, else f32), rows padded by 16 bytes and N to a multiple of 8, and
    each warp's cumsum rows. Element sizes in bytes."""
    q, pt, np_ = KERNEL_CHUNK, P_TILE, -(-n // 8) * 8
    state = (3 if n == 64 else 1) * pt * (np_ + 4) * 4
    buffer = q * (pt + 16 // x_size) * x_size + 2 * q * (np_ + 16 // bc_size) * bc_size + state
    return nbuf * buffer + 4 * 2 * q * 4


def _check(x, log_a, b_mat, c_mat) -> None:
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (log_a, b_mat, c_mat))):
        raise ValueError("all ssd_scan operands must lie on one CUDA device")
    if x.dtype not in DTYPE_CODES or log_a.dtype != torch.float32:
        raise TypeError(
            f"ssd_scan takes float32 or bfloat16 x and float32 log_a, got "
            f"{x.dtype}, {log_a.dtype}"
        )
    if b_mat.dtype not in DTYPE_CODES or c_mat.dtype != b_mat.dtype:
        raise TypeError(
            f"B and C must be float32 or bfloat16 of one dtype, got "
            f"{b_mat.dtype}, {c_mat.dtype}"
        )
    if x.dim() != 4 or b_mat.dim() != 3 or b_mat.shape != c_mat.shape:
        raise ValueError(
            f"expected x (B,H,L,P) and B, C (B,L,N), got {tuple(x.shape)}, "
            f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}"
        )
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    if log_a.shape != (bsz, h, length) or b_mat.shape[:2] != (bsz, length):
        raise ValueError(
            f"incompatible shapes x {tuple(x.shape)}, log_a "
            f"{tuple(log_a.shape)}, B {tuple(b_mat.shape)}"
        )
    if min(bsz, h, length) == 0 or p % 4 or n % 4 or p == 0 or n == 0:
        raise ValueError(f"ssd_scan needs nonempty B, H, L and P, N multiples of 4, got "
                         f"x {tuple(x.shape)}, N={n}")
    if smem_bytes(n, x.element_size(), b_mat.element_size(), 1) > MAX_SMEM:
        raise ValueError(f"N={n} needs more shared memory than a CTA has")
    if not all(t.is_contiguous() for t in (x, log_a, b_mat, c_mat)):
        raise ValueError("ssd_scan needs contiguous operands")


def forward_buffers(x: torch.Tensor, b_mat: torch.Tensor, return_states: bool):
    """What a forward launch allocates, on the card and on meta tensors
    alike: y in x's dtype, the f32 (B, H, P, N) final state and, with
    ``return_states``, the f32 (B, H, nck, P, N) state entering each chunk
    (else None)."""
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    states = None
    if return_states:
        nck = -(-length // KERNEL_CHUNK)
        states = torch.empty((bsz, h, nck, p, n), dtype=torch.float32, device=x.device)
    return y, s_final, states


def ssd_scan(
    x: torch.Tensor,
    log_a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    return_states: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The chunk scan: the kernel on CUDA, the plain version on the CPU.
    With ``return_states`` the kernel also writes the state entering each
    chunk, ``(B, H, nck, P, N)`` f32 (what the backward reads); without it,
    it writes y and the final state only. With grad mode on and an input
    that requires grad it goes through :class:`SSDScan`, whose backward is
    the backward kernel (its plain version on the CPU)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, log_a, b_mat, c_mat)):
        if return_states:
            raise ValueError("return_states is for the forward without grad")
        return SSDScan.apply(x, log_a, b_mat, c_mat)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, log_a, b_mat, c_mat, return_states=return_states)
    meta = x.device.type == "meta"
    if not meta:
        _check(x, log_a, b_mat, c_mat)
    y, s_final, states = forward_buffers(x, b_mat, return_states)
    if meta:  # the dry run: what the launch allocates, no launch
        return (y, s_final, states) if return_states else (y, s_final)
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    fn = _build.kernel_fn("ssd_scan")
    code = fn(
        x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        y.data_ptr(), s_final.data_ptr(), None if states is None else states.data_ptr(),
        bsz, h, length, p, n, DTYPE_CODES[x.dtype], DTYPE_CODES[b_mat.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("ssd_scan", code)
    ssd_scan.launches += 1
    return (y, s_final, states) if return_states else (y, s_final)


def bwd_variant(p: int, n: int) -> str:
    """The backward's chunk kernel for head dim ``p`` and state ``n``:
    ``"tc"`` (tensor cores, heads in groups) or ``"simt"`` (CUDA cores, a
    CTA a head)."""
    return "tc" if p <= BWD_TC_MAX and n <= BWD_TC_MAX else "simt"


def bwd_group(bsz: int, h: int, length: int, sms: int) -> int:
    """Heads a CTA of the tensor-core chunk kernel takes. A CTA runs its
    group's heads one after another, so the launch takes about (waves of
    CTAs) x (heads a CTA); the group that minimises that product is chosen,
    the larger one on a tie (fewer dB/dC partials, each f32 (B, L, N), to
    write and sum)."""
    ctas = -(-length // KERNEL_CHUNK) * bsz
    slots = BWD_TC_CTAS_PER_SM * sms

    def cost(g: int) -> tuple[int, int]:
        return -(-ctas * -(-h // g) // slots) * g, -g

    return min(range(1, h + 1), key=cost)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SMs; a meta call plans for an H100 SXM's."""
    if device.type == "meta":
        return H100_SMS
    return torch.cuda.get_device_properties(device.index or 0).multi_processor_count


def backward_buffers(x, log_a, b_mat, dy, ds_final, states, group: int):
    """What a backward launch allocates, on the card and on meta tensors
    alike: x and dy widened to f32 (copies where they are bf16), dense
    states and ds_final, the f32 dx and dlog_a, the f32 (B, parts, L, N) dB
    and dC partials of ``ceil(H / group)`` head groups, dB and dC in B's
    dtype, and the dS scratch (the states' shape). Returns (xf, dyf,
    states, ds_final, dx, dla, db_parts, dc_parts, db, dc, ds)."""
    bsz, _, length, _ = x.shape
    n = b_mat.shape[-1]
    parts = -(-x.shape[1] // group)
    xf, dyf = x.float().contiguous(), dy.float().contiguous()
    states = states.contiguous()
    ds_final = None if ds_final is None else ds_final.contiguous()
    dev = x.device
    dx = torch.empty(x.shape, dtype=torch.float32, device=dev)
    dla = torch.empty(log_a.shape, dtype=torch.float32, device=dev)
    db_parts = torch.empty((bsz, parts, length, n), dtype=torch.float32, device=dev)
    dc_parts = torch.empty_like(db_parts)
    db = torch.empty(b_mat.shape, dtype=b_mat.dtype, device=dev)
    dc = torch.empty_like(db)
    ds = torch.empty_like(states)  # scratch: the gradient of the state leaving each chunk
    return xf, dyf, states, ds_final, dx, dla, db_parts, dc_parts, db, dc, ds


def ssd_scan_backward(
    x: torch.Tensor,
    log_a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    dy: torch.Tensor,
    ds_final: Optional[torch.Tensor],
    states: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dlog_a, dB, dC) of the chunk scan: the backward kernel on CUDA,
    :func:`ssd_scan_backward_plain` on the CPU. ``states`` are the forward's
    (``ssd_scan(..., return_states=True)``); ``ds_final`` may be None (no
    gradient reaches the final state). The kernel reads x and dy in f32
    (bf16 ones are widened first) and writes dx in f32, cast to x's dtype.
    dB and dC are summed over each CTA's group of heads on chip
    (``bwd_variant`` "tc"; :func:`bwd_group` heads a CTA) or leave per head
    ("simt"), and the partials are summed in a fixed order by the library's
    last launch: no atomics, so two launches give the same bits."""
    if x.device.type == "cpu":
        return ssd_scan_backward_plain(x, log_a, b_mat, c_mat, dy, ds_final, states)
    meta = x.device.type == "meta"
    if not meta:
        _check(x, log_a, b_mat, c_mat)
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    nck = -(-length // KERNEL_CHUNK)
    if n > BWD_MAX_N:
        raise ValueError(f"the SSD backward takes N <= {BWD_MAX_N}, got {n}")
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)} on its device")
    if states.shape != (bsz, h, nck, p, n) or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 {(bsz, h, nck, p, n)}, got {tuple(states.shape)}")
    if ds_final is not None and (ds_final.shape != (bsz, h, p, n)
                                 or ds_final.dtype != torch.float32):
        raise ValueError(f"ds_final must be f32 {(bsz, h, p, n)}, got {tuple(ds_final.shape)}")
    kind = bwd_variant(p, n)
    group = 1 if kind == "simt" else min(bwd_group(bsz, h, length, _sm_count(x.device)), h)
    xf, dyf, states, ds_final, dx, dla, db_parts, dc_parts, db, dc, ds = backward_buffers(
        x, log_a, b_mat, dy, ds_final, states, group
    )
    if meta:  # the dry run: what the launch allocates, no launch
        return dx.to(x.dtype), dla, db, dc
    dev = x.device
    fn = _build.kernel_fn("ssd_scan_bwd")
    code = fn(
        xf.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        dyf.data_ptr(), None if ds_final is None else ds_final.data_ptr(),
        states.data_ptr(), ds.data_ptr(), dx.data_ptr(), dla.data_ptr(),
        db_parts.data_ptr(), dc_parts.data_ptr(), db.data_ptr(), dc.data_ptr(),
        bsz, h, length, p, n, DTYPE_CODES[b_mat.dtype], 0 if kind == "tc" else 1, group,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("ssd_scan_bwd", code)
    ssd_scan_backward.launches += 1
    if kind == "tc":
        ssd_scan_backward.launches_tc += 1
    else:
        ssd_scan_backward.launches_simt += 1
    return dx.to(x.dtype), dla, db, dc


class SSDScan(torch.autograd.Function):
    """The differentiable chunk scan: the forward kernel, writing the state
    entering each chunk, and for the gradient the backward kernel; on CPU
    tensors their plain versions. ``SSDScan.apply(x, log_a, b_mat, c_mat)``
    returns (y, final state)."""

    @staticmethod
    def forward(ctx, x, log_a, b_mat, c_mat):
        ctx.set_materialize_grads(False)
        y, s_final, states = ssd_scan(x, log_a, b_mat, c_mat, return_states=True)
        ctx.save_for_backward(x, log_a, b_mat, c_mat, states)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        x, log_a, b_mat, c_mat, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ssd_scan_backward(x, log_a, b_mat, c_mat, dy, ds_final, states)


def reset_counters() -> None:
    """Sets the launch counters to 0."""
    ssd_scan.launches = 0
    ssd_scan_backward.launches = 0
    ssd_scan_backward.launches_tc = 0
    ssd_scan_backward.launches_simt = 0


#: Kernel launches since the last reset (plain-version calls not counted):
#: the forward's, and the backward's (one a backward call), also by the
#: variant of its chunk kernel (``bwd_variant``).
ssd_scan.launches = 0
ssd_scan_backward.launches = 0
ssd_scan_backward.launches_tc = 0
ssd_scan_backward.launches_simt = 0
