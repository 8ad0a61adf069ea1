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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES

#: Shared memory a CTA may use on sm_90 (bytes).
MAX_SMEM = 232_448
#: Steps per chunk in the kernel (``kQ`` in ``csrc/ssd_scan.cu``).
KERNEL_CHUNK = 64
#: Columns of P a CTA takes (``kPT``): a (batch, head) runs on
#: ``ceil(P / P_TILE)`` CTAs.
P_TILE = 16


def ssd_scan_plain(
    x: torch.Tensor,  # (B, H, L, P) — dt already folded in
    log_a: torch.Tensor,  # (B, H, L) — A·dt per step
    b_mat: torch.Tensor,  # (B, L, N)
    c_mat: torch.Tensor,  # (B, L, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan in f32, from a zero state (the kernel's plain
    version, at the kernel's chunk length)."""
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    q = min(KERNEL_CHUNK, length)
    nck = -(-length // q)
    pad = nck * q - length
    xc = F.pad(x.float(), (0, 0, 0, pad)).view(bsz, h, nck, q, p)
    lac = F.pad(log_a.float(), (0, pad)).view(bsz, h, nck, q)
    bc = F.pad(b_mat.float(), (0, 0, 0, pad)).view(bsz, nck, q, n)
    cc = F.pad(c_mat.float(), (0, 0, 0, pad)).view(bsz, nck, q, n)

    cum = lac.cumsum(-1)  # inclusive, (B, H, nck, Q)
    # intra-chunk: y_i = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) x_j
    cb = torch.einsum("bkin,bkjn->bkij", cc, bc)  # (B, nck, Q, Q)
    seg = cum[..., :, None] - cum[..., None, :]  # (B, H, nck, Q, Q)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal, seg.exp(), torch.zeros((), device=x.device))
    y_intra = torch.einsum("bkij,bhkij,bhkjp->bhkip", cb, decay, xc)
    # chunk aggregates: S += Σ_j exp(total − cum_j) x_j B_jᵀ
    total = cum[..., -1]  # (B, H, nck)
    w = (total[..., None] - cum).exp()
    state_in = torch.einsum("bkjn,bhkjp,bhkj->bhkpn", bc, xc, w)
    read_w = cum.exp()

    s = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for k in range(nck):
        y_cross = torch.einsum("bin,bhpn->bhip", cc[:, k], s) * read_w[:, :, k, :, None]
        ys.append(y_intra[:, :, k] + y_cross)
        s = total[:, :, k].exp()[..., None, None] * s + state_in[:, :, k]
    y = torch.stack(ys, dim=2).reshape(bsz, h, nck * q, p)[:, :, :length]
    return y.to(x.dtype), s


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


def ssd_scan(
    x: torch.Tensor,
    log_a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk scan: the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, log_a, b_mat, c_mat)
    _check(x, log_a, b_mat, c_mat)
    bsz, h, length, p = x.shape
    n = b_mat.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    fn = _build.kernel_fn("ssd_scan")
    code = fn(
        x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        y.data_ptr(), s_final.data_ptr(), bsz, h, length, p, n,
        DTYPE_CODES[x.dtype], DTYPE_CODES[b_mat.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("ssd_scan", code)
    ssd_scan.launches += 1
    return y, s_final


#: Kernel launches since the last reset (plain-version calls not counted).
ssd_scan.launches = 0
