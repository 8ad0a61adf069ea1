"""The SSD backward kernel's precision plan, held on the CPU.

``csrc/ssd_scan_bwd.cu`` runs every product of the gradient on the tensor
cores with TF32 operands and f32 accumulation, as ``csrc/ssd_scan.cu`` does
for the forward (``tests/test_torch_ssd_precision.py``): an f32 operand is
split into a TF32 high part and the TF32 rounding of the rest, and lo·hi +
hi·lo + hi·hi summed ("3xTF32"); a bf16 operand is exact in TF32 and is not
split. Passes per product:

==========================  ============  ===========
product                     bf16 B and C  f32 B and C
==========================  ============  ===========
(e·dy)ᵀ·C (the dS sweep)    2             3
C·Bᵀ and B·Cᵀ               1             3
dy·xᵀ and x·dyᵀ             3             3
dy·S and x·dS               3             3
B·dSᵀ                       2             3
Mᵀ·dy                       3             3
dCB·B and dCBᵀ·C            2             3
==========================  ============  ===========

These tests emulate that rounding in PyTorch and run the kernel's
decomposition of the gradient (the sweep; then per head and chunk dm = dy·xᵀ,
M = (C·Bᵀ)∘L, dC = dCB·B + e·(dy·S); dx = w·(B·dSᵀ) + Mᵀ·dy with Mᵀ =
(B·Cᵀ)∘Lᵀ; dB = dCBᵀ·C + w·(x·dS) with dCBᵀ = (x·dyᵀ)∘Lᵀ; dB and dC summed
over the heads in f32 and rounded once) at zamba2's widths (P = N = 64, 4
heads, L = 256), with the inputs ``chip_smoke.py``'s ``[ssd-bwd]`` draws.
The split meets the card's limits against :func:`ssd_scan_backward_plain`
(dx and dlog_a within 2e-5 of their largest value; dB and dC as the card
tests hold bf16 gradients, or as f32 ones for f32 B and C); one pass a
product does not.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ssd_precision import tf32  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    KERNEL_CHUNK,
    ssd_scan_backward_plain,
    ssd_scan_plain,
)

H, L, P, N = 4, 256, 64, 64  # zamba2's head and state widths, a few heads
F32_LIMIT = 2e-5  # of the largest value: the card tests' limit on f32 gradients


def product(a, b, exact_a, exact_b, mode):
    """a @ b (batched) as the tensor cores compute it: TF32 operands, f32
    sums. ``mode`` "split": an operand that is not exact in TF32 contributes
    its high and low parts (lo·lo dropped); "one": every operand rounded
    once; "f32": no rounding of the operands."""
    if mode == "f32":
        return a @ b
    if mode == "one":
        return tf32(a) @ tf32(b)
    ah, bh = (a if exact_a else tf32(a)), (b if exact_b else tf32(b))
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    if not exact_a:
        out = out + tf32(a - ah) @ bh
    if not exact_b:
        out = out + ah @ tf32(b - bh)
    return out + ah @ bh


def backward_as_kernel(x, log_a, b_mat, c_mat, dy, ds_final, states, mode):
    """The kernel's gradient for one batch row, its products rounded as the
    tensor cores round them: (dx, dlog_a, dB, dC)."""
    exact = b_mat.dtype == torch.bfloat16
    q = KERNEL_CHUNK
    nck = L // q
    xc, dyc = x.view(H, nck, q, P), dy.view(H, nck, q, P)
    bc, cc = b_mat.float().view(nck, q, N), c_mat.float().view(nck, q, N)
    cum = log_a.view(H, nck, q).cumsum(-1)
    e, w = cum.exp(), (cum[..., -1:] - cum).exp()
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    lmat = torch.where(causal, (cum[..., :, None] - cum[..., None, :]).exp(), 0.0)

    # the sweep: dS leaving chunk k, from the final state's gradient back
    u = product((dyc * e[..., None]).transpose(-1, -2), cc, False, exact, mode)
    ds, s = [], ds_final.clone()
    for k in reversed(range(nck)):
        ds.append(s)
        s = e[:, k, -1, None, None] * s + u[:, k]
    ds = torch.stack(ds[::-1], dim=1)  # (H, nck, P, N)

    # phase A, rows i: dm, dy·S, M, dCB, dC
    dm = product(dyc, xc.transpose(-1, -2), False, False, mode)
    dys = product(dyc, states, False, False, mode)
    m = product(cc, bc.transpose(-1, -2), exact, exact, mode) * lmat
    dcb = dm * lmat
    dc = product(dcb, bc, False, exact, mode) + e[..., None] * dys
    dseg = dm * m
    cross = (cc * dys).sum(-1)
    # phase B, rows j: x·dS, dx, dB
    xds = product(xc, ds, False, False, mode)
    dsb = product(bc, ds.transpose(-1, -2), exact, False, mode)
    mt = product(bc, cc.transpose(-1, -2), exact, exact, mode) * lmat.transpose(-1, -2)
    dx = w[..., None] * dsb + product(mt, dyc, False, False, mode)
    dcbt = product(xc, dyc.transpose(-1, -2), False, False, mode) * lmat.transpose(-1, -2)
    db = product(dcbt, cc, False, exact, mode) + w[..., None] * xds
    dw = (bc * xds).sum(-1)

    dcum = dseg.sum(-1) - dseg.sum(-2) + e * cross - w * dw
    dcum[..., -1] += (w * dw).sum(-1) + e[..., -1] * (ds * states).sum((-2, -1))
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    dbs = db.sum(0).reshape(L, N).to(b_mat.dtype)  # over the heads in f32, rounded once
    dcs = dc.sum(0).reshape(L, N).to(c_mat.dtype)
    return dx.reshape(H, L, P)[None], dla.reshape(H, L)[None], dbs[None], dcs[None]


def inputs(bc_dtype):
    """``[ssd-bwd]``'s draw, with numpy: dt in [0.01, 0.2], A in [-2, -0.5],
    x = dt · N(0, 1), B and C N(0, 1) in ``bc_dtype``, dy and the final
    state's gradient N(0, 1); the chunk states from the plain forward."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    dt = rng.uniform(0.01, 0.2, (H, L)).astype(f32)
    a = -rng.uniform(0.5, 2.0, H).astype(f32)
    x = torch.from_numpy(rng.standard_normal((H, L, P)).astype(f32) * dt[..., None])
    log_a = torch.from_numpy(a[:, None] * dt)
    b_mat = torch.from_numpy(rng.standard_normal((L, N)).astype(f32)).to(bc_dtype)
    c_mat = torch.from_numpy(rng.standard_normal((L, N)).astype(f32)).to(bc_dtype)
    dy = torch.from_numpy(rng.standard_normal((H, L, P)).astype(f32))
    ds_final = torch.from_numpy(rng.standard_normal((H, P, N)).astype(f32))
    _, _, states = ssd_scan_plain(x[None], log_a[None], b_mat[None], c_mat[None],
                                  return_states=True)
    return x, log_a, b_mat, c_mat, dy, ds_final, states[0]


def within_f32(got, want) -> bool:
    return (got - want).abs().max().item() <= F32_LIMIT * max(1.0, want.abs().max().item())


def within_bf16(got, want) -> bool:
    """The card tests' rule for bf16 gradients (``_hold_grad``): 2 bf16 ulps
    of each row's largest value (floored at 2**-8 of the tensor's largest),
    and 2e-2 doubled for each power of two of the largest value past 2."""
    want = want.float()
    err = (got.float() - want).abs()
    big = want.abs().max().item()
    top = want.abs().amax(-1).clamp_min(max(big * 2.0**-8, 2.0**-10))
    ulps = (err.amax(-1) / torch.exp2(torch.floor(torch.log2(top)) - 7)).max().item()
    limit = 2e-2 * 2.0 ** max(0, math.floor(math.log2(big)) - 1)
    return err.max().item() <= limit and ulps <= 2


def held(grads, refs, bc_dtype) -> list[bool]:
    """Whether dx, dlog_a, dB and dC are each within the card's limits."""
    dx, dla, db, dc = grads
    rx, rla, rb, rc = refs
    bc_ok = within_bf16 if bc_dtype == torch.bfloat16 else within_f32
    return [within_f32(dx, rx), within_f32(dla, rla), bc_ok(db, rb), bc_ok(dc, rc)]


@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32], ids=["bf16_bc", "f32_bc"])
def test_split_passes_meet_the_card_limits(bc_dtype):
    x, log_a, b_mat, c_mat, dy, ds_final, states = inputs(bc_dtype)
    grads = backward_as_kernel(x, log_a, b_mat, c_mat, dy, ds_final, states, "split")
    refs = ssd_scan_backward_plain(x[None], log_a[None], b_mat[None], c_mat[None], dy[None],
                                   ds_final[None], states[None])
    assert held(grads, refs, bc_dtype) == [True] * 4


@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32], ids=["bf16_bc", "f32_bc"])
def test_one_tf32_pass_misses_the_card_limits(bc_dtype):
    x, log_a, b_mat, c_mat, dy, ds_final, states = inputs(bc_dtype)
    grads = backward_as_kernel(x, log_a, b_mat, c_mat, dy, ds_final, states, "one")
    refs = ssd_scan_backward_plain(x[None], log_a[None], b_mat[None], c_mat[None], dy[None],
                                   ds_final[None], states[None])
    ok = held(grads, refs, bc_dtype)
    assert not ok[0] and not ok[1]  # dx and dlog_a, the f32 gradients


def test_decomposition_without_rounding_is_the_plain_gradient():
    """With the operands unrounded the kernel's decomposition (the sweep, Mᵀ
    and dCBᵀ as products of their own, dB and dC summed over the heads) is
    the plain backward's gradient up to f32 summation order."""
    x, log_a, b_mat, c_mat, dy, ds_final, states = inputs(torch.float32)
    grads = backward_as_kernel(x, log_a, b_mat, c_mat, dy, ds_final, states, "f32")
    refs = ssd_scan_backward_plain(x[None], log_a[None], b_mat[None], c_mat[None], dy[None],
                                   ds_final[None], states[None])
    for got, want in zip(grads, refs):
        assert (got - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
