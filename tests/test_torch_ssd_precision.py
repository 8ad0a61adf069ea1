"""The SSD scan kernel's precision plan, held on the CPU.

``csrc/ssd_scan.cu`` runs its three chunk products on the tensor cores
with TF32 operands and f32 accumulation. One TF32 pass rounds each operand
to 2**-11 relative, too coarse for the kernel's tolerance against its plain
version (``SSD_ATOL = SSD_RTOL = 1e-4`` in ``chip_smoke.py`` and the card
tests). So the kernel splits every f32 operand into a TF32 high part and
the TF32 rounding of the rest, and sums lo·hi + hi·lo + hi·hi ("3xTF32");
a bf16 operand is exact in TF32 and is not split. Passes per product:

==================  ============  ===========
product             bf16 B and C  f32 B and C
==================  ============  ===========
C·Bᵀ                1             3
scores·x (f32 x)    3             3
C·Sᵀ                2             3
(x·w)ᵀ·B            2             3
==================  ============  ===========

These tests emulate that rounding in PyTorch (``cvt.rna.tf32.f32``: round
to nearest, ties away from zero, by adding half an ulp of the 13 dropped
mantissa bits and masking them) and run the kernel's chunk loop at zamba2's
shape (P = N = 64, 4 heads, L = 256), with the inputs ``chip_smoke.py``
draws. The split meets the tolerance against :func:`ssd_scan_plain`; a
single pass per product does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import KERNEL_CHUNK, ssd_scan_plain  # noqa: E402

ATOL = RTOL = 1e-4  # chip_smoke.SSD_ATOL / SSD_RTOL
H, L, P, N = 4, 256, 64, 64  # zamba2's head and state widths, its longest short prompt


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does."""
    bits = v.contiguous().numpy().view(np.uint32)
    rounded = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(rounded.copy())


def product(a: torch.Tensor, b: torch.Tensor, exact_a: bool, exact_b: bool,
            split: bool) -> torch.Tensor:
    """a @ b as the tensor cores compute it: TF32 operands, f32 sums. With
    ``split``, an operand that is not exact in TF32 contributes its high and
    low parts (the lo·lo term dropped); without, every operand is rounded
    once."""
    if not split:
        return tf32(a) @ tf32(b)
    ah, bh = (a if exact_a else tf32(a)), (b if exact_b else tf32(b))
    out = torch.zeros(a.shape[0], b.shape[1])
    if not exact_a:
        out += tf32(a - ah) @ bh
    if not exact_b:
        out += ah @ tf32(b - bh)
    return out + ah @ bh


def scan_as_kernel(x, log_a, b_mat, c_mat, split: bool):
    """The kernel's chunk loop for one batch row: per chunk C·Bᵀ, the decayed
    and masked scores, scores·x and exp(cum)·C·Sᵀ, then the state update."""
    exact_bc = b_mat.dtype == torch.bfloat16
    bf, cf = b_mat.float(), c_mat.float()
    q = KERNEL_CHUNK
    ys, states = [], []
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    for h in range(x.shape[0]):
        s = torch.zeros(P, N)
        y = torch.zeros(L, P)
        for t0 in range(0, L, q):
            xc, bc, cc = x[h, t0:t0 + q], bf[t0:t0 + q], cf[t0:t0 + q]
            cum = log_a[h, t0:t0 + q].cumsum(0)
            g = product(cc, bc.T, exact_bc, exact_bc, split)
            scores = torch.where(causal, g * (cum[:, None] - cum[None, :]).exp(), 0.0)
            intra = product(scores, xc, False, False, split)
            cross = product(cc, s.T, exact_bc, False, split)
            y[t0:t0 + q] = intra + cum.exp()[:, None] * cross
            w = (cum[-1] - cum).exp()
            s = cum[-1].exp() * s + product((xc * w[:, None]).T, bc, False, exact_bc, split)
        ys.append(y)
        states.append(s)
    return torch.stack(ys)[None], torch.stack(states)[None]


def inputs(bc_dtype):
    """chip_smoke.ssd_phase's draw, with numpy: dt in [0.01, 0.2], A in
    [-2, -0.5], x = dt · N(0, 1), B and C N(0, 1) in ``bc_dtype``."""
    rng = np.random.default_rng(3)
    dt = rng.uniform(0.01, 0.2, (H, L)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((H, L, P)).astype(np.float32) * dt[..., None])
    log_a = torch.from_numpy(a[:, None] * dt)
    b_mat = torch.from_numpy(rng.standard_normal((L, N)).astype(np.float32)).to(bc_dtype)
    c_mat = torch.from_numpy(rng.standard_normal((L, N)).astype(np.float32)).to(bc_dtype)
    return x, log_a, b_mat, c_mat


def excess(got, want) -> float:
    """How far the worst element lies past ATOL + RTOL·|want| (<= 0: within)."""
    return ((got - want).abs() - (ATOL + RTOL * want.abs())).max().item()


def test_tf32_split_is_exact_to_two_to_the_minus_22():
    rng = np.random.default_rng(0)
    scale = 10.0 ** rng.integers(-4, 4, 4096)
    v = torch.from_numpy((rng.standard_normal(4096) * scale).astype(np.float32))
    hi = tf32(v)
    lo = tf32(v - hi)
    assert np.all((hi.numpy().view(np.uint32) & 0x1FFF) == 0)
    assert torch.all((v - hi).abs() <= v.abs() * 2.0**-11)  # round to nearest: half an ulp
    assert torch.all((v - hi - lo).abs() <= v.abs() * 2.0**-22)
    ties = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)])  # exactly half a TF32 ulp
    assert torch.equal(tf32(ties), torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10)]))
    bf = v.to(torch.bfloat16).float()  # bf16 values are exact in TF32
    assert torch.equal(tf32(bf), bf)


@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32], ids=["bf16_bc", "f32_bc"])
def test_split_passes_meet_the_kernel_tolerance(bc_dtype):
    x, log_a, b_mat, c_mat = inputs(bc_dtype)
    y, s = scan_as_kernel(x, log_a, b_mat, c_mat, split=True)
    yp, sp = ssd_scan_plain(x[None], log_a[None], b_mat[None], c_mat[None])
    assert excess(y, yp) <= 0.0
    assert excess(s, sp) <= 0.0
    assert (y - yp).abs().max().item() < 1e-4 * yp.abs().max().item()


def test_one_tf32_pass_misses_the_kernel_tolerance():
    x, log_a, b_mat, c_mat = inputs(torch.bfloat16)
    y, _ = scan_as_kernel(x, log_a, b_mat, c_mat, split=False)
    yp, _ = ssd_scan_plain(x[None], log_a[None], b_mat[None], c_mat[None])
    assert excess(y, yp) > 0.0
    assert not torch.allclose(y, yp, atol=ATOL, rtol=RTOL)
