"""The port's attention kernels (plain versions on the CPU; the Hopper
kernels on a card) against the reference's Pallas kernels and oracles.

Inputs are drawn with numpy from a seed and handed to both packages. On
the CPU the port's wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)
from repro_torch.models import layers as tlayers  # noqa: E402

F32, BF16 = np.float32, "bf16"


def draw(rng, shape, dtype, scale=1.0):
    """(jax array, torch tensor) holding the same values."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    j = jnp.asarray(x)
    t = torch.from_numpy(x)
    if dtype == BF16:
        j = j.astype(jnp.bfloat16)
        t = t.to(torch.bfloat16)
    return j, t


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# Same shapes as tests/test_kernels.py::FLASH_CASES. Tolerances: f32 sums
# in another order than XLA's (softmax over up to 512 keys, D-long dots)
# stay within 2e-5 at unit-scale inputs; bf16 outputs are rounded to 8
# significant bits (ulp 2**-7 at |o| < 1), so 2e-2 allows a few ulps.
FLASH_CASES = [
    # (B, L, H, K, D, dtype, tol)
    (2, 256, 8, 2, 64, F32, 2e-5),
    (1, 512, 4, 1, 128, F32, 2e-5),  # MQA
    (2, 128, 4, 4, 32, F32, 2e-5),  # MHA
    (1, 256, 8, 8, 256, F32, 2e-5),  # gemma-style head_dim
    (2, 256, 8, 2, 64, BF16, 2e-2),
    (1, 384, 6, 2, 64, F32, 2e-5),  # non-pow2 length (divides 128)
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference(case, causal):
    B, L, H, K, D, dtype, tol = case
    rng = np.random.default_rng(0)
    jq, tq = draw(rng, (B, L, H, D), dtype)
    jk, tk = draw(rng, (B, L, K, D), dtype)
    jv, tv = draw(rng, (B, L, K, D), dtype)
    pallas = jops.flash_attention(
        jq, jk, jv, causal=causal, block_q=128, block_k=128, interpret=True
    )
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    flash_attention.launches = 0
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == 0  # the plain version is no launch
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(as_np(out), as_np(pallas), atol=tol)
    np.testing.assert_allclose(as_np(out), as_np(oracle), atol=tol)


# Same shapes as tests/test_kernels.py::PAGED_CASES; tolerances as above.
PAGED_CASES = [
    # (B, H, K, D, page, pages_per_seq, dtype, tol)
    (4, 8, 2, 64, 16, 8, F32, 2e-5),
    (2, 8, 1, 128, 16, 4, F32, 2e-5),  # MQA
    (3, 4, 4, 32, 32, 4, F32, 2e-5),
    (4, 8, 2, 64, 16, 8, BF16, 2e-2),
]


def _paged_inputs(rng, B, H, K, D, page, pps, dtype, total_pages):
    jq, tq = draw(rng, (B, H, D), dtype)
    jkp, tkp = draw(rng, (total_pages, page, K, D), dtype)
    jvp, tvp = draw(rng, (total_pages, page, K, D), dtype)
    bt = rng.permutation(total_pages)[: B * pps].reshape(B, pps).astype(np.int32)
    return (jq, jkp, jvp), (tq, tkp, tvp), bt


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_reference(case):
    B, H, K, D, page, pps, dtype, tol = case
    rng = np.random.default_rng(1)
    (jq, jkp, jvp), (tq, tkp, tvp), bt = _paged_inputs(
        rng, B, H, K, D, page, pps, dtype, B * pps * 2
    )
    lengths = rng.integers(1, pps * page + 1, size=(B,)).astype(np.int32)
    pallas = jops.paged_attention(
        jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(lengths), interpret=True
    )
    oracle = ref.paged_attention_ref(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(lengths))
    paged_attention.launches = 0
    out = paged_attention(
        tq, tkp, tvp, torch.from_numpy(bt), torch.from_numpy(lengths)
    )
    assert paged_attention.launches == 0
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(as_np(out), as_np(pallas), atol=tol)
    np.testing.assert_allclose(as_np(out), as_np(oracle), atol=tol)


def test_paged_plain_ignores_unmapped_pages():
    """Pages past `lengths` must not affect the output (poison test, as
    tests/test_kernels.py::test_paged_attention_ignores_unmapped_pages)."""
    rng = np.random.default_rng(2)
    B, H, K, D, page, pps = 2, 4, 2, 64, 16, 4
    _, (tq, tkp, tvp), bt = _paged_inputs(rng, B, H, K, D, page, pps, F32, 16)
    lengths = np.array([20, 35], np.int32)
    bt_t, len_t = torch.from_numpy(bt), torch.from_numpy(lengths)
    base = paged_attention_plain(tq, tkp, tvp, bt_t, len_t)
    kp2, vp2 = tkp.clone(), tvp.clone()
    for b in range(B):
        for j in range(math.ceil(lengths[b] / page), pps):
            kp2[int(bt[b, j])] = 1e9
            vp2[int(bt[b, j])] = 1e9
    out = paged_attention_plain(tq, kp2, vp2, bt_t, len_t)
    np.testing.assert_allclose(out.numpy(), base.numpy(), atol=1e-4)


@pytest.mark.parametrize(
    "dtype,tol", [(F32, 2e-5), (BF16, 2e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("scalar_len", [False, True], ids=["per-slot", "scalar"])
def test_slot_cache_as_pages_matches_decode_attention(dtype, tol, scalar_len):
    """The slot cache viewed as 16-token pages (block table
    b*(c_max/16)+j, lengths index+1) equals the reference's
    models/layers.py::decode_attention over the same cache."""
    rng = np.random.default_rng(3)
    B, S, H, K, D = 4, 64, 8, 2, 32
    jq, tq = draw(rng, (B, 1, H, D), dtype)
    jk, tk = draw(rng, (B, S, K, D), dtype)
    jv, tv = draw(rng, (B, S, K, D), dtype)
    if scalar_len:
        cur = 37
        j_len, t_len = cur, cur
    else:
        cur = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
        j_len, t_len = jnp.asarray(cur), torch.from_numpy(cur)
    expect = jlayers.decode_attention(jq, jk, jv, j_len)
    out = tlayers.decode_attention(tq, tk, tv, t_len)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    np.testing.assert_allclose(as_np(out), as_np(expect), atol=tol)


def test_slot_block_table_layout():
    bt = ops.slot_block_table(3, 64, torch.device("cpu"))
    assert bt.dtype == torch.int32 and bt.shape == (3, 4)
    assert bt.tolist() == [[4 * b + j for j in range(4)] for b in range(3)]
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.slot_block_table(2, 40, torch.device("cpu"))


def test_wrappers_check_cuda_operands():
    """The kernel-side checks refuse what the kernels do not take."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    q = torch.zeros(1, 4, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa._check(q, q[:, :2], q[:, :2], True)
    with pytest.raises(ValueError, match="CUDA"):
        pa._check(q[:, :, 0], torch.zeros(4, 16, 2, 32), torch.zeros(4, 16, 2, 32),
                  torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    assert pa.smem_bytes(32, 4, 128) < pa.MAX_SMEM
