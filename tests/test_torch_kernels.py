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


def _lse_oracle(q, kp, bt, lengths, k_scales=None) -> np.ndarray:
    """Each row's log-sum-exp of its scaled scores over its valid
    positions, in f64 with numpy (-inf for a row of length 0)."""
    qn, kn = q.double().numpy(), kp.double().numpy()
    if k_scales is not None:
        kn = kn * k_scales.double().numpy()
    b, h, d = qn.shape
    n_kv = kn.shape[2]
    out = np.full((b, h), -np.inf)
    for i in range(b):
        keys = kn[bt[i]].reshape(-1, n_kv, d)[: int(lengths[i])]
        for j in range(h):
            s = keys[:, j // (h // n_kv)] @ qn[i, j] / math.sqrt(d)
            if s.size:
                out[i, j] = np.logaddexp.reduce(s)
    return out


@pytest.mark.parametrize("case", PAGED_CASES + ["int8"])
def test_paged_plain_lse(case):
    """``return_lse``: each row's log-sum-exp (f32, the scaled-score units)
    against a numpy f64 oracle within 1e-4 (the sums of at most 128
    unit-scale products in f32), bf16, f32 and int8 pages (the scale
    applied to K); the output as without it, bit for bit."""
    rng = np.random.default_rng(11)
    scales = ()
    if case == "int8":
        B, H, K, D, page, pps = 3, 8, 2, 64, 16, 4
        tq = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
        tkp, tvp = (torch.from_numpy(rng.integers(-127, 128, (B * pps, page, K, D)).astype(np.int8))
                    for _ in range(2))
        scales = tuple(torch.from_numpy(rng.uniform(0.005, 0.02, (B * pps, page, K, 1))
                                        .astype(np.float16)) for _ in range(2))
        bt = rng.permutation(B * pps).reshape(B, pps).astype(np.int32)
    else:
        B, H, K, D, page, pps, dtype, _ = case
        _, (tq, tkp, tvp), bt = _paged_inputs(rng, B, H, K, D, page, pps, dtype, B * pps * 2)
    lengths = rng.integers(1, pps * page + 1, size=(B,)).astype(np.int32)
    args = (tq, tkp, tvp, torch.from_numpy(bt), torch.from_numpy(lengths), *scales)
    out, lse = paged_attention_plain(*args, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, paged_attention_plain(*args))
    want = _lse_oracle(tq, tkp, bt, lengths, scales[0] if scales else None)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-4, rtol=0)


def test_paged_plain_rows_of_length_zero():
    """A row of length 0 (a sequence shard past a slot's length) gives an
    output of 0 and an lse of -inf, with no NaN; the other rows are as they
    are without it."""
    rng = np.random.default_rng(12)
    B, H, K, D, page, pps = 3, 4, 2, 32, 16, 2
    _, (tq, tkp, tvp), bt = _paged_inputs(rng, B, H, K, D, page, pps, F32, B * pps)
    lengths = torch.tensor([0, 17, 0], dtype=torch.int32)
    out, lse = paged_attention_plain(tq, tkp, tvp, torch.from_numpy(bt), lengths,
                                     return_lse=True)
    assert not out.isnan().any() and not lse.isnan().any()
    assert not out[[0, 2]].any() and torch.isneginf(lse[[0, 2]]).all()
    alone, alone_lse = paged_attention_plain(tq[1:2], tkp, tvp, torch.from_numpy(bt[1:2]),
                                             lengths[1:2], return_lse=True)
    assert torch.equal(out[1:2], alone) and torch.equal(lse[1:2], alone_lse)


def test_combine_partials_of_two_halves_is_the_whole():
    """A cache cut into two halves by position: each half's output and lse
    (local lengths clamp(length - offset, 0, half); a row inside the first
    half has none in the second), merged by ``combine_partials``, equal
    the whole cache's within 1e-6."""
    from repro_torch.kernels.paged_attention import combine_partials

    rng = np.random.default_rng(13)
    B, S, H, K, D = 3, 64, 8, 2, 32
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, K, D)).astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([64, 20, 33], dtype=torch.int32)
    want, want_lse = ops._paged_over_slots(q, k, v, lengths, return_lse=True)
    halves = [ops._paged_over_slots(q, k[:, i:i + S // 2].contiguous(),
                                    v[:, i:i + S // 2].contiguous(),
                                    (lengths - i).clamp(0, S // 2).int(), return_lse=True)
              for i in (0, S // 2)]
    assert torch.isneginf(halves[1][1][1]).all()

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    out, lse = combine_partials(torch.stack([h[0] for h in halves]),
                                torch.stack([h[1] for h in halves]), stacked)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6)


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
    # The split: one wave of CTAs at most, none without a 64-position tile.
    assert pa.split_count(8, 32, 4, 512, 132) == 4
    assert pa.split_count(17, 32, 4, 1 << 20, 132) == 1
    assert pa.split_count(2, 32, 4, 128, 132) == 2
