"""The port's Hopper kernels against their plain versions, on the card,
and the torch DES tier on the card against its CPU run.

Every test here is marked ``cuda`` and skips without a GPU (the CUDA
kernels have no CPU mode). The file imports neither jax nor the reference
package, so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_gpu.py
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    backward_schedule,
    backward_variant,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_plain,
    variant,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
    split_count,
)
from repro_torch.kernels.sim_decode import (  # noqa: E402
    OUTPUTS,
    decode_advance,
    decode_advance_plain,
    random_state,
)
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    bwd_variant,
    ssd_scan,
    ssd_scan_backward,
    ssd_scan_backward_plain,
    ssd_scan_plain,
)

pytestmark = pytest.mark.cuda

# Tolerances: the kernel and the plain version both accumulate in f32 and
# differ only in summation order (f32 cases) and, for bf16 outputs, in
# which neighbouring bf16 value the f32 result rounds to (ulp 2**-7 at
# |o| < 1): 2e-5 and 2e-2.
FLASH_CASES = [
    # (B, L, H, K, D, dtype, tol)
    (2, 256, 8, 2, 64, torch.float32, 2e-5),
    (1, 512, 4, 1, 128, torch.float32, 2e-5),  # MQA
    (2, 128, 4, 4, 32, torch.float32, 2e-5),  # MHA
    (1, 256, 8, 8, 256, torch.float32, 2e-5),  # gemma-style head_dim
    (2, 256, 8, 2, 64, torch.bfloat16, 2e-2),
    (1, 200, 6, 2, 64, torch.float32, 2e-5),  # ragged length
    (1, 1024, 32, 4, 128, torch.bfloat16, 2e-2),  # yi-6b widths
    (1, 256, 32, 32, 80, torch.bfloat16, 2e-2),  # zamba2's shared attention
    (2, 200, 4, 4, 80, torch.float32, 2e-5),  # D = 80, ragged length
    # Lengths ragged against the 64-key tiles and the TMA box, at each
    # tensor-core head dim; GQA G = 8 and MQA.
    (2, 1, 32, 4, 128, torch.bfloat16, 2e-2),
    (2, 63, 8, 1, 64, torch.bfloat16, 2e-2),  # MQA
    (1, 65, 16, 2, 80, torch.bfloat16, 2e-2),
    (2, 200, 8, 8, 256, torch.bfloat16, 2e-2),
    (1, 65, 32, 4, 128, torch.bfloat16, 2e-2),
    (2, 200, 8, 1, 128, torch.bfloat16, 2e-2),  # MQA
    (1, 63, 32, 32, 80, torch.bfloat16, 2e-2),
    (1, 1, 4, 4, 64, torch.bfloat16, 2e-2),
    (1, 128, 4, 2, 256, torch.bfloat16, 2e-2),
    (1, 1, 4, 1, 32, torch.bfloat16, 2e-2),  # D = 32: the CUDA-core variant
    # The MoE family's heads: qwen3-235b's GQA group of 16, llama4's of 5
    (1, 256, 64, 4, 128, torch.bfloat16, 2e-2),  # qwen3-235b widths
    (1, 65, 40, 8, 128, torch.bfloat16, 2e-2),  # llama4 widths, ragged length
    (2, 200, 16, 1, 64, torch.float32, 2e-5),  # G = 16 on the CUDA cores
    # qwen2-vl-7b's GQA group of 7 (H 28, K 4) and musicgen-medium's MHA at D 64
    (1, 256, 28, 4, 128, torch.bfloat16, 2e-2),
    (2, 65, 28, 4, 128, torch.bfloat16, 2e-2),
    (1, 256, 24, 24, 64, torch.bfloat16, 2e-2),
    # gemma-2b's D 256 on one KV head (G 8) at a ragged length, granite-34b's
    # G 48 on one KV head, llama3-70b's H 64 K 8
    (1, 200, 8, 1, 256, torch.bfloat16, 2e-2),
    (1, 256, 48, 1, 128, torch.bfloat16, 2e-2),
    (1, 256, 64, 8, 128, torch.bfloat16, 2e-2),
]

# Full attention with a kv length other than q's (musicgen's cross-attention
# to a 256-position memory at prefill): kv tiles ragged against 64, shorter
# and longer than q, one query.
FLASH_CROSS_CASES = [
    # (B, Lq, Lk, H, K, D, dtype, tol)
    (2, 200, 256, 24, 24, 64, torch.bfloat16, 2e-2),  # musicgen prefill
    (1, 1, 256, 24, 24, 64, torch.bfloat16, 2e-2),
    (1, 65, 16, 24, 24, 64, torch.bfloat16, 2e-2),  # the reduced memory length
    (1, 130, 300, 28, 4, 128, torch.bfloat16, 2e-2),  # G = 7, both ragged
    (2, 200, 100, 8, 2, 64, torch.float32, 2e-5),  # the CUDA-core variant
]

# Lengths: None draws them at random in [1, pps * page]. The kernel splits
# each sequence, for each KV head, over ``split_count`` CTAs of
# ceil(length / S) positions; cases below put a share's boundary inside a
# page, leave shares empty (sequences much shorter than the split), run
# the paper's long pool (2 slots x 65,536, Table 2's c_max) at yi-6b widths,
# and a table of 2**20 positions a sequence on one CTA each (S = 1: 17 slots
# fill the card), whose shared memory must not grow with the table.
PAGED_CASES = [
    # (B, H, K, D, page, pages_per_seq, q dtype, page dtype, tol, lengths)
    (4, 8, 2, 64, 16, 8, torch.float32, torch.float32, 2e-5, None),
    (2, 8, 1, 128, 16, 4, torch.float32, torch.float32, 2e-5, None),  # MQA
    (3, 4, 4, 32, 32, 4, torch.float32, torch.bfloat16, 2e-5, None),
    (8, 32, 4, 128, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, None),  # yi-6b
    (8, 32, 32, 80, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, None),  # zamba2
    (3, 4, 4, 80, 16, 4, torch.float32, torch.float32, 2e-5, None),
    (5, 32, 4, 128, 16, 8, torch.bfloat16, torch.bfloat16, 2e-2, [1, 16, 64, 65, 128]),
    (2, 8, 1, 64, 16, 9, torch.bfloat16, torch.bfloat16, 2e-2, [144, 100]),  # boundary in a page
    (2, 8, 2, 128, 16, 64, torch.bfloat16, torch.bfloat16, 2e-2, [1, 70]),  # empty shares
    (2, 32, 32, 80, 16, 64, torch.bfloat16, torch.bfloat16, 2e-2, [3, 1024]),
    (2, 32, 4, 128, 16, 4096, torch.bfloat16, torch.bfloat16, 2e-2, [65_536, 40_000]),  # long
    (17, 32, 4, 128, 16, 65_536, torch.bfloat16, torch.bfloat16, 2e-2,
     [4096] + [1 + 241 * i for i in range(16)]),  # S = 1, 2**20 mapped
    (2, 8, 2, 256, 16, 8, torch.float32, torch.float32, 2e-5, None),  # one-stage ring
    # qwen3-235b's G = 16 (two head-group CTAs a KV head) and llama4's G = 5
    # (5 of a CTA's 8 head lanes)
    (8, 64, 4, 128, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, None),
    (5, 40, 8, 128, 16, 8, torch.bfloat16, torch.bfloat16, 2e-2, [1, 16, 64, 65, 128]),
    # qwen3's long pool (2 slots x 2048): 8 splits on 132 SMs
    (2, 64, 4, 128, 16, 128, torch.bfloat16, torch.bfloat16, 2e-2, [2048, 1990]),
    # qwen2-vl-7b's G = 7 (7 of a CTA's 8 head lanes), short and long pool
    (8, 28, 4, 128, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, None),
    (2, 28, 4, 128, 16, 128, torch.bfloat16, torch.bfloat16, 2e-2, [2048, 300]),
    # musicgen-medium: self-attention at D 64, G 1; the cross cache (every
    # one of its 256 memory positions valid)
    (8, 24, 24, 64, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, None),
    (8, 24, 24, 64, 16, 16, torch.bfloat16, torch.bfloat16, 2e-2, [256] * 8),
    # gemma-2b: bf16 pages at D 256 (512-byte rows, the two-stage ring) on
    # one KV head, G 8, S 8, lengths that leave shares empty; granite-34b's
    # G 48 on one KV head (six head-group CTAs, S 2), ragged lengths;
    # llama3-70b's H 64 K 8
    (8, 8, 1, 256, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, [1, 2, 9, 17, 64, 65, 300, 512]),
    (8, 48, 1, 128, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2,
     [1, 16, 64, 65, 128, 200, 333, 512]),
    (8, 64, 8, 128, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2, None),
]

INT8_CASES = [
    # (B, H, K, D, page, pages_per_seq, q dtype, scale dtype, tol, lengths):
    # both compute in f32 from the int8 values and their scales (the plain
    # version scales each value, the kernel each dot product and
    # probability), so they differ by f32 rounding
    (8, 32, 4, 128, 16, 32, torch.bfloat16, torch.float16, 2e-2, None),  # yi-6b, f16 scales
    (8, 32, 4, 128, 16, 32, torch.float32, torch.float16, 2e-5, None),  # yi-6b widths, f32 q
    (3, 8, 2, 64, 16, 4, torch.float32, torch.float32, 2e-5, None),  # the reference test's shape
    (2, 32, 32, 80, 16, 8, torch.float32, torch.float16, 2e-5, None),  # D = 80
    (2, 8, 1, 64, 16, 9, torch.bfloat16, torch.float16, 2e-2, [144, 100]),  # boundary in a page
    (2, 32, 4, 128, 16, 64, torch.bfloat16, torch.float16, 2e-2, [1, 70]),  # empty shares
    (2, 32, 4, 128, 16, 4096, torch.bfloat16, torch.float16, 2e-2, [65_536, 1000]),  # long
    (8, 8, 1, 256, 16, 32, torch.bfloat16, torch.float16, 2e-2, None),  # D 256, G 8
]

SSD_CASES = [
    # (B, L, H, P, N, x dtype, B/C dtype, atol, rtol): f32 differs from the
    # plain version by summation order and the split TF32 products' dropped
    # lo.lo terms (~2**-22 relative); bf16 y rounds an f32 result
    (1, 256, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),  # zamba2 prefill
    (1, 200, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),  # ragged tail
    (2, 1, 4, 32, 16, torch.float32, torch.float32, 1e-4, 1e-4),  # one step
    (2, 130, 3, 16, 8, torch.bfloat16, torch.bfloat16, 2e-2, 2**-7),
    # zamba2 widths at lengths around the 64-step chunk
    (1, 1, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),
    (1, 63, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),
    (1, 64, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),
    (1, 65, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),
    (1, 129, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),
    (1, 256, 80, 64, 64, torch.float32, torch.float32, 1e-4, 1e-4),  # f32 B/C: three passes
    (2, 200, 8, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),  # B = 2
    (1, 130, 8, 32, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),  # P = 32
    # bf16 rows of 8 bytes (element-wise copies) and P below the CTA's tile
    (1, 70, 2, 4, 4, torch.bfloat16, torch.bfloat16, 2e-2, 2**-7),
    (1, 130, 4, 16, 256, torch.float32, torch.float32, 1e-4, 1e-4),  # one buffer (large N)
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, case, causal):
    """Head-major operands against the plain version; a second launch and
    the same data in the model's (B, L, H, D) layout (strided views, no
    copy) give the same bits; bf16 at head dims 64, 80 and 128 counts on the
    tensor-core variant."""
    B, L, H, K, D, dtype, tol = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (B, H, L, D), dtype, cuda)
    k = _randn(gen, (B, K, L, D), dtype, cuda)
    v = _randn(gen, (B, K, L, D), dtype, cuda)
    kind = variant(D, dtype)
    if dtype == torch.bfloat16 and D in (64, 80, 128):
        assert kind == "tc"
    if dtype == torch.float32 or D == 32:
        assert kind == "simt"
    counter = "launches_tc" if kind == "tc" else "launches_simt"
    before, before_kind = flash_attention.launches, getattr(flash_attention, counter)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert getattr(flash_attention, counter) == before_kind + 1
    expect = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=0)
    assert torch.equal(flash_attention(q, k, v, causal=causal), out)
    qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    om = ops.flash_attention(qm, km, vm, causal=causal)
    assert om.is_contiguous() and om.shape == (B, L, H, D)
    assert torch.equal(om, out.transpose(1, 2))


@pytest.mark.parametrize("case", FLASH_CROSS_CASES)
def test_flash_kernel_full_attention_other_kv_length(cuda, case):
    """Non-causal attention with Lq != Lk against the plain version, head-
    major and through the model layout (the cross-attention's call); causal
    attention with Lq != Lk is refused."""
    B, Lq, Lk, H, K, D, dtype, tol = case
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (B, H, Lq, D), dtype, cuda)
    k = _randn(gen, (B, K, Lk, D), dtype, cuda)
    v = _randn(gen, (B, K, Lk, D), dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.shape == q.shape
    expect = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=0)
    qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    assert torch.equal(ops.flash_attention(qm, km, vm, causal=False), out.transpose(1, 2))
    with pytest.raises(ValueError, match="Lq == Lk"):
        flash_attention(q, k, v, causal=True)


def _lengths(gen, lengths, B, mapped, device):
    if lengths is None:
        return torch.randint(1, mapped + 1, (B,), generator=gen, device=device, dtype=torch.int32)
    return torch.tensor(lengths, dtype=torch.int32, device=device)


def _reach(pps, page, lens):
    """Pages a sequence's table maps that some length reaches."""
    return pps if lens is None else min(pps, -(-max(lens) // page))


def _table(gen, total, B, pps, reach, device):
    """A block table whose first ``reach`` entries a row are distinct pages
    of the pool (the poison check needs them apart); the entries past every
    length name one spare page, so a long table needs no pool of its size."""
    perm = torch.randperm(total, generator=gen, device=device)
    bt = perm[: B * reach].view(B, reach)
    if reach < pps:
        bt = torch.cat([bt, perm[B * reach].expand(B, pps - reach)], 1)
    return bt.to(torch.int32).contiguous()


def _check_split(case, cuda):
    """What a case with given lengths is there to show, under the split the
    wrapper picks: S CTAs a sequence, shares of ceil(length / S) positions."""
    B, H, K, D, page, pps = case[:6]
    lens = case[-1]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    s = split_count(B, H, K, pps * page, sms)
    chunks = [] if lens is None else [-(-n // s) for n in lens]
    if lens == [144, 100]:  # every share boundary falls inside a page
        assert s == 2 and all(c % page for c in chunks)
    if lens in ([1, 70], [1, 16, 64, 65, 128], [1, 2, 9, 17, 64, 65, 300, 512]):
        # some CTAs hold an empty share
        assert any(sh * c >= n for n, c in zip(lens, chunks) for sh in range(s))
    if pps * page >= 1 << 20:  # one CTA walks each sequence
        assert s == 1


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_and_skips_dead_pages(cuda, case):
    B, H, K, D, page, pps, qdt, kdt, tol, lens = case
    _check_split(case, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    reach = _reach(pps, page, lens)
    total = B * reach * 2
    q = _randn(gen, (B, H, D), qdt, cuda)
    kp = _randn(gen, (total, page, K, D), kdt, cuda)
    vp = _randn(gen, (total, page, K, D), kdt, cuda)
    bt = _table(gen, total, B, pps, reach, cuda)
    lengths = _lengths(gen, lens, B, pps * page, cuda)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), paged_attention_plain(q, kp, vp, bt[:, :reach], lengths).float(),
        atol=tol, rtol=0,
    )
    for b in range(B):  # poison every page past each length: never read
        dead = bt[b, math.ceil(int(lengths[b]) / page):].long()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
    assert torch.equal(paged_attention(q, kp, vp, bt, lengths), out)


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_paged_kernel_matches_plain_and_skips_dead_pages(cuda, case):
    B, H, K, D, page, pps, qdt, sdt, tol, lens = case
    _check_split(case, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    reach = _reach(pps, page, lens)
    total = B * reach * 2
    q = _randn(gen, (B, H, D), qdt, cuda)
    kp = torch.randint(-127, 128, (total, page, K, D), generator=gen, device=cuda, dtype=torch.int8)
    vp = torch.randint(-127, 128, (total, page, K, D), generator=gen, device=cuda, dtype=torch.int8)
    ks = (torch.rand((total, page, K, 1), generator=gen, device=cuda) * 0.02 + 1e-3).to(sdt)
    vs = (torch.rand((total, page, K, 1), generator=gen, device=cuda) * 0.02 + 1e-3).to(sdt)
    bt = _table(gen, total, B, pps, reach, cuda)
    lengths = _lengths(gen, lens, B, pps * page, cuda)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, bt, lengths, ks, vs)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), paged_attention_plain(q, kp, vp, bt[:, :reach], lengths, ks, vs).float(),
        atol=tol, rtol=0,
    )
    for b in range(B):  # poison every scale past each length: never read
        dead = bt[b, math.ceil(int(lengths[b]) / page):].long()
        ks[dead] = float("nan")
        vs[dead] = float("nan")
    assert torch.equal(paged_attention(q, kp, vp, bt, lengths, ks, vs), out)


#: The paged kernel's log-sum-exp: (B, H, K, D, q dtype, page dtype,
#: lengths); one length 0 a case, ragged ones, a split boundary.
LSE_CASES = [
    (4, 8, 2, 64, torch.float32, torch.float32, [0, 1, 100, 512]),
    (3, 32, 4, 128, torch.bfloat16, torch.bfloat16, [512, 0, 257]),
    (2, 32, 4, 128, torch.float32, torch.bfloat16, [300, 0]),  # the sharded decode's f32 q
    (3, 24, 24, 64, torch.float32, torch.int8, [0, 64, 511]),
    (2, 8, 1, 256, torch.bfloat16, torch.int8, [17, 0]),
]


def _slot_cache(gen, B, S, K, D, kdt, device):
    """A slot cache (k, v[, k_scale, v_scale]) of B x S positions."""
    if kdt == torch.int8:
        kv = [torch.randint(-127, 128, (B, S, K, D), generator=gen, device=device,
                            dtype=torch.int8) for _ in range(2)]
        return (*kv, *((torch.rand((B, S, K, 1), generator=gen, device=device) * 0.02 + 1e-3)
                       .half() for _ in range(2)))
    return tuple(_randn(gen, (B, S, K, D), kdt, device) for _ in range(2))


@pytest.mark.parametrize("case", LSE_CASES)
def test_paged_kernel_lse_matches_plain(cuda, case):
    """``return_lse``: the kernel's log-sum-exp against the plain version's
    (1e-4), the output bit for bit as without it; a row of length 0 gives
    an output of 0 and an lse of -inf, no NaN."""
    B, H, K, D, qdt, kdt, lens = case
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = _randn(gen, (B, H, D), qdt, cuda)
    cache = _slot_cache(gen, B, 512, K, D, kdt, cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out, lse = ops._paged_over_slots(q, *cache[:2], lengths, *cache[2:], return_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, ops._paged_over_slots(q, *cache[:2], lengths, *cache[2:]))
    pages = [t.view(-1, ops.PAGE, K, t.shape[-1]) for t in cache]
    bt = ops.slot_block_table(B, 512, cuda)
    want_out, want = paged_attention_plain(q, *pages[:2], bt, lengths, *pages[2:],
                                           return_lse=True)
    empty = lengths == 0
    assert not out.isnan().any() and not lse.isnan().any()
    assert not out[empty].any() and torch.isneginf(lse[empty]).all()
    torch.testing.assert_close(lse[~empty], want[~empty], atol=1e-4, rtol=0)
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("kdt", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_paged_kernel_two_shards_combine_to_the_whole(cuda, kdt):
    """A slot cache cut into two shards by position (the sequence-sharded
    decode's, local lengths clamp(length - offset, 0, S/2); one row inside
    the first shard), each shard's kernel output and lse with q in f32,
    merged by ``combine_partials``: the whole cache's kernel output within
    2e-5 and its lse within 1e-4."""
    from repro_torch.kernels.paged_attention import combine_partials

    gen = torch.Generator(device=cuda).manual_seed(9)
    B, S, H, K, D = 4, 512, 32, 4, 128
    q = _randn(gen, (B, H, D), torch.float32, cuda)
    cache = _slot_cache(gen, B, S, K, D, kdt, cuda)
    lengths = torch.tensor([512, 100, 256, 257], dtype=torch.int32, device=cuda)
    want, want_lse = ops._paged_over_slots(q, *cache[:2], lengths, *cache[2:], return_lse=True)
    parts = [ops._paged_over_slots(q, *(t[:, i:i + S // 2].contiguous() for t in cache[:2]),
                                   (lengths - i).clamp(0, S // 2).to(torch.int32),
                                   *(t[:, i:i + S // 2].contiguous() for t in cache[2:]),
                                   return_lse=True)
             for i in (0, S // 2)]
    assert torch.isneginf(parts[1][1][1]).all()

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    out, lse = combine_partials(torch.stack([o for o, _ in parts]),
                                torch.stack([l_ for _, l_ in parts]), stacked)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


def _ssd_inputs(gen, B, L, H, P, N, xdt, bcdt, device):
    """Inputs as the model gives them: x already times dt, log_a = A * dt."""
    dt = torch.rand((B, H, L), generator=gen, device=device) * 0.19 + 0.01
    a = -(torch.rand((H,), generator=gen, device=device) * 1.5 + 0.5)
    x = (torch.randn((B, H, L, P), generator=gen, device=device) * dt[..., None]).to(xdt)
    log_a = (a[None, :, None] * dt).contiguous()
    bm = torch.randn((B, L, N), generator=gen, device=device).to(bcdt)
    cm = torch.randn((B, L, N), generator=gen, device=device).to(bcdt)
    return x, log_a, bm, cm


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, case):
    B, L, H, P, N, xdt, bcdt, atol, rtol = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    args = _ssd_inputs(gen, B, L, H, P, N, xdt, bcdt, cuda)
    before = ssd_scan.launches
    y, s = ssd_scan(*args)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == xdt and s.dtype == torch.float32 and s.shape == (B, H, P, N)
    yp, sp = ssd_scan_plain(*args)
    torch.testing.assert_close(y.float(), yp.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(s, sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_forward_writes_chunk_states_without_changing_its_output(cuda, case):
    """With the chunk states asked for (the backward's input), y and the
    final state are bit for bit those of the forward without them, and the
    states are the plain version's within the forward's tolerance."""
    B, L, H, P, N, xdt, bcdt, atol, rtol = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    args = _ssd_inputs(gen, B, L, H, P, N, xdt, bcdt, cuda)
    y, s = ssd_scan(*args)
    y1, s1, states = ssd_scan(*args, return_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y) and torch.equal(s1, s)
    assert states.shape == (B, H, -(-L // 64), P, N) and states.dtype == torch.float32
    _, _, want = ssd_scan_plain(*args, return_states=True)
    torch.testing.assert_close(states, want, atol=1e-4, rtol=1e-4)


# The backward's cases: SSD_CASES' shapes (B, L, H, P, N, x dtype, B/C
# dtype) and ragged lengths, N = 128 (two N tiles) and 256 (four), P = 96
# (two P tiles), every one with a nonzero final-state gradient
SSD_BWD_CASES = [c[:7] for c in SSD_CASES] + [
    (2, 2048, 80, 64, 64, torch.float32, torch.bfloat16),  # zamba2's training shape
    (1, 333, 8, 64, 64, torch.float32, torch.bfloat16),
    (2, 50, 4, 32, 128, torch.float32, torch.bfloat16),
    (1, 130, 3, 64, 128, torch.float32, torch.float32),
    (1, 100, 2, 96, 32, torch.float32, torch.float32),
    # zamba2's widths at 13 heads, where the wrapper's group (4 heads at B
    # 2, L 2048 on 132 SMs) does not divide H
    (2, 2048, 13, 64, 64, torch.float32, torch.bfloat16),
]


def _hold_ssd_grad(out, ref, what):
    """f32 gradients (dx, dlog_a) within 2e-5 of the largest value (the two
    sum the same f32 products in other orders); bf16 ones (dB and dC of
    bf16 B/C, dx of bf16 x: one rounding of an f32 result) as
    ``_hold_grad`` holds bf16 gradients."""
    assert out.shape == ref.shape and out.dtype == ref.dtype, what
    _hold_grad(out, ref, out.dtype, what)


@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda, case):
    """``csrc/ssd_scan_bwd.cu`` against ``ssd_scan_backward_plain`` on the
    kernel forward's chunk states, with and without a final-state gradient;
    two launches bit for bit; one count a call."""
    B, L, H, P, N, xdt, bcdt = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, log_a, bm, cm = _ssd_inputs(gen, B, L, H, P, N, xdt, bcdt, cuda)
    dy = _randn(gen, (B, H, L, P), xdt, cuda)
    ds = _randn(gen, (B, H, P, N), torch.float32, cuda)
    _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)
    for ds_final in (ds, None):
        args = (x, log_a, bm, cm, dy, ds_final, states)
        before = ssd_scan_backward.launches
        grads = ssd_scan_backward(*args)
        again = ssd_scan_backward(*args)
        torch.cuda.synchronize()
        assert ssd_scan_backward.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        refs = ssd_scan_backward_plain(*args)
        for name, g, r in zip(("dx", "dlog_a", "dB", "dC"), grads, refs):
            _hold_ssd_grad(g, r, name)


# (B, L, H, group): head groups that do not divide H (13 heads in groups of
# 5, and the wrapper's choice, None), one group holding every head (B 2, 3
# heads, a group of 8), a head a group; zamba2's widths and bf16 B/C. A
# group other than the wrapper's is forced through ``bwd_group``.
SSD_BWD_GROUPS = [
    (1, 512, 13, None),
    (1, 512, 13, 5),
    (2, 200, 3, 8),
    (2, 130, 5, 1),
]


@pytest.mark.parametrize("case", SSD_BWD_GROUPS)
def test_ssd_backward_head_groups(cuda, case, monkeypatch):
    """The tensor-core variant sums dB and dC over each CTA's group of
    heads: any grouping of H gives the plain version's gradients, two
    launches bit for bit, one count on the variant's counter a call."""
    B, L, H, group = case
    if group is not None:
        monkeypatch.setattr(ssd_mod, "bwd_group", lambda *_: group)
    gen = torch.Generator(device=cuda).manual_seed(10)
    x, log_a, bm, cm = _ssd_inputs(gen, B, L, H, 64, 64, torch.float32, torch.bfloat16, cuda)
    dy = _randn(gen, (B, H, L, 64), torch.float32, cuda)
    ds = _randn(gen, (B, H, 64, 64), torch.float32, cuda)
    _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)
    args = (x, log_a, bm, cm, dy, ds, states)
    assert bwd_variant(64, 64) == "tc"
    before = (ssd_scan_backward.launches_tc, ssd_scan_backward.launches_simt)
    grads = ssd_scan_backward(*args)
    again = ssd_scan_backward(*args)
    torch.cuda.synchronize()
    assert (ssd_scan_backward.launches_tc, ssd_scan_backward.launches_simt) == (
        before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    refs = ssd_scan_backward_plain(*args)
    for name, g, r in zip(("dx", "dlog_a", "dB", "dC"), grads, refs):
        _hold_ssd_grad(g, r, name)


def test_ssd_backward_variants_by_width(cuda):
    """P and N up to 64 take the tensor-core chunk kernel, wider ones the
    CUDA-core kernel, each on its own counter."""
    assert [bwd_variant(p, n) for p, n in ((64, 64), (4, 4), (96, 32), (64, 128))] == [
        "tc", "tc", "simt", "simt"]
    gen = torch.Generator(device=cuda).manual_seed(12)
    for P, N, kind in ((32, 16, "tc"), (96, 32, "simt")):
        x, log_a, bm, cm = _ssd_inputs(gen, 1, 100, 2, P, N, torch.float32, torch.float32, cuda)
        _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)
        before = getattr(ssd_scan_backward, f"launches_{kind}")
        ssd_scan_backward(x, log_a, bm, cm, x, None, states)
        torch.cuda.synchronize()
        assert getattr(ssd_scan_backward, f"launches_{kind}") == before + 1


#: ``benchmarks/port_kernel_ab.py::ssd_forward_digests`` of the forward
#: kernel built from the tree before its fragment helpers moved into
#: ``csrc/mma_split.cuh`` (commit fac83b4), on an H100 with CUDA 12.8:
#: (y, final state) a case of its DIGEST_CASES. Pinned to that toolchain
#: and that forward: re-pin them (from ``port_kernel_ab.py``'s output on
#: the new tree, once ``test_ssd_scan_kernel_matches_plain`` passes there)
#: whenever nvcc or the forward kernel changes.
FWD_GOLDEN = [
    ["23f8be10d88353ce", "4074ddf87a4f53ac"],
    ["e30ce754f3069dcf", "122d22b2ad07686d"],
    ["82b417b237e922c7", "f46c4875eeb85838"],
    ["4596d67857927f1d", "2c199ef3470305f8"],
]


def test_ssd_forward_bits_match_the_tree_before_the_shared_header(cuda):
    """The forward's y and final state, bit for bit, are those the kernel
    gave before its TF32 fragment helpers became a header shared with the
    backward (inputs drawn with numpy, so the same bits on every machine).
    A check of that refactor only: a new nvcc or a changed forward kernel
    gives other bits, and then FWD_GOLDEN is re-pinned as its comment says;
    the forward's values are held against the plain version by
    ``test_ssd_scan_kernel_matches_plain``."""
    from benchmarks.port_kernel_ab import ssd_forward_digests

    assert ssd_forward_digests(ssd_scan, cuda) == FWD_GOLDEN


def test_ssd_autograd_in_model_layout(cuda):
    """``ops.ssd_scan`` under autograd on the card (the fold by autograd,
    the scan through ``SSDScan``: one forward with the chunk states and one
    backward launch), against autograd through the plain scan."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, L, H, P, N = 2, 200, 8, 64, 64
    x = _randn(gen, (B, L, H, P), torch.float32, cuda).requires_grad_()
    dt = (torch.rand((B, L, H), generator=gen, device=cuda) * 0.19 + 0.01).requires_grad_()
    a = (-(torch.rand((H,), generator=gen, device=cuda) * 1.5 + 0.5)).requires_grad_()
    bm = _randn(gen, (B, L, N), torch.bfloat16, cuda).requires_grad_()
    cm = _randn(gen, (B, L, N), torch.bfloat16, cuda).requires_grad_()
    dy = _randn(gen, (B, L, H, P), torch.float32, cuda)
    ds = _randn(gen, (B, H, P, N), torch.float32, cuda)
    leaves = (x, dt, a, bm, cm)
    before = (ssd_scan.launches, ssd_scan_backward.launches)
    y, s = ops.ssd_scan(*leaves)
    grads = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_backward.launches) == (before[0] + 1, before[1] + 1)
    dtf = dt.float()
    xh = (x * dtf[..., None]).transpose(1, 2)
    log_a = (a[None, None, :] * dtf).transpose(1, 2)
    yp, sp = ssd_scan_plain(xh, log_a, bm, cm)
    refs = torch.autograd.grad((yp.transpose(1, 2) * dy).sum() + (sp * ds).sum(), leaves)
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC"), grads, refs):
        _hold_ssd_grad(g, r, name)


def test_ssd_backward_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, log_a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 16, 260, torch.float32, torch.float32, cuda)
    _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)
    with pytest.raises(ValueError, match="N <= 256"):
        ssd_scan_backward(x, log_a, bm, cm, x, None, states)
    x, log_a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 16, 8, torch.float32, torch.float32, cuda)
    _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)
    with pytest.raises(ValueError, match="states"):
        ssd_scan_backward(x, log_a, bm, cm, x, None, states[:, :1])
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_backward(x, log_a, bm, cm, x[..., :8], None, states)


def test_ssd_scan_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, log_a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 16, 8, torch.float32, torch.float32, cuda)
    with pytest.raises(TypeError, match="log_a"):
        ssd_scan(x, log_a.double(), bm, cm)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_scan(x[..., :14].contiguous(), log_a, bm, cm)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x, log_a.cpu(), bm, cm)


def test_slot_decode_runs_the_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (4, 1, 8, 64), torch.bfloat16, cuda)
    kc = _randn(gen, (4, 64, 2, 64), torch.bfloat16, cuda)
    vc = _randn(gen, (4, 64, 2, 64), torch.bfloat16, cuda)
    lengths = torch.tensor([1, 17, 64, 200], dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    out = ops.slot_decode_attention(q, kc, vc, lengths)
    assert paged_attention.launches == before + 1
    bt = ops.slot_block_table(4, 64, cuda)
    expect = paged_attention_plain(q[:, 0], kc.view(16, 16, 2, 64), vc.view(16, 16, 2, 64), bt, lengths)
    torch.testing.assert_close(out[:, 0].float(), expect.float(), atol=2e-2, rtol=0)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q[:, :2].contiguous(), q[:, :2].contiguous())
    q = torch.zeros(1, 4, 64, 64, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q, causal=False)
    q = torch.zeros(2, 4, 64, device=cuda)
    pages = torch.zeros(4, 16, 2, 64, device=cuda, dtype=torch.int8)
    bt = torch.zeros(2, 2, device=cuda, dtype=torch.int32)
    lengths = torch.ones(2, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        paged_attention(q, pages, pages, bt, lengths)
    scales = torch.ones(4, 16, 2, 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="scales"):
        paged_attention(q, pages, pages, bt, lengths, scales, scales)


# The backward kernel against its plain version: both accumulate in f32;
# the f32 cases differ by summation order (held relative to the largest
# gradient), the bf16 ones also by which bf16 value a result rounds to
# (2e-2 and 2 bf16 ulps of each row's largest value, as the forward rows).
FLASH_BWD_CASES = [
    # (B, Lq, Lk, H, K, D, causal, dtype)
    (2, 256, 256, 8, 2, 64, True, torch.float32),
    (1, 200, 200, 6, 2, 64, True, torch.float32),  # ragged length
    (2, 130, 300, 8, 2, 128, False, torch.float32),  # Lq != Lk
    (1, 1, 1, 4, 1, 32, True, torch.float32),
    (1, 100, 100, 4, 4, 256, True, torch.float32),
    (2, 256, 256, 32, 4, 128, True, torch.bfloat16),  # yi-6b heads
    (1, 65, 65, 16, 1, 128, True, torch.bfloat16),  # G = 16
    (1, 130, 130, 32, 32, 80, True, torch.bfloat16),  # zamba2's D 80
    (2, 200, 256, 24, 24, 64, False, torch.bfloat16),  # musicgen's cross
    (1, 63, 63, 28, 4, 128, True, torch.bfloat16),  # G = 7
    (1, 70, 70, 4, 2, 32, True, torch.bfloat16),
    (1, 64, 64, 4, 4, 256, False, torch.bfloat16),
    # the tensor-core variant at lengths ragged against its 64-row tiles and
    # 32-row steps, one row, MQA, and the training phase's yi-6b heads
    (2, 1, 1, 8, 2, 64, True, torch.bfloat16),
    (1, 33, 33, 8, 1, 128, True, torch.bfloat16),
    (2, 97, 97, 6, 3, 80, True, torch.bfloat16),
    (1, 31, 70, 4, 2, 128, False, torch.bfloat16),
    (1, 1024, 1024, 32, 4, 128, True, torch.bfloat16),
    # the wgmma variant's grid and ring: G 48 on one kv head (granite-34b,
    # split 8), G 5 in uneven head groups (llama4-scout; split 3 on 132
    # SMs), qwen3's G 16, L 1000 ragged against the 64/128-row tiles and
    # the ring's stages (G 7, split 4), non-causal Lq 130 x Lk 300 at D 80
    (1, 512, 512, 48, 1, 128, True, torch.bfloat16),
    (2, 300, 300, 40, 8, 128, True, torch.bfloat16),
    (1, 1024, 1024, 64, 4, 128, True, torch.bfloat16),
    (2, 1000, 1000, 28, 4, 128, True, torch.bfloat16),
    (1, 130, 300, 8, 2, 80, False, torch.bfloat16),
]


def _bwd_inputs(gen, case, device):
    B, Lq, Lk, H, K, D, causal, dtype = case
    q = _randn(gen, (B, H, Lq, D), dtype, device)
    k = _randn(gen, (B, K, Lk, D), dtype, device)
    v = _randn(gen, (B, K, Lk, D), dtype, device)
    do = _randn(gen, (B, H, Lq, D), dtype, device)
    return q, k, v, do


def _hold_grad(out, ref, dtype, what):
    """f32: relative to the largest gradient. bf16: 2 bf16 ulps a row and
    the forward's 2e-2, which is 1.28 ulps of values in [2, 4); gradients
    summed over a kv head's G heads reach past 4 (dv of yi-6b's key 0 sums 8
    heads' probabilities), so for a largest value in [2**e, 2**(e+1)), e >=
    2, the absolute limit doubles with each e past 1: 1.28 ulps at the
    tensor's largest value. A row's scale is floored at 2**-8 of that
    value: a gradient row can cancel to ~0 (causal query 0's dq is exactly
    0: dP and delta are one product in two summation orders), and then
    carries the f32 rounding of the terms it cancels, not of its own size;
    for these unit-scale inputs the floor is at least 2**-10 (at L = 1 every
    dq is such a residue)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    big = ref.abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5 * max(1.0, big), f"{what}: {err.max().item()}, max {big}"
        return
    top = ref.abs().amax(-1).clamp_min(max(big * 2.0**-8, 2.0**-10))
    ulps = (err.amax(-1) / torch.exp2(torch.floor(torch.log2(top)) - 7)).max().item()
    limit = 2e-2 * 2.0 ** max(0, math.floor(math.log2(big)) - 1)
    assert err.max().item() <= limit and ulps <= 2, (
        f"{what}: max err {err.max().item()} (limit {limit}, largest |ref| {big}), "
        f"worst row {ulps} bf16 ulps (limit 2)")


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_lse_matches_plain(cuda, case):
    """The forward kernel's log-sum-exp (both variants) against the plain
    version's; the output is the same with and without it."""
    B, Lq, Lk, H, K, D, causal, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, _ = _bwd_inputs(gen, case, cuda)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Lq) and lse.dtype == torch.float32
    _, lse_ref = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, case):
    """dq, dk and dv against the plain backward from the same lse; two
    launches give the same bits; each call counts one launch, on the
    tensor-core variant for bf16 at head dims 64, 80 and 128."""
    B, Lq, Lk, H, K, D, causal, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = _bwd_inputs(gen, case, cuda)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    kind = backward_variant(D, dtype)
    assert kind == ("tc" if dtype == torch.bfloat16 and D in (64, 80, 128) else "simt")
    counter = f"launches_{kind}"
    before = (flash_attention_backward.launches, getattr(flash_attention_backward, counter))
    grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    again = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before[0] + 2
    assert getattr(flash_attention_backward, counter) == before[1] + 2
    refs = flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal)
    for name, g, g2, ref, x in zip("qkv", grads, again, refs, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.equal(g, g2), f"d{name} differs between two launches"
        _hold_grad(g, ref, dtype, f"d{name}")


def test_flash_backward_schedule_on_the_card(cuda):
    """The card's SM count gives the shapes above the head splits their
    comments name: uneven groups at G 5 and 7, eight groups at G 16 and 48."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for (B, L, H, K), want in (((2, 300, 40, 8), 3), ((2, 1000, 28, 4), 4),
                               ((1, 1024, 64, 4), 8), ((1, 512, 48, 1), 8)):
        split = backward_schedule(B, H, K, L, L, True, n_sm).split
        if n_sm == 132:  # an H100 SXM
            assert split == want, (B, L, H, K, split)
        assert 1 <= split <= min(H // K, 8)


def test_flash_autograd_in_model_layout(cuda):
    """``ops.flash_attention`` under autograd: the model's (B, L, H, D)
    layout, strided views into the kernels, gradients against autograd
    through the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, L, H, K, D = 2, 150, 8, 2, 64
    leaves = [_randn(gen, (B, L, n, D), torch.float32, cuda).requires_grad_()
              for n in (H, K, K)]
    do = _randn(gen, (B, L, H, D), torch.float32, cuda)
    before = flash_attention_backward.launches
    out = ops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention_backward.launches == before + 1
    heads = [t.detach().transpose(1, 2).requires_grad_() for t in leaves]
    ref = flash_attention_plain(*heads, causal=True)
    refs = torch.autograd.grad(ref, heads, do.transpose(1, 2))
    for g, r in zip(grads, refs):
        _hold_grad(g, r.transpose(1, 2), torch.float32, "grad")
    assert out.grad_fn is not None


def test_flash_autograd_in_model_layout_bf16(cuda):
    """The bf16 twin at D 128: ``ops.flash_attention`` under autograd hands
    strided (B, L, H, D) views of q, k, v and dO to the tensor-core
    backward's TMA maps; the gradients are held against the plain backward
    from the same forward output and lse, as the kernel rows are."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    B, L, H, K, D = 2, 300, 8, 2, 128
    dt = torch.bfloat16
    leaves = [_randn(gen, (B, L, n, D), dt, cuda).requires_grad_() for n in (H, K, K)]
    do = _randn(gen, (B, L, H, D), dt, cuda)
    before = (flash_attention_backward.launches, flash_attention_backward.launches_tc)
    out = ops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention_backward.launches, flash_attention_backward.launches_tc) == (
        before[0] + 1, before[1] + 1)
    heads = [t.detach().transpose(1, 2) for t in leaves]
    o, lse = flash_attention(*heads, causal=True, return_lse=True)
    refs = flash_attention_backward_plain(*heads, o, lse, do.transpose(1, 2), causal=True)
    for name, g, r in zip("qkv", grads, refs):
        assert g.shape == (B, L, H if name == "q" else K, D) and g.dtype == dt
        _hold_grad(g.transpose(1, 2), r, dt, f"d{name}")


def test_kernels_without_backward_refuse_grad(cuda):
    """Paged decode has no backward kernel: under grad it raises instead of
    returning an output with no gradient; under no_grad it runs. (The SSD
    scan has one: ``test_ssd_autograd_in_model_layout``.)"""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(gen, (2, 8, 64), torch.bfloat16, cuda).requires_grad_()
    pages = _randn(gen, (4, 16, 2, 64), torch.bfloat16, cuda)
    bt = torch.arange(4, dtype=torch.int32, device=cuda).view(2, 2)
    lengths = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="paged_attention"):
        paged_attention(q, pages, pages, bt, lengths)
    with torch.no_grad():
        paged_attention(q, pages, pages, bt, lengths)


class _PlainSSD:
    @staticmethod
    def apply(x, log_a, b_mat, c_mat):
        return ssd_scan_plain(x, log_a, b_mat, c_mat)


class _PlainFlash:
    @staticmethod
    def apply(q, k, v, causal):
        return flash_attention_plain(q, k, v, causal=causal)


def test_hybrid_loss_gradients_on_the_card(cuda):
    """Reduced zamba2's ``Model.loss`` on the card, its parameters widened
    to f32 and w_q/w_k tempered by 0.1 as every comparison of the port
    tempers them: the loss and every gradient leaf through the SSD and
    flash kernels (one SSD backward a Mamba-2 block, one flash backward a
    shared attention invocation) against autograd through their plain
    versions, 1e-4 relative L2 a leaf (as ``chip_smoke.py`` holds the
    full-width model in f32; the worst leaf read 7.6e-6 on an H100); in
    bf16 every gradient is finite."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import Model

    cfg = get_config("zamba2-2.7b").reduced()
    model = Model(cfg)
    params = model.init(0, device=cuda)
    with torch.no_grad():  # the reference's init saturates attention (ROADMAP C)
        for key in ("w_q", "w_k"):
            params["shared"][key].mul_(0.1)
    tokens = torch.randint(0, cfg.vocab, (2, 200), device=cuda, dtype=torch.int32,
                           generator=torch.Generator(device=cuda).manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens}

    def widened(tree):
        return {k: widened(v) if isinstance(v, dict) else v.detach().float()
                for k, v in tree.items()}

    def value_and_grad(ps):
        leaves = _tree_leaves(ps)
        for t in leaves:
            t.requires_grad_()
        loss, _ = model.loss(ps, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _, grads16 = value_and_grad(params)
    assert all(torch.isfinite(g).all() for g in grads16)
    p32 = widened(params)
    before = (ssd_scan_backward.launches, flash_attention_backward.launches)
    loss, grads = value_and_grad(p32)
    torch.cuda.synchronize()
    groups = cfg.n_layers // cfg.attn_every
    assert (ssd_scan_backward.launches - before[0],
            flash_attention_backward.launches - before[1]) == (cfg.n_layers, groups)
    with mock.patch.object(ssd_mod, "SSDScan", _PlainSSD), \
            mock.patch.object(flash_mod, "FlashAttention", _PlainFlash):
        loss_p, grads_p = value_and_grad(p32)
    assert abs(loss.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    assert all(torch.isfinite(g).all() for g in grads)
    rel = [((g - r).norm() / r.norm().clamp_min(1e-30)).item() for g, r in zip(grads, grads_p)]
    print(f"[hybrid-card] worst leaf rel L2 {max(rel):.4g} of {len(rel)}")
    assert max(rel) <= 1e-4


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


SIM_DECODE_ARGS = ("t_limit", "busy", "now", "nact", "free", "occ", "pre", "sq", "inp",
                   "gen", "rem", "blk", "ft", "tr", "c_max")
SIM_DECODE_CASES = [
    # (c_max per pool, lanes, instances, slots, t_limit, timing (w, h),
    # offset, idle lane): with ``offset`` every operand is ``t[1:]`` of a
    # tensor with one lane more, a contiguous view whose storage offset
    # (P * I * S elements) is not 16-byte aligned; ``t_limit`` is one value
    # for every lane, a list of one a lane, or None for a different
    # default in each lane; an idle lane has no busy row
    ([8192, 65_536], 1, 224, 128, None, (8.0e-3, 0.65e-3), False, None),  # Table-2 fleet shapes
    ([8192, 65_536], 1, 224, 128, math.inf, (8.0e-3, 0.65e-3), False, None),
    ([1024, 2048, 4096], 1, 6, 16, None, (2**-10, 2**-13), False, None),
    ([2048], 1, 5, 200, None, (8.0e-3, 0.65e-3), False, None),  # more slots than a warp holds
    ([4096], 1, 3, 8, math.inf, (2**-10, 2**-13), False, None),
    # S = 1, 6 (a vector-less tail), 33 and 129 (past one warp's 128);
    # 7 and 9 rows, which 4 rows a CTA do not divide
    ([8192, 65_536], 1, 7, 1, None, (8.0e-3, 0.65e-3), False, None),
    ([2048, 4096], 1, 5, 6, None, (2**-10, 2**-13), False, None),
    ([1024, 2048, 4096], 1, 3, 33, None, (8.0e-3, 0.65e-3), False, None),
    ([2048], 1, 9, 129, math.inf, (8.0e-3, 0.65e-3), False, None),
    ([8192, 65_536], 1, 13, 17, None, (8.0e-3, 0.65e-3), True, None),
    ([4096], 1, 3, 33, None, (2**-10, 2**-13), True, None),
    # grid lanes: G = 3 and 16, each lane its own time limit, one at +inf,
    # one lane idle; the 16-lane Table-2 shape of the grid's sweep
    ([8192, 65_536], 16, 224, 128, [1.5 + 0.1 * g for g in range(15)] + [math.inf],
     (8.0e-3, 0.65e-3), False, 3),
    ([2048, 4096], 3, 5, 1, [2.0, math.inf, 1.2], (8.0e-3, 0.65e-3), False, 0),
    ([1024, 2048, 4096], 3, 3, 33, None, (2**-10, 2**-13), False, 2),
    ([2048], 16, 9, 129, None, (8.0e-3, 0.65e-3), False, 15),
    ([1024, 4096], 3, 7, 33, [math.inf, 1.0, 2.2], (8.0e-3, 0.65e-3), True, 1),
]


@pytest.mark.parametrize("case", SIM_DECODE_CASES)
def test_sim_decode_kernel_bit_identical_to_plain(cuda, case):
    """Every output equal bit for bit (float64 compared as bits, so NaN
    first-token times count)."""
    c_max, lanes, n_inst, n_slots, t_limit, (w, h), offset, idle = case
    if offset:
        tl = [0.0] + t_limit if isinstance(t_limit, list) else t_limit
        st = random_state(11, c_max, n_inst, n_slots, t_limit=tl, lanes=lanes + 1, device=cuda)
        st = {k: v if k == "c_max" else v[1:] for k, v in st.items()}
        assert st["pre"].is_contiguous()
        assert st["pre"].data_ptr() % 16 != 0 and st["occ"].data_ptr() % 4 != 0
    else:
        st = random_state(11, c_max, n_inst, n_slots, t_limit=t_limit, lanes=lanes, device=cuda)
    if idle is not None:
        st["busy"][idle] = False
        st["now"][idle] = 0.0
    assert st["occ"].shape == (lanes, len(c_max), n_inst, n_slots)
    args = [st[k] for k in SIM_DECODE_ARGS]
    before = decode_advance.launches
    got = decode_advance(*args, w=w, h=h, chunk=512)
    torch.cuda.synchronize()
    assert decode_advance.launches == before + 1
    want = decode_advance_plain(*args, w=w, h=h, chunk=512)
    for k in OUTPUTS:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        assert torch.equal(a, b), k
    if idle is not None:
        assert not want["comp"][idle].any() and not want["trunc_new"][idle].any()


def test_sim_decode_reads_nothing_past_its_operands(cuda):
    """Every operand of ``sim_decode`` ends where its device mapping ends
    (``tests/guarded_memory.py``), at slot counts where the lane after a
    row's last slot starts at the row's end, and the outputs equal the plain
    version's. Run in a subprocess: a read past an operand faults, which
    would end this session's CUDA context. Before the fix of ROADMAP C's R3
    that lane read 16 bytes past the last row here."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    path = os.pathsep.join(p for p in (str(here.parent / "src"), os.environ.get("PYTHONPATH"))
                           if p)
    proc = subprocess.run([sys.executable, str(here / "guarded_memory.py")],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=path))
    assert proc.returncode == 0 and proc.stdout.split()[-1:] == ["ok"], (
        proc.stdout[-2000:] + proc.stderr[-2000:])


def test_sim_decode_refuses_what_it_does_not_take(cuda):
    st = random_state(3, [2048], 2, 8, lanes=2, device=cuda)
    args = [st[k] for k in SIM_DECODE_ARGS]
    kw = dict(w=2**-10, h=2**-13, chunk=512)
    bad = list(args)
    bad[SIM_DECODE_ARGS.index("now")] = args[SIM_DECODE_ARGS.index("now")].float()
    with pytest.raises(TypeError, match="now"):
        decode_advance(*bad, **kw)
    bad = list(args)
    bad[0] = args[0].cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        decode_advance(*bad, **kw)
    bad = list(args)
    bad[-1] = torch.tensor([2048, 4096], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="pools"):
        decode_advance(*bad, **kw)
    bad = list(args)
    bad[0] = args[0][:1]  # one time limit for two lanes
    with pytest.raises(TypeError, match="one time limit a lane"):
        decode_advance(*bad, **kw)
    one = [a if i == len(args) - 1 else a[0] for i, a in enumerate(args)]  # no lane axis
    with pytest.raises(ValueError, match=r"\(G, P, I, S\)"):
        decode_advance(*one, **kw)


def _des_case(name):
    """(pools, timing, trace, total_blocks) of a small fleet: the routed
    two-pool Azure fleet, or one pool under KV pressure (tiny block budget:
    preemptions, the victim stash and truncation)."""
    import numpy as np

    from repro_torch.core.pools import PoolConfig, n_seq_for_cmax
    from repro_torch.core.router import Request
    from repro_torch.sim import A100_LLAMA3_70B, TimingModel
    from repro_torch.traces import TraceSpec, generate_trace_columns

    if name == "routed":
        cols = generate_trace_columns(TraceSpec(trace="azure", num_requests=400, rate=400.0, seed=5))
        pools = {
            "short": (PoolConfig("short", 8192, n_seq_for_cmax(8192), headroom=1.05), 6),
            "long": (PoolConfig("long", 65_536, 16, headroom=1.02), 12),
        }
        return pools, A100_LLAMA3_70B, cols, None
    rng = np.random.default_rng(3)
    arrivals = np.cumsum(rng.exponential(1.0 / 400.0, 300))
    trace = [
        Request(request_id=i, byte_len=int(rng.integers(4, 12_000)),
                max_output_tokens=int(rng.integers(1, 400)), category=int(rng.integers(0, 4)),
                arrival_time=float(arrivals[i]), true_input_tokens=int(rng.integers(16, 900)),
                true_output_tokens=int(rng.integers(1, 400)))
        for i in range(300)
    ]
    timing = TimingModel("dyadic", w_base=2**-10, h_per_seq=2**-13, prefill_chunk=512)
    return {"p": (PoolConfig("p", 1024, 8), 3)}, timing, trace, 90


@pytest.mark.parametrize("case", ["routed", "kv_pressure"])
def test_torch_tier_on_the_card_equals_the_cpu(cuda, case):
    """A fleet through ``backend="torch"``: the card's run launches the
    kernel and gives the CPU run's records, counters and loop counts."""
    from repro_torch.sim import FleetSim, torch_engine

    pools, timing, trace, total_blocks = _des_case(case)
    runs = {}
    for dev in ("cuda", "cpu"):
        before = decode_advance.launches
        sim = FleetSim(pools, timing, backend="torch", device=dev, spillover=False,
                       coalesce_dt=0.0)
        if total_blocks is not None:
            for pool in sim.pools.values():
                pool.total_blocks = total_blocks
                pool.blocks_free[:] = total_blocks
        res = sim.run(trace)
        runs[dev] = (sim, res, torch_engine.last_run_stats(), decode_advance.launches - before)
    (gs, gr, gst, gl), (cs, cr, cst, cl) = runs["cuda"], runs["cpu"]
    assert gl > 0 and cl == 0
    assert (gst["iters"], gst["rounds"]) == (cst["iters"], cst["rounds"])
    assert (gr.preemptions, gr.rejections, gr.truncations) == (
        cr.preemptions, cr.rejections, cr.truncations
    )
    if case == "kv_pressure":
        assert gr.preemptions > 0 and gr.truncations > 0
    for name in gs.pools:
        a, b = gs.pools[name].record_arrays(), cs.pools[name].record_arrays()
        for col in a:
            assert a[col].dtype == b[col].dtype, col
            assert a[col].tobytes() == b[col].tobytes(), (name, col)


def test_grid_on_the_card_equals_the_cpu(cuda):
    """``run_fleet_grid`` over three threshold lanes and two instance
    vectors: the card's run launches the kernel once a round for all lanes
    and gives the CPU run's records, metrics and loop counts."""
    import numpy as np

    from repro_torch.sim import A100_LLAMA3_70B, run_fleet_grid, torch_engine

    pools, _, trace, _ = _des_case("routed")
    kw = dict(thresholds=[[2048], [4096], [8192]], instances=[[6, 12], [3, 12], [6, 8]],
              return_records=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        before = decode_advance.launches
        grid = run_fleet_grid(trace, pools, A100_LLAMA3_70B, device=dev, **kw)
        runs[dev] = (grid, torch_engine.last_run_stats(), decode_advance.launches - before)
    (gg, gst, gl), (cg, cst, cl) = runs["cuda"], runs["cpu"]
    assert gl == gst["rounds"] and cl == 0
    for key in ("iters", "rounds", "iters_total", "rounds_total", "host_syncs"):
        assert gst[key] == cst[key], key
    for k, v in cg.records.items():
        assert gg.records[k].dtype == v.dtype and gg.records[k].tobytes() == v.tobytes(), k
    for f in ("completed", "rejected", "truncated", "preemptions", "routed", "controller_moves"):
        assert np.array_equal(getattr(gg, f), getattr(cg, f)), f


# ---------------------------------------------------------------------------
# The dry run's memory count: each wrapper's meta branch allocates what its
# launch allocates on the card, byte for byte
# ---------------------------------------------------------------------------


def _meta_like(t):
    """A meta tensor of ``t``'s shape, strides and dtype (offset 0)."""
    if t is None or not isinstance(t, torch.Tensor):
        return t
    return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device="meta")


def _plug_free_large_blocks(device) -> list:
    """Tensors that fill every free block the caching allocator keeps in a
    partly used large segment (``empty_cache`` releases only whole free
    segments). A request that lands in such a block with less than 1 MiB
    to spare takes the whole block, which depends on what ran before; with
    them filled, each request of the measured call takes a fresh segment,
    as ``block_bytes`` counts it."""
    plugs = []
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != device.index or seg["segment_type"] != "large":
            continue
        for block in seg["blocks"]:
            if block["state"] == "inactive":
                plugs.append(torch.empty(block["size"], dtype=torch.uint8, device=device))
    return plugs


def _card_and_meta_bytes(fn, *args, **kwargs):
    """(the allocator's most above what it held before one call of ``fn``
    on the card, ``MemCounter``'s peak for the same call on meta tensors).
    Each side is called once first: the library builds, and the flash
    backward's work list is copied to the device once a shape."""
    from repro_torch.launch.mem_count import MemCounter

    meta_args = [_meta_like(a) for a in args]
    fn(*args, **kwargs)
    fn(*meta_args, **kwargs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    plugs = _plug_free_large_blocks(torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - before
    del out, plugs
    with MemCounter() as mem:
        fn(*meta_args, **kwargs)
    return card, mem.peak_bytes


MEM_FLASH_CASES = [
    # (B, L, H, K, D, dtype): the tensor-core and the CUDA-core variants
    (2, 2048, 32, 4, 128, torch.bfloat16),  # yi-6b's training shape
    (1, 200, 32, 32, 80, torch.bfloat16),
    (2, 256, 8, 2, 64, torch.float32),
    (1, 70, 4, 2, 32, torch.bfloat16),
]


@pytest.mark.parametrize("case", MEM_FLASH_CASES)
@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_meta_allocations_match_the_card(cuda, case, return_lse):
    B, L, H, K, D, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(21)
    q = _randn(gen, (B, L, H, D), dtype, cuda).transpose(1, 2)  # the model's layout
    k, v = (_randn(gen, (B, L, K, D), dtype, cuda).transpose(1, 2) for _ in range(2))
    card, meta = _card_and_meta_bytes(flash_attention, q, k, v, causal=True,
                                      return_lse=return_lse)
    assert card == meta > 0


@pytest.mark.parametrize("case", MEM_FLASH_CASES)
def test_flash_backward_meta_allocations_match_the_card(cuda, case):
    """dq, dk, dv, delta and, for the tensor-core variant, the variant by
    the meta branch's rule (``backward_kind``) equal to the C entry
    point's."""
    from repro_torch.kernels.flash_attention import backward_kind

    B, L, H, K, D, dtype = case
    assert backward_kind(D, dtype) == backward_variant(D, dtype)
    gen = torch.Generator(device=cuda).manual_seed(22)
    q, k, v, do = _bwd_inputs(gen, (B, L, L, H, K, D, True, dtype), cuda)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    card, meta = _card_and_meta_bytes(flash_attention_backward, q, k, v, o, lse, do, causal=True)
    assert card == meta > 0


def test_flash_backward_kind_is_the_c_entry_points(cuda):
    from repro_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS, backward_kind

    for d in SUPPORTED_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert backward_kind(d, dtype) == backward_variant(d, dtype), (d, dtype)


@pytest.mark.parametrize("kdt", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("return_lse", [False, True])
def test_paged_meta_allocations_match_the_card(cuda, kdt, return_lse):
    B, H, K, D = 8, 32, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(23)
    q = _randn(gen, (B, H, D), torch.bfloat16, cuda)
    cache = _slot_cache(gen, B, 512, K, D, kdt, cuda)
    pages = [t.view(-1, ops.PAGE, K, t.shape[-1]) for t in cache]
    bt = ops.slot_block_table(B, 512, cuda)
    lengths = torch.full((B,), 300, dtype=torch.int32, device=cuda)
    card, meta = _card_and_meta_bytes(paged_attention, q, *pages[:2], bt, lengths, *pages[2:],
                                      return_lse=return_lse)
    assert card == meta > 0


@pytest.mark.parametrize("return_states", [False, True])
def test_ssd_forward_meta_allocations_match_the_card(cuda, return_states):
    gen = torch.Generator(device=cuda).manual_seed(24)
    x, log_a, bm, cm = _ssd_inputs(gen, 2, 2048, 80, 64, 64, torch.bfloat16, torch.bfloat16, cuda)
    card, meta = _card_and_meta_bytes(ssd_scan, x, log_a, bm, cm, return_states=return_states)
    assert card == meta > 0


@pytest.mark.parametrize("case", [
    (2, 2048, 80, 64, 64, torch.bfloat16, torch.bfloat16),  # zamba2's training shape
    (2, 2048, 13, 64, 64, torch.float32, torch.bfloat16),  # a group that does not divide H
    (1, 100, 2, 96, 32, torch.float32, torch.float32),  # the CUDA-core chunk kernel
])
def test_ssd_backward_meta_allocations_match_the_card(cuda, case):
    """The f32 copies, dx, dlog_a, the dB/dC partials, dB, dC, the dS
    scratch and dx's cast: the meta branch plans its head groups for an
    H100's 132 SMs, as the card does."""
    B, L, H, P, N, xdt, bcdt = case
    if torch.cuda.get_device_properties(cuda).multi_processor_count != ssd_mod.H100_SMS:
        pytest.skip("the meta branch plans for an H100's SMs")
    gen = torch.Generator(device=cuda).manual_seed(25)
    x, log_a, bm, cm = _ssd_inputs(gen, B, L, H, P, N, xdt, bcdt, cuda)
    _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)
    dy = _randn(gen, x.shape, xdt, cuda)
    ds_final = torch.randn((B, H, P, N), generator=gen, device=cuda)
    card, meta = _card_and_meta_bytes(ssd_scan_backward, x, log_a, bm, cm, dy, ds_final, states)
    assert card == meta > 0
