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
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402

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
    """Head-major operands against the plain version; the same data in the
    model's (B, L, H, D) layout (strided views, no copy) gives the same bits;
    bf16 at head dims 64, 80 and 128 counts on the tensor-core variant."""
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
    if lens in ([1, 70], [1, 16, 64, 65, 128]):  # some CTAs hold an empty share
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


def test_kernels_without_backward_refuse_grad(cuda):
    """The SSD scan and paged decode have no backward kernel: under grad
    they raise instead of returning outputs with no gradient; under
    no_grad they run."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, log_a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 16, 8, torch.float32, torch.float32, cuda)
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="SSD scan's backward"):
        ssd_scan(x, log_a, bm, cm)
    with torch.no_grad():
        ssd_scan(x, log_a, bm, cm)
    q = _randn(gen, (2, 8, 64), torch.bfloat16, cuda).requires_grad_()
    pages = _randn(gen, (4, 16, 2, 64), torch.bfloat16, cuda)
    bt = torch.arange(4, dtype=torch.int32, device=cuda).view(2, 2)
    lengths = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="paged_attention"):
        paged_attention(q, pages, pages, bt, lengths)
    with torch.no_grad():
        paged_attention(q, pages, pages, bt, lengths)


def test_hybrid_loss_raises_on_the_card(cuda):
    """``Model(zamba2).loss`` on the card raises, naming the SSD scan's
    missing backward kernel, until that kernel lands."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("zamba2-2.7b").reduced()
    model = Model(cfg)
    params = model.init(0, device=cuda)
    for t in _tree_leaves(params):
        t.requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (1, 64), device=cuda, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="SSD scan's backward"):
        model.loss(params, {"tokens": tokens, "labels": tokens})


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
