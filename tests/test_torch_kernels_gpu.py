"""The port's Hopper kernels against their plain versions, on the card.

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
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
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
]

PAGED_CASES = [
    # (B, H, K, D, page, pages_per_seq, q dtype, page dtype, tol)
    (4, 8, 2, 64, 16, 8, torch.float32, torch.float32, 2e-5),
    (2, 8, 1, 128, 16, 4, torch.float32, torch.float32, 2e-5),  # MQA
    (3, 4, 4, 32, 32, 4, torch.float32, torch.bfloat16, 2e-5),
    (8, 32, 4, 128, 16, 32, torch.bfloat16, torch.bfloat16, 2e-2),  # yi-6b
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
    B, L, H, K, D, dtype, tol = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (B, H, L, D), dtype, cuda)
    k = _randn(gen, (B, K, L, D), dtype, cuda)
    v = _randn(gen, (B, K, L, D), dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    expect = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_and_skips_dead_pages(cuda, case):
    B, H, K, D, page, pps, qdt, kdt, tol = case
    gen = torch.Generator(device=cuda).manual_seed(1)
    total = B * pps * 2
    q = _randn(gen, (B, H, D), qdt, cuda)
    kp = _randn(gen, (total, page, K, D), kdt, cuda)
    vp = _randn(gen, (total, page, K, D), kdt, cuda)
    bt = torch.randperm(total, generator=gen, device=cuda)[: B * pps]
    bt = bt.view(B, pps).to(torch.int32).contiguous()
    lengths = torch.randint(1, pps * page + 1, (B,), generator=gen, device=cuda, dtype=torch.int32)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), paged_attention_plain(q, kp, vp, bt, lengths).float(), atol=tol, rtol=0
    )
    for b in range(B):  # poison every page past each length: never read
        dead = bt[b, math.ceil(int(lengths[b]) / page):].long()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
    assert torch.equal(paged_attention(q, kp, vp, bt, lengths), out)


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
