"""The flash attention's gradient on the CPU: the port's plain backward
(``flash_attention_backward_plain``, the formula the backward kernel runs)
and its ``torch.autograd.Function`` against ``jax.grad`` of the reference's
jnp attention (``repro.models.layers.flash_attention``), which is what the
reference differentiates in training.

Inputs are drawn with numpy from a seed and go through both packages in
f32. Tolerance 1e-5 relative L2 a gradient: both sum f32 products in
different orders (the reference online over 512-key chunks, the port over
the dense score matrix).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    backward_schedule,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_plain,
)

REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small eager ops. The test run's other workers
    share the cores, and intra-op threads contending for them slowed a
    40-step run 100x (8 s alone, 791 s beside five busy workers); one
    thread keeps it near its time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = [
    # (B, Lq, Lk, H, K, D, causal): G = H / K of 1, 4 and 7
    (2, 48, 48, 4, 4, 64, True),
    (1, 64, 64, 8, 2, 128, True),
    (2, 40, 40, 7, 1, 80, True),
    (1, 32, 56, 4, 1, 64, False),  # Lq != Lk: cross-attention
    (2, 50, 24, 8, 2, 80, False),
    (1, 24, 40, 14, 2, 128, False),
]
IDS = [f"G{c[3] // c[4]}-D{c[5]}-{'causal' if c[6] else f'{c[1]}x{c[2]}'}" for c in CASES]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def inputs(case, seed=0):
    """q, k, v and dO in the model layout (B, L, heads, D), f32."""
    B, Lq, Lk, H, K, D, _ = case
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return draw(B, Lq, H, D), draw(B, Lk, K, D), draw(B, Lk, K, D), draw(B, Lq, H, D)


def reference_grads(case, q, k, v, do):
    causal = case[6]

    def objective(q, k, v):
        out = jlayers.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out * do)

    return [np.asarray(g) for g in jax.grad(objective, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_grad(case):
    """The plain backward, from the plain forward's output and lse, against
    jax.grad of the reference's attention."""
    q, k, v, do = inputs(case)
    ref = reference_grads(case, q, k, v, do)
    heads = [torch.from_numpy(t).transpose(1, 2) for t in (q, k, v, do)]
    out, lse = flash_attention_plain(*heads[:3], causal=case[6], return_lse=True)
    grads = flash_attention_backward_plain(*heads[:3], out, lse, heads[3], causal=case[6])
    for name, g, r in zip("qkv", grads, ref):
        assert g.dtype == torch.float32
        assert rel_l2(g.transpose(1, 2).numpy(), r) <= REL_TOL, name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_in_model_layout_matches_jax_grad(case):
    """``ops.flash_attention`` under autograd (the training path's call, in
    the model layout) goes through ``FlashAttention``; on the CPU it runs the
    plain versions, which count no launch."""
    q, k, v, do = inputs(case, seed=1)
    ref = reference_grads(case, q, k, v, do)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_backward.launches)
    out = ops.flash_attention(*leaves, causal=case[6])
    assert out.shape == q.shape and out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert (flash_attention.launches, flash_attention_backward.launches) == before
    for name, g, r in zip("qkv", grads, ref):
        assert rel_l2(g.numpy(), r) <= REL_TOL, name
    with torch.no_grad():  # no graph, no Function: the plain forward alone
        assert ops.flash_attention(*leaves, causal=case[6]).grad_fn is None


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_lse_is_the_rows_logsumexp(case):
    """``return_lse`` gives each row's log-sum-exp of its scaled, masked
    scores (numpy in f64), (B, H, Lq) f32; the output is the one without."""
    B, Lq, Lk, H, K, D, causal = case
    q, k, v, _ = inputs(case, seed=2)
    heads = [torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)]
    out, lse = flash_attention_plain(*heads, causal=causal, return_lse=True)
    assert lse.shape == (B, H, Lq) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention_plain(*heads, causal=causal))
    kg = np.repeat(k.astype(np.float64), H // K, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kg) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((Lq, Lk), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    expect = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), expect, atol=1e-5, rtol=0)


def test_bf16_gradients_keep_their_dtypes():
    """bf16 operands: the Function's gradients come back in bf16 (f32
    accumulation inside), within 4 bf16 ulps, at each gradient's largest
    value, of the f32 computation on the same bf16 values (the bf16 path
    also rounds the forward's output before delta = rowsum(dO * O))."""
    q, k, v, do = inputs(CASES[1], seed=3)
    b16 = [torch.from_numpy(t).transpose(1, 2).bfloat16().requires_grad_() for t in (q, k, v)]
    dob = torch.from_numpy(do).transpose(1, 2).bfloat16()
    f32 = [t.detach().float().requires_grad_() for t in b16]
    ref = torch.autograd.grad(FlashAttention.apply(*f32, True), f32, dob.float())
    got = torch.autograd.grad(FlashAttention.apply(*b16, True), b16, dob)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        top = r.abs().max().item()
        torch.testing.assert_close(g.float(), r, atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7),
                                   rtol=0)


# The tensor-core backward's dK/dV work list (``backward_schedule``): batch
# 1 or 2, G = H / K of 1, 5, 7, 8, 16 and 48, causal at L 1000 (ragged
# against the 64- and 128-row tiles) or full attention of 300 queries
# against 1000 keys, on an H100's 132 SMs.
SCHEDULE_CASES = [(B, G, causal) for B in (1, 2) for G in (1, 5, 7, 8, 16, 48)
                  for causal in (True, False)]


@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[f"B{b}-G{g}-{'causal' if c else 'full'}" for b, g, c in SCHEDULE_CASES])
def test_backward_schedule_covers_every_item_once(case):
    """Every (batch, kv head, key tile, head group) appears exactly once; a
    key tile's groups are consecutive in group order (one cluster, rank =
    group) and cover its kv head's G heads, with sizes differing by at most
    one; causal items come longest first; the same arguments give the same
    list; the device copy is what the kernel reads."""
    B, G, causal = case
    K = 1 if G == 48 else 2
    H, Lk = G * K, 1000
    Lq = Lk if causal else 300
    sched = backward_schedule(B, H, K, Lq, Lk, causal, 132)
    split, items = sched.split, sched.items
    n_kt, n_qt = -(-Lk // 128), -(-Lq // 64)
    assert 1 <= split <= min(G, 8) and len(items) % split == 0
    keys = [(b, kvh, kt, lo, hi) for b, kvh, kt, lo, hi in items]
    assert len(set(keys)) == len(keys) == B * K * n_kt * split
    units = set()
    for i in range(0, len(items), split):
        cluster = items[i:i + split]
        b, kvh, kt = cluster[0][:3]
        assert all(it[:3] == (b, kvh, kt) for it in cluster)
        units.add((b, kvh, kt))
        bounds = [(lo, hi) for *_, lo, hi in cluster]
        assert bounds[0][0] == kvh * G and bounds[-1][1] == (kvh + 1) * G
        assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
        sizes = [hi - lo for lo, hi in bounds]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert units == {(b, kvh, kt) for b in range(B) for kvh in range(K) for kt in range(n_kt)}
    walked = [n_qt - 2 * it[2] if causal else n_qt for it in items]
    assert all(a >= b for a, b in zip(walked, walked[1:]))
    assert sched.dq_ctas == B * H * -(-Lq // 128)
    assert backward_schedule.__wrapped__(B, H, K, Lq, Lk, causal, 132) == sched
    work = flash_mod._work_list(sched, torch.device("cpu"))
    assert work.dtype == torch.int32 and work.tolist() == [list(it) for it in items]


def test_backward_schedule_fills_the_card():
    """The split follows the card: one SM gets one group a key tile; more
    SMs than key tiles split the heads, unevenly where the best count does
    not divide G (llama4-scout's G 5 at B 2, L 300 takes 3 groups on 132
    SMs, qwen3's G 16 at L 1024 takes 8)."""
    assert backward_schedule(2, 40, 8, 300, 300, True, 1).split == 1
    assert backward_schedule(2, 40, 8, 300, 300, True, 132).split == 3
    assert backward_schedule(1, 64, 4, 1024, 1024, True, 132).split == 8
    yi = backward_schedule(2, 32, 4, 2048, 2048, True, 132)
    assert yi.split == 2 and len(yi.items) == 256 and yi.dq_ctas == 1024
