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
    flash_attention,
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
    # plain version by summation order; bf16 y rounds an f32 result
    (1, 256, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),  # zamba2 prefill
    (1, 200, 80, 64, 64, torch.float32, torch.bfloat16, 1e-4, 1e-4),  # ragged tail
    (2, 1, 4, 32, 16, torch.float32, torch.float32, 1e-4, 1e-4),  # one step
    (2, 130, 3, 16, 8, torch.bfloat16, torch.bfloat16, 2e-2, 2**-7),
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


SIM_DECODE_ARGS = ("t_limit", "busy", "now", "nact", "free", "occ", "pre", "sq", "inp",
                   "gen", "rem", "blk", "ft", "tr", "c_max")
SIM_DECODE_CASES = [
    # (c_max per pool, instances, slots, t_limit, timing (w, h))
    ([8192, 65_536], 224, 128, None, (8.0e-3, 0.65e-3)),  # Table-2 fleet shapes
    ([8192, 65_536], 224, 128, math.inf, (8.0e-3, 0.65e-3)),
    ([1024, 2048, 4096], 6, 16, None, (2**-10, 2**-13)),
    ([2048], 5, 200, None, (8.0e-3, 0.65e-3)),  # more slots than threads
    ([4096], 3, 8, math.inf, (2**-10, 2**-13)),
]


@pytest.mark.parametrize("case", SIM_DECODE_CASES)
def test_sim_decode_kernel_bit_identical_to_plain(cuda, case):
    """Every output equal bit for bit (float64 compared as bits, so NaN
    first-token times count)."""
    c_max, n_inst, n_slots, t_limit, (w, h) = case
    st = random_state(11, c_max, n_inst, n_slots, t_limit=t_limit, device=cuda)
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


def test_sim_decode_refuses_what_it_does_not_take(cuda):
    st = random_state(3, [2048], 2, 8, device=cuda)
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
