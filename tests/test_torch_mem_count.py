"""The dry run's peak memory: :class:`~repro_torch.launch.mem_count.MemCounter`
on hand-built sequences and a kernel-free training step (meta and CPU count
the same), the kernel wrappers' meta branches (each allocates exactly its
documented outputs and workspace, and runs no plain version), and the dry
run's ``memory_analysis`` and ``--causal-mode``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.configs import SHAPES_BY_NAME as REF_SHAPES  # noqa: E402
from repro.launch import analytic_cost as ref_cost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch.mem_count import (  # noqa: E402
    MemCounter,
    block_bytes,
    storage_bytes,
)
from repro_torch.training.optimizer import AdamW  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MB = 1 << 20


def nbytes(shape, dtype) -> int:
    return block_bytes(torch.empty(shape, dtype=dtype, device="meta").untyped_storage().nbytes())


# ---------------------------------------------------------------------------
# MemCounter
# ---------------------------------------------------------------------------


def test_block_bytes_rounds_as_the_caching_allocator():
    assert block_bytes(0) == 0
    assert block_bytes(1) == 512
    assert block_bytes(512) == 512
    assert block_bytes(513) == 1024
    assert block_bytes(5 * MB + 1) == 5 * MB + 512  # split off a 20 MiB segment
    assert block_bytes(11 * MB) == 12 * MB  # 1 MiB left of its segment: not split
    assert block_bytes(13 * MB + 512) == 14 * MB  # less than 1 MiB left
    assert block_bytes(13 * MB - 512) == 13 * MB - 512  # just over 1 MiB left: split
    assert block_bytes(14 * MB + 512) == 14 * MB + 512  # 1.5 MiB left: split


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_hand_built_sequence(device):
    """a = x*2; b = a+1; del a; c = b@b: at most two 4 MB temporaries are
    alive; views and in-place ops allocate nothing; a freed storage leaves
    the count."""
    x = torch.ones(1000, 1000, device=device)
    one = block_bytes(4 * 10**6)
    with MemCounter(storage_bytes(x)) as mem:
        a = x * 2
        b = a + 1
        del a
        c = b @ b
        c.add_(1)
        v = c.view(-1)[::2]
        assert mem.live_bytes == 3 * one
        del b
        assert mem.live_bytes == 2 * one
    assert mem.held_bytes == one
    assert mem.peak_bytes == 3 * one and mem.temp_bytes == 2 * one
    assert mem.stats() == {"held_bytes": one, "peak_bytes": 3 * one, "temp_bytes": 2 * one}
    del c, v
    assert mem.live_bytes == one


def test_storage_bytes_counts_each_storage_once():
    x = torch.empty(300, device="meta")
    assert storage_bytes({"a": x, "b": [x[:10], x.view(3, 100)]}) == 1536
    assert storage_bytes(x, torch.empty(0, device="meta")) == 1536


def _mlp_step(device):
    """An MLP block forward and backward and one AdamW step; returns the
    counter's (held, peak)."""
    gen = torch.Generator().manual_seed(0)
    d, f = 64, 256
    params = {"w1": torch.randn(d, f, generator=gen) * 0.1,
              "w2": torch.randn(f, d, generator=gen) * 0.1,
              "g": torch.ones(d)}
    params = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    x = torch.randn(4, 32, d, generator=gen).to(device)
    opt = AdamW()
    state = opt.init(params)
    with MemCounter(storage_bytes(params, state, x)) as mem:
        h = torch.nn.functional.rms_norm(x, (d,), params["g"])
        y = torch.nn.functional.gelu(h @ params["w1"]) @ params["w2"]
        loss = (x + y).square().mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt.update(grads, state, params, 1e-3)
    return mem.held_bytes, mem.peak_bytes


def test_kernel_free_step_peaks_equal_on_meta_and_cpu():
    held, peak = _mlp_step("meta")
    assert (held, peak) == _mlp_step("cpu")
    assert peak > held > 0


# ---------------------------------------------------------------------------
# The wrappers' meta branches: what the CUDA branch allocates, no plain run
# ---------------------------------------------------------------------------


@pytest.fixture
def no_plain(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on meta tensors")

    for mod, name in ((fa, "flash_attention_plain"), (fa, "flash_attention_backward_plain"),
                      (pa, "paged_attention_plain"), (ssd, "ssd_scan_plain"),
                      (ssd, "ssd_scan_backward_plain")):
        monkeypatch.setattr(mod, name, boom)


def _count(fn, *args, **kwargs):
    with MemCounter() as mem:
        out = fn(*args, **kwargs)
    return mem.peak_bytes, out


def _head_major(b, h, length, d, dtype):
    """A (B, H, L, D) head-major view of a (B, L, H, D) tensor, as the model
    hands the kernels."""
    return torch.empty(b, length, h, d, dtype=dtype, device="meta").transpose(1, 2)


@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_forward_meta_allocations(no_plain, return_lse):
    b, h, kh, length, d = 2, 8, 2, 256, 128
    q = _head_major(b, h, length, d, torch.bfloat16)
    k = v = _head_major(b, kh, length, d, torch.bfloat16)
    peak, out = _count(fa.flash_attention, q, k, v, causal=True, return_lse=return_lse)
    want = nbytes((b, h, length, d), torch.bfloat16)
    if return_lse:
        out, lse = out
        assert lse.shape == (b, h, length) and lse.dtype == torch.float32
        want += nbytes((b, h, length), torch.float32)
    assert out.shape == q.shape and out.stride() == q.stride()
    assert peak == want


@pytest.mark.parametrize("dtype,d,kind", [(torch.bfloat16, 128, "tc"), (torch.bfloat16, 32, "simt"),
                                          (torch.float32, 64, "simt")])
@pytest.mark.parametrize("misaligned_do", [False, True])
def test_flash_backward_meta_allocations(no_plain, dtype, d, kind, misaligned_do):
    """dq, dk, dv, the f32 row sums, a dense copy of a dO the kernels cannot
    read in place, and for the tensor-core variant the work list (once a
    shape)."""
    b, h, kh, length = 2, 8, 2, 192
    q = o = _head_major(b, h, length, d, dtype)
    k = v = _head_major(b, kh, length, d, dtype)
    lse = torch.empty(b, h, length, device="meta")
    do = _head_major(b, h, length, d, dtype)
    if misaligned_do:  # one element into its storage: not 16-byte aligned
        do = torch.empty(b * length * h * d + 1, dtype=dtype, device="meta")[1:]
        do = do.view(b, length, h, d).transpose(1, 2)
    fa._work_list.cache_clear()
    assert fa.backward_kind(d, dtype) == kind
    peak, (dq, dk, dv) = _count(fa.flash_attention_backward, q, k, v, o, lse, do, causal=True)
    want = nbytes(q.shape, dtype) + 2 * nbytes(k.shape, dtype) + nbytes((b, h, length), torch.float32)
    if misaligned_do:
        want += nbytes(q.shape, dtype)
    if kind == "tc":
        sched = fa.backward_schedule(b, h, kh, length, length, True, fa.H100_SMS)
        want += nbytes((len(sched.items), 5), torch.int32)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert peak == want
    # the work list is the device's copy of the schedule: a second call makes none
    if kind == "tc":
        assert _count(fa.flash_attention_backward, q, k, v, o, lse, do)[0] == (
            want - nbytes((len(sched.items), 5), torch.int32))


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("return_lse", [False, True])
def test_paged_meta_allocations(no_plain, pages, return_lse):
    b, h, kh, d, page, n_pages, pps = 4, 8, 2, 128, 16, 64, 8
    q = torch.empty(b, h, d, dtype=torch.bfloat16, device="meta")
    dt = torch.int8 if pages == "int8" else torch.bfloat16
    kp = vp = torch.empty(n_pages, page, kh, d, dtype=dt, device="meta")
    scales = ()
    if pages == "int8":
        scales = (torch.empty(n_pages, page, kh, 1, dtype=torch.float16, device="meta"),) * 2
    tables = torch.empty(b, pps, dtype=torch.int32, device="meta")
    lengths = torch.empty(b, dtype=torch.int32, device="meta")
    peak, out = _count(pa.paged_attention, q, kp, vp, tables, lengths, *scales,
                       return_lse=return_lse)
    want = nbytes((b, h, d), torch.bfloat16)
    if return_lse:
        out, lse = out
        assert lse.shape == (b, h) and lse.dtype == torch.float32
        want += nbytes((b, h), torch.float32)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert peak == want


@pytest.mark.parametrize("return_states", [False, True])
def test_ssd_forward_meta_allocations(no_plain, return_states):
    bsz, h, length, p, n = 2, 16, 200, 64, 64
    x = torch.empty(bsz, h, length, p, dtype=torch.bfloat16, device="meta")
    log_a = torch.empty(bsz, h, length, device="meta")
    b = c = torch.empty(bsz, length, n, dtype=torch.bfloat16, device="meta")
    peak, out = _count(ssd.ssd_scan, x, log_a, b, c, return_states=return_states)
    nck = -(-length // ssd.KERNEL_CHUNK)
    want = nbytes(x.shape, x.dtype) + nbytes((bsz, h, p, n), torch.float32)
    if return_states:
        want += nbytes((bsz, h, nck, p, n), torch.float32)
        assert out[2].shape == (bsz, h, nck, p, n)
    assert len(out) == 2 + return_states
    assert peak == want


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [64, 80])  # tensor-core chunk kernel (groups of heads), CUDA cores
def test_ssd_backward_meta_allocations(no_plain, x_dtype, p):
    """f32 copies of a bf16 x and dy, the f32 dx and dlog_a, the f32 dB and
    dC partials of ceil(H / group) head groups, dB and dC, the dS scratch,
    and dx cast back to x's dtype: all alive when the call returns."""
    bsz, h, length, n = 2, 32, 2048, 64
    x = torch.empty(bsz, h, length, p, dtype=x_dtype, device="meta")
    dy = torch.empty_like(x)
    log_a = torch.empty(bsz, h, length, device="meta")
    b = c = torch.empty(bsz, length, n, dtype=torch.bfloat16, device="meta")
    nck = -(-length // ssd.KERNEL_CHUNK)
    states = torch.empty(bsz, h, nck, p, n, device="meta")
    ds_final = torch.empty(bsz, h, p, n, device="meta")
    peak, (dx, dla, db, dc) = _count(ssd.ssd_scan_backward, x, log_a, b, c, dy, ds_final, states)
    kind = ssd.bwd_variant(p, n)
    group = 1 if kind == "simt" else min(ssd.bwd_group(bsz, h, length, ssd.H100_SMS), h)
    parts = -(-h // group)
    f32 = torch.float32
    want = (nbytes(x.shape, f32)  # dx
            + nbytes(log_a.shape, f32)
            + 2 * nbytes((bsz, parts, length, n), f32)
            + 2 * nbytes(b.shape, b.dtype)
            + nbytes(states.shape, f32))
    if x_dtype == torch.bfloat16:
        want += 2 * nbytes(x.shape, f32) + nbytes(x.shape, x_dtype)  # xf, dyf, dx cast
    assert kind == ("tc" if p == 64 else "simt")
    assert (dx.dtype, dla.dtype, db.dtype, dc.dtype) == (x_dtype, f32, b.dtype, c.dtype)
    assert peak == want


# ---------------------------------------------------------------------------
# The dry run: memory_analysis, fits, --causal-mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def masked_records(tmp_path_factory):
    """yi-6b decode_32k and train_4k through the CLI with --causal-mode
    masked, in a process of its own (it starts a fake process group)."""
    out = tmp_path_factory.mktemp("dryrun_masked")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape",
         "decode_32k", "train_4k", "--causal-mode", "masked", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = {}
    for name in os.listdir(out):
        with open(out / name) as f:
            rec = json.load(f)
        recs[rec["shape"]] = rec
    return recs, res.stdout


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_dryrun_records_memory_analysis(masked_records, shape):
    recs, stdout = masked_records
    rec = recs[shape]
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_bytes", "peak_bytes", "temp_bytes"}  # no shapes-only path
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    # the held storages, each rounded as the allocator rounds a block
    held = rec["bytes_per_rank"]["total"]
    assert held <= mem["argument_bytes"] <= 1.05 * held
    assert rec["fits"] == (mem["peak_bytes"] <= rec["hbm_budget_bytes"])
    assert f"peak {mem['peak_bytes'] / 1e9:.3f} GB" in stdout
    if shape == "train_4k":  # activations and gradients dwarf the held state
        assert mem["temp_bytes"] > 5 * mem["argument_bytes"]


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_causal_mode_masked_is_the_reference_count(masked_records, shape):
    rec = masked_records[0][shape]
    assert rec["variant"] == {"causal_mode": "masked", "remat": "full", "kv_dtype": "bf16"}
    kw = dict(moe_cf=1.25 if shape == "train_4k" else 2.0, optimizer=rec.get("optimizer", "adamw"),
              remat="full", causal_mode="masked", kv_dtype="bf16")
    want = ref_cost.cell_cost(REF_REGISTRY["yi-6b"], REF_SHAPES[shape], rec["params"], **kw)
    assert rec["analytic_cost"] == want.as_dict()
    assert "causal masked" in masked_records[1]
