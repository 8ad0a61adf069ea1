"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and nvcc:

1. builds every CUDA kernel of the port from ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, all at once), prints the build time and
   each library's count of ``HGMMA`` (wgmma) instructions in its SASS
   (``cuobjdump``); the flash library must have some;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving paths give it (bf16; yi-6b's head_dim 128, zamba2's
   80, yi-6b's int8 pages with f16 scales; zamba2's SSD scan at its prompt
   lengths, a ragged one included) and at the long-pool shapes (flash at
   yi-6b L=4096, paged at 2 slots x 65,536), with the tolerance, flash's
   variant and paged's split count printed, and times the kernel, the
   plain version and, where one exists, one PyTorch call computing the same
   function as a yardstick (the port never calls it);
3. serves 16 requests through the port's ``TwoPoolServer`` on full-width
   yi-6b (random bf16 weights from a seed): short pool c_max 512 with 8
   slots, long pool c_max 2048 with 2 slots. The kernels' launch counters
   are set to 0 just before and read just after; each must be > 0, and
   flash's tensor-core variant must have run. Then profiles ten decode
   steps of the short pool with all slots busy (step time, the device's
   busy share, kernels by device time; kernels per step may not exceed
   ``MAX_KERNELS_PER_STEP``), and holds one request's decode-step logits
   against a full ``forward`` recompute;
4. the same on yi-6b with an int8 KV cache (``Model(cfg,
   kv_dtype="int8")``, the same weights and draw): the int8 paged kernel
   must run, and its decode logits are held against the bf16 forward;
5. the same on full-width zamba2-2.7b (54 Mamba-2 blocks, 2 shared
   attention blocks applied 9 times; random bf16 weights from seed 0): the
   SSD scan, flash and paged kernels must each run;
6. the fleet DES (``FleetSim(backend="torch", device="cuda")``) on the
   paper's Table-2 fleet: an Azure trace at 1,000 req/s (seed 0),
   B_short 8192, the A100/Llama-3-70B timing model, short pool c_max 8192
   and long pool c_max 65,536 sized by ``plan_fleet``, spillover off. It
   holds the ``sim_decode`` kernel against its plain version bit for bit at
   that fleet's stacked shapes (idle rows, ``t_limit = inf``, truncation at
   c_max, KV growth past the free blocks) and times both; runs the routed
   and the homogeneous fleet through the kernel (its launch counter set to
   0 just before the routed run and read just after; it must be > 0); and
   runs a shorter routed trace on the card and on the CPU, whose records
   and loop counters must be equal bit for bit; and profiles a short
   routed run (device busy share, kernels per round);
7. prints the earlier design's times at the JSON line's flash and paged
   shapes on a line of their own (``[prior]``, copied from PERF.md, not
   measured here), the kernels' JSON line (each flash and paged entry also
   carries its variant or split count), the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result;
so does a machine without a GPU, and a directory without the repository.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cost_model import closed_form_savings  # noqa: E402
from repro_torch.core.pools import (  # noqa: E402
    PoolConfig,
    homogeneous_pool,
    n_seq_for_cmax,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
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
from repro_torch.launch.serve import run_workload, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import quantize_kv  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine, TwoPoolServer  # noqa: E402
from repro_torch.sim import A100_LLAMA3_70B, FleetSim, plan_fleet  # noqa: E402
from repro_torch.sim import torch_engine  # noqa: E402
from repro_torch.traces import TraceSpec, generate_trace_columns  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate, the
# float32 rate outside the tensor cores, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# bf16 outputs of the kernel and its plain version both round an f32
# result; at |o| < 4 a bf16 ulp is 2**-6, so 2e-2 allows about one ulp plus
# f32 summation-order noise.
KERNEL_TOL = 2e-2
# An absolute limit says little where outputs are small (a row averaging
# thousands of positions has |o| ~ 0.02), so every bf16 flash and paged row
# is also held, row by row (one query's output of one head), to ROW_ULPS
# bf16 ulps at that row's largest plain magnitude. Paged decode (bf16 and
# int8 pages) computes in f32 like its plain version, so the two differ by
# one rounding to bf16 (at most 1 ulp) and f32 noise; flash rounds P to
# bf16 for the tensor cores (2**-9 relative a probability, ~0.001 of a
# row's spread after averaging). A share or tile weighed wrongly moves a
# row by far more.
ROW_ULPS = 2
# Decode-step logits against a full-forward recompute, both bf16 at full
# width (see logits_check): the two paths round different GEMM shapes
# (M = slots vs M = L) and run different attention kernels; each rounding
# is 2**-8 relative, and 32 layers of them stay within a few percent of the
# logit vector's norm. Held as the relative L2 error.
LOGITS_REL_TOL = 5e-2
# The int8 cache's decode logits against the bf16 forward: on top of the
# above, K and V carry int8 quantization noise (half a step of amax/127 per
# value, ~0.4 % of the row's largest value) through every layer.
INT8_LOGITS_REL_TOL = 1e-1
# The SSD scan's f32 output against its plain version: the two sum the
# same chunked products in different orders (elementwise |a - b| <=
# SSD_ATOL + SSD_RTOL * |b|).
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4

DENSE, HYBRID = "yi-6b", "zamba2-2.7b"
SERVE = dict(
    requests=16, short_cmax=512, long_cmax=2048,
    short_slots=8, long_slots=2, seed=0, full_width=True,
)
#: Launch counters, by the name the JSON line gives each kernel's wrapper.
COUNTERS = {"flash_attention": flash_attention, "paged_attention": paged_attention,
            "ssd_scan": ssd_scan}
#: Kernels per decode step (8 busy slots) that the profiled steps may not
#: exceed: the counts the served paths had before the attention kernels
#: were redesigned (the split combines inside the paged launch).
MAX_KERNELS_PER_STEP = {"profile": 1665, "profile-int8": 2081, "profile-hybrid": 3910}
#: The earlier design's device times (ms) at the JSON line's shapes, read
#: on the same card model (NVIDIA H100 80GB HBM3, 700 W; PERF.md's table);
#: printed on their own line, never in the kernels' JSON line.
PRIOR_MS = {"flash_attention": 0.1287, "flash_attention_d80": 0.0835,
            "paged_attention": 0.0677, "paged_attention_d80": 0.0334,
            "paged_attention_int8": 0.0626}
#: The paged rows: (name, slots, c_max); the long-pool row runs at yi-6b's
#: widths only (bf16 and int8 pages).
POOLS = (("short", 8, 512), ("long", 2, 2048))
LONG_POOL = ("long64k", 2, 65_536)

# The paper's Table 2 fleet (1,000 req/s, B_short = 8192) on the DES.
# ``requests`` is the routed and homogeneous runs' trace length, ``cross``
# the CUDA-against-CPU trace's, ``profile`` the profiled run's.
DES = dict(trace="azure", rate=1000.0, seed=0, b_short=8192, requests=10_000, cross=2_000,
           profile=1_000)
# sim_decode's bytes per slot and per (pool, instance) row, from the dtypes:
# in occ 1, pre sq inp gen rem blk 4 each, ft 8, tr 1; out pre gen rem 4
# each, ft 8, dec trunc_new tr comp 1 each; rows in busy 1, now 8, nact
# free 4 each, out k 4, end 8. About 40 integer and float operations per
# slot, counted at the float32 rate outside the tensor cores.
SIM_DECODE_SLOT_BYTES = (1 + 6 * 4 + 8 + 1, 3 * 4 + 8 + 4 * 1)
SIM_DECODE_ROW_BYTES = (1 + 8 + 4 + 4, 4 + 8)
SIM_DECODE_SLOT_OPS = 40


def fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAILED: {msg}")


def time_ms(fn, *, iters: int = 20, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after an L2
    flush (the serving loop reaches each kernel with a cold L2). A device
    sleep ahead of each timed call lets the host enqueue the whole call
    before the device reaches it, so host launch overhead stays out of the
    reading."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms of device clock cycles
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def row_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's max |out - ref|, in bf16 ulps at that row's largest
    |ref| (a row: the last dimension)."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    top = ref.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / torch.exp2(torch.floor(torch.log2(top)) - 7)).max().item()


def check_close(out: torch.Tensor, ref: torch.Tensor, what: str) -> tuple[float, float]:
    """Holds a bf16 output to KERNEL_TOL and to ROW_ULPS a row; returns the
    max abs error and the worst row's ulps."""
    err = (out.float() - ref.float()).abs().max().item()
    ulps = row_ulps(out, ref)
    if not (err <= KERNEL_TOL and ulps <= ROW_ULPS):
        fail(f"{what}: max |kernel - plain| {err} (limit {KERNEL_TOL}), worst row "
             f"{ulps:.3g} bf16 ulps of its largest value (limit {ROW_ULPS})")
    return err, ulps


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(dev, flush, *, heads: tuple[int, int, int], lengths: tuple[int, ...],
                tag: str) -> dict:
    """Causal prefill at one model's widths (H, K, D), bf16."""
    gen = torch.Generator(device=dev).manual_seed(0)
    H, K, D = heads
    rows = {}
    for L in lengths:
        q = torch.randn(1, H, L, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(1, K, L, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(1, K, L, D, generator=gen, device=dev).to(torch.bfloat16)
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, ulps = check_close(out, flash_attention_plain(q, k, v), f"flash {tag} L={L}")
        nbytes = 2 * (2 * H * L * D + 2 * K * L * D)  # q, o, k, v in bf16
        flops = 4 * H * D * (L * (L + 1) // 2)  # QK^T and PV over causal pairs
        bnd, by = bound_ms(nbytes, flops)
        row = dict(
            L=L, max_abs_err=err,
            ms=time_ms(lambda: flash_attention(q, k, v), flush=flush),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v), flush=flush),
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True
                ),
                flush=flush,
            ),
            bound_ms=bnd, bound_by=by,
        )
        row["variant"] = flash_mod.variant(D, q.dtype)
        rows[L] = row
        print(f"[flash] {tag} H={H} K={K} D={D} L={L:5d} variant {row['variant']} err {err:.3g} "
              f"(tol {KERNEL_TOL}), worst row {ulps:.3g} ulps (tol {ROW_ULPS}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"sdpa {row['library_ms']:.4f} ms bound {bnd:.4f} ms ({by})", flush=True)
    return rows


def paged_phase(dev, flush, *, heads: tuple[int, int, int], tag: str, int8: bool = False,
                pools: tuple = POOLS) -> dict:
    """Decode over one layer's slot cache viewed as 16-token pages, at the
    serving pools' shapes (short: 8 slots x 512, long: 2 slots x 2048, and
    where asked the paper's long pool, 2 x 65,536), ragged lengths, plus a
    poison check of the pages past each length.
    With ``int8`` the cache is quantized as the model quantizes it (int8
    values, one f16 scale per position and head); the yardstick is SDPA
    over the dequantized bf16 cache, the dequantization timed apart."""
    gen = torch.Generator(device=dev).manual_seed(1)
    H, K, D = heads
    rows = {}
    for name, slots, c_max in pools:
        q = torch.randn(slots, H, D, generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn(slots, c_max, K, D, generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn(slots, c_max, K, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.randint(1, c_max + 1, (slots,), generator=gen, device=dev, dtype=torch.int32)
        bt = ops.slot_block_table(slots, c_max, dev)
        scales: tuple = ()
        if int8:
            (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
            scales = (ks.view(-1, ops.PAGE, K, 1), vs.view(-1, ops.PAGE, K, 1))
        kp = kc.view(-1, ops.PAGE, K, D)
        vp = vc.view(-1, ops.PAGE, K, D)
        out = paged_attention(q, kp, vp, bt, lengths, *scales)
        torch.cuda.synchronize()
        plain = paged_attention_plain(q, kp, vp, bt, lengths, *scales)
        err, ulps = check_close(out, plain, f"paged {tag} {name}")
        poisoned = [t.clone() for t in (scales if int8 else (kp, vp))]
        for b in range(slots):
            dead = bt[b, math.ceil(int(lengths[b]) / ops.PAGE):].long()
            for t in poisoned:
                t[dead] = float("nan")
        args = (kp, vp, *poisoned) if int8 else (*poisoned,)
        if not torch.equal(paged_attention(q, *args[:2], bt, lengths, *args[2:]), out):
            fail(f"paged {tag} {name}: pages past the length changed the output")
        total = int(lengths.sum())
        pages = int(((lengths + ops.PAGE - 1) // ops.PAGE).sum())  # table entries read
        per_pos = K * (D + 2) if int8 else K * D * 2  # K or V bytes per position
        nbytes = 2 * total * per_pos + 2 * 2 * slots * H * D + 4 * (pages + slots)
        flops = 4 * H * D * total
        bnd, by = bound_ms(nbytes, flops)
        mask = torch.arange(c_max, device=dev)[None] < lengths[:, None]

        def dequant():
            if not int8:
                return kc, vc
            return ((kc.float() * ks.float()).to(torch.bfloat16),
                    (vc.float() * vs.float()).to(torch.bfloat16))

        kd, vd = dequant()
        q4, k4, v4 = q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
        row = dict(
            slots=slots, c_max=c_max, sum_lengths=total, max_abs_err=err,
            ms=time_ms(lambda: paged_attention(q, kp, vp, bt, lengths, *scales), flush=flush),
            plain_ms=time_ms(lambda: paged_attention_plain(q, kp, vp, bt, lengths, *scales),
                             flush=flush),
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask[:, None, None], enable_gqa=True
                ),
                flush=flush,
            ),
            bound_ms=bnd, bound_by=by,
        )
        extra = ""
        if int8:
            row["dequant_ms"] = time_ms(dequant, flush=flush)
            extra = f" (+ dequantize to bf16 {row['dequant_ms']:.4f} ms)"
        row["splits"] = split_count(slots, H, K, c_max, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)
        rows[name] = row
        print(f"[paged] {tag} H={H} K={K} D={D} {name} B={slots} c_max={c_max} "
              f"splits {row['splits']} ({slots * K * row['splits'] * -(-(H // K) // 8)} CTAs) "
              f"sum(len)={total} err {err:.3g} (tol {KERNEL_TOL}), worst row {ulps:.3g} ulps "
              f"(tol {ROW_ULPS}), poison ok; kernel "
              f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa "
              f"{row['library_ms']:.4f} ms{extra} bound {bnd:.4f} ms ({by})", flush=True)
    return rows


def ssd_min_flops(L: int, P: int, N: int) -> int:
    """The fewest FLOPs one head's scan of L steps takes: the chunked form
    at its cheapest chunk length q (the kernel's own q = 64 costs more; q = 1
    is about the 5·P·N-a-step recurrence). A chunk of m steps costs the
    masked C·Bᵀ and scores·x over i >= j, (N + P)·m(m + 1); the C·S read and
    the state update, 2·2·m·P·N; and the state's decay, P·N. At P = N = 64
    the cheapest q is 5 or 6, about 18.0 k FLOPs a step."""

    def chunk(m: int) -> int:
        return (N + P) * m * (m + 1) + 4 * m * P * N + P * N

    def at(q: int) -> int:
        full, tail = divmod(L, q)
        return full * chunk(q) + (chunk(tail) if tail else 0)

    return min(at(q) for q in range(1, L + 1))


def ssd_phase(dev, flush) -> dict:
    """The SSD chunk scan at zamba2's prefill shape (B = 1, H = 80 SSM
    heads, P = 64, N = 64; x folded with dt in f32, B/C bf16 as the model
    gives them) at the longest prompt a short-pool request brings and at a
    ragged length."""
    cfg = get_config(HYBRID)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for L in (256, 200):
        dt = torch.rand((1, H, L), generator=gen, device=dev) * 0.19 + 0.01
        a = -(torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
        x = torch.randn((1, H, L, P), generator=gen, device=dev) * dt[..., None]
        log_a = (a[None, :, None] * dt).contiguous()
        bm = torch.randn((1, L, N), generator=gen, device=dev).to(torch.bfloat16)
        cm = torch.randn((1, L, N), generator=gen, device=dev).to(torch.bfloat16)
        y, st = ssd_scan(x, log_a, bm, cm)
        torch.cuda.synchronize()
        yp, sp = ssd_scan_plain(x, log_a, bm, cm)
        for got, want, what in ((y, yp, "y"), (st, sp, "state")):
            if not torch.allclose(got, want, atol=SSD_ATOL, rtol=SSD_RTOL):
                fail(f"ssd_scan L={L}: {what} differs from the plain version, max "
                     f"|diff| {(got - want).abs().max().item()}")
        err = max((y - yp).abs().max().item(), (st - sp).abs().max().item())
        # bytes: x read and y written in f32, log_a, B and C, the state written
        nbytes = 4 * 2 * H * L * P + 4 * H * L + 2 * 2 * L * N + 4 * H * P * N
        bnd, by = bound_ms(nbytes, H * ssd_min_flops(L, P, N), PEAK_F32_FLOPS)
        row = dict(
            L=L, max_abs_err=err,
            ms=time_ms(lambda: ssd_scan(x, log_a, bm, cm), flush=flush),
            plain_ms=time_ms(lambda: ssd_scan_plain(x, log_a, bm, cm), flush=flush),
            bound_ms=bnd, bound_by=by, library_ms=None,
        )
        rows[L] = row
        print(f"[ssd_scan] B=1 H={H} P={P} N={N} L={L} grid {H} CTAs: max |kernel - plain| "
              f"{err:.3g} (tol {SSD_ATOL} + {SSD_RTOL}*|plain|); kernel {row['ms']:.4f} ms "
              f"plain {row['plain_ms']:.4f} ms bound {bnd:.4f} ms ({by}); no single "
              f"PyTorch call computes this scan", flush=True)
    return rows


def check_served(result: dict, arch: str, kernels: tuple[str, ...], tag: str) -> dict:
    """Every request answered with in-vocabulary tokens, calibration fed by
    every response, and each kernel of the path launched; prints the
    serve phase's lines. Returns the launches and the decode rate."""
    launches = {name: COUNTERS[name].launches for name in kernels}
    stats = result["stats"]
    responses = sorted(result["responses"], key=lambda r: r.request_id)
    vocab = get_config(arch).vocab
    if [r.request_id for r in responses] != list(range(SERVE["requests"])):
        fail(f"{tag}: served {len(responses)} of {SERVE['requests']} requests")
    for r in responses:
        print(f"[{tag}] req {r.request_id:2d} pool {r.pool:5s} prompt "
              f"{r.prompt_tokens:3d} est {r.estimated_budget:4d} out "
              f"{len(r.output_tokens):4d} first {r.output_tokens[:6]}")
        if not r.output_tokens or not all(0 <= t < vocab for t in r.output_tokens):
            fail(f"{tag}: request {r.request_id}: bad output tokens")
    if sum(stats["router"]["calibration"]["count"]) != SERVE["requests"]:
        fail(f"{tag}: calibration did not see every response")
    if sum(result["by_pool"].values()) != SERVE["requests"]:
        fail(f"{tag}: pool split {result['by_pool']} does not cover every request")
    decode_tokens = stats["short_decode_tokens"] + stats["long_decode_tokens"]
    print(f"[{tag}] router stats: {json.dumps(stats['router'])}")
    print(f"[{tag}] decode tokens {decode_tokens} in {result['wall_s']:.3f} s of serving: "
          f"{decode_tokens / result['wall_s']:.1f} tok/s; iterations short "
          f"{stats['short_iterations']} long {stats['long_iterations']}")
    if "flash_attention" in kernels:
        launches["flash_attention_tc"] = flash_attention.launches_tc
        launches["flash_attention_simt"] = flash_attention.launches_simt
    print(f"[{tag}] kernel launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0 and name != "flash_attention_simt":
            fail(f"{tag}: {name} was never launched on the main path")
    return {"launches": launches, "server": result["server"], "decode_tokens": decode_tokens,
            "wall_s": result["wall_s"]}


def reset_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    flash_mod.reset_counters()


def serve_phase(arch: str, kernels: tuple[str, ...], tag: str) -> dict:
    reset_counters()
    result = serve(arch, **SERVE, device="cuda")
    return check_served(result, arch, kernels, tag)


def serve_int8_phase(dense_srv) -> dict:
    """yi-6b with an int8 KV cache: the bf16 serve's weights (as drawn, not
    yet tempered by ``logits_check``), the same pools and the same
    16-request draw."""
    params = dense_srv.short_engine.params
    model = Model(get_config(DENSE), kv_dtype="int8")
    srv = TwoPoolServer(model, params, short_cmax=SERVE["short_cmax"],
                        long_cmax=SERVE["long_cmax"], short_slots=SERVE["short_slots"],
                        long_slots=SERVE["long_slots"])
    if srv.short_engine.cache.state[0].dtype != torch.int8:
        fail("the int8 model's slot cache is not int8")
    reset_counters()
    result = run_workload(srv, requests=SERVE["requests"], seed=SERVE["seed"])
    return check_served(result, DENSE, ("paged_attention",), "serve-int8")


def profile_decode(srv, tag: str, steps: int = 10) -> dict:
    """Where a decode step's time goes: the short pool's engine with all 8
    slots busy, ``steps`` decode steps under torch.profiler. Returns the
    step time, the device's busy share and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    model, params = srv.short_engine.model, srv.short_engine.params
    eng = ServingEngine(model, params, c_max=SERVE["short_cmax"], n_slots=SERVE["short_slots"])
    rng = np.random.default_rng(2)
    for i in range(SERVE["short_slots"]):
        prompt = [int(t) for t in rng.integers(0, model.cfg.vocab, 200)]
        eng.submit(ServeRequest(i, prompt, max_new_tokens=steps + 8))
    for _ in range(3):  # admission + prefill, then warm decode steps
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out = dict(
        step_ms=wall_ms / steps, busy_share=busy_ms / wall_ms,
        top=[(e.key[:60], e.count // steps, e.self_device_time_total / 1e3 / steps) for e in top],
    )
    out["kernels_per_step"] = sum(e.count for e in kernels) / steps
    print(f"[{tag}] short pool, 8 busy slots: {out['step_ms']:.3f} ms per decode step, "
          f"device busy {100 * out['busy_share']:.1f}% of the wall, "
          f"{out['kernels_per_step']:.0f} kernels per step (at most {MAX_KERNELS_PER_STEP[tag]})")
    for key, n, ms in out["top"]:
        print(f"[{tag}]   {ms:8.4f} ms/step  {n:4d}/step  {key}")
    if out["kernels_per_step"] > MAX_KERNELS_PER_STEP[tag]:
        fail(f"{tag}: {out['kernels_per_step']:.0f} kernels per decode step, more than "
             f"{MAX_KERNELS_PER_STEP[tag]}")
    return out


def decode_vs_forward(model, params) -> dict:
    """One request's last decode-step logits and a full forward recompute
    of the same context."""
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(0, model.cfg.vocab, 150)]
    eng = ServingEngine(model, params, c_max=SERVE["short_cmax"], n_slots=1)
    eng.submit(ServeRequest(0, prompt, max_new_tokens=4))
    comps = []
    while not comps:
        comps = eng.step()
    gen = comps[0].output_tokens
    got = eng.last_logits[0].float()
    ref, _ = model.forward(params, {"tokens": torch.tensor([prompt + gen[:-1]], device=got.device)})
    ref = ref[0, -1].float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        fail("non-finite logits")
    return dict(
        rel_l2=((got - ref).norm() / ref.norm()).item(),
        max_abs_diff=(got - ref).abs().max().item(),
        max_abs_logit=ref.abs().max().item(),
        argmax=(int(got.argmax()), int(ref.argmax())),
    )


def logits_check(srv, tag: str) -> float:
    """Decode-step logits against a full forward recompute, full width.

    With the reference's init (q/k projections scaled by the head count, so
    attention scores have a std near 100 at yi-6b widths and softmax is an
    arg-max) the two paths' different bf16 roundings pick different keys
    and the logits decorrelate; that reading is printed, not held. The held
    reading scales w_q and w_k by 0.1 (in place, after serving; the dense
    model's layers, the hybrid's shared attention blocks), which leaves the
    attention soft, so the paths differ by bf16 rounding only.
    """
    model, params = srv.short_engine.model, srv.short_engine.params
    raw = decode_vs_forward(model, params)
    print(f"[{tag}] reference init (not held): {raw}")
    attn = params["shared"] if "shared" in params else params["blocks"]
    for name in ("w_q", "w_k"):
        attn[name].mul_(0.1)
    r = decode_vs_forward(model, params)
    print(f"[{tag}] w_q, w_k x0.1: decode step vs forward rel L2 {r['rel_l2']:.4g} "
          f"(tol {LOGITS_REL_TOL}), max |diff| {r['max_abs_diff']:.4g} of max |logit| "
          f"{r['max_abs_logit']:.4g}; argmax {r['argmax']}")
    if not r["rel_l2"] <= LOGITS_REL_TOL:
        fail(f"{tag}: decode logits differ from forward: rel L2 {r['rel_l2']} > "
             f"{LOGITS_REL_TOL}")
    return r["rel_l2"]


def logits_int8_check(srv) -> float:
    """The int8 model's decode-step logits against the bf16 full forward
    (its forward is the bf16 model's: the cache plays no part), on the
    weights ``logits_check`` tempered."""
    r = decode_vs_forward(srv.short_engine.model, srv.short_engine.params)
    print(f"[logits-int8] int8 decode step vs bf16 forward rel L2 {r['rel_l2']:.4g} "
          f"(tol {INT8_LOGITS_REL_TOL}), max |diff| {r['max_abs_diff']:.4g} of max |logit| "
          f"{r['max_abs_logit']:.4g}; argmax {r['argmax']}")
    if not r["rel_l2"] <= INT8_LOGITS_REL_TOL:
        fail(f"int8 decode logits differ from the bf16 forward: rel L2 {r['rel_l2']} > "
             f"{INT8_LOGITS_REL_TOL}")
    return r["rel_l2"]


# ---------------------------------------------------------------------------
# The fleet DES: the sim_decode kernel and the torch tier on the card
# ---------------------------------------------------------------------------


def des_setup():
    """The Table-2 trace, the fleet plan and the two fleets it sizes."""
    cols = generate_trace_columns(TraceSpec(
        trace=DES["trace"], num_requests=DES["requests"], rate=DES["rate"], seed=DES["seed"],
    ))
    plan = plan_fleet(DES["trace"], cols.to_requests(), A100_LLAMA3_70B, DES["rate"],
                      b_short=DES["b_short"])
    routed = {
        "short": (PoolConfig("short", DES["b_short"], n_seq_for_cmax(DES["b_short"]),
                             headroom=1.05), plan.short.instances),
        "long": (PoolConfig("long", 65_536, 16, headroom=1.02), plan.long.instances),
    }
    homo = {"homogeneous": (homogeneous_pool(), plan.g_homo)}
    print(f"[des] Table 2 plan ({DES['trace']}, {DES['rate']:.0f} req/s, B_short "
          f"{DES['b_short']}, {DES['requests']} requests, seed {DES['seed']}): homogeneous "
          f"{plan.g_homo}, short {plan.short.instances} x {routed['short'][0].n_seq} slots, "
          f"long {plan.long.instances} x 16 slots, dual {plan.g_dual}; savings "
          f"{plan.savings:.4f} (the naive Eq. 7 closed form, which assumes the long pool "
          f"keeps the homogeneous throughput, over-predicts: {closed_form_savings(plan.alpha, plan.rho):.4f})",
          flush=True)
    return cols, plan, routed, homo


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def sim_decode_phase(dev, flush, shape: tuple[int, int, int], c_max: list[int]) -> dict:
    """The kernel against its plain version on the card, bit for bit on all
    ten outputs, at the routed fleet's stacked ``(P, I, S)`` shape; both
    timed on the first state."""
    P, I, S = shape
    row = {}
    for seed, t_limit in ((0, None), (1, math.inf), (2, None)):
        st = random_state(seed, c_max, I, S, t_limit=t_limit, device=dev)
        args = [st[k] for k in ("t_limit", "busy", "now", "nact", "free", "occ", "pre",
                                "sq", "inp", "gen", "rem", "blk", "ft", "tr", "c_max")]
        kw = dict(w=A100_LLAMA3_70B.w_base, h=A100_LLAMA3_70B.h_per_seq,
                  chunk=A100_LLAMA3_70B.prefill_chunk)
        got = decode_advance(*args, **kw)
        torch.cuda.synchronize()
        want = decode_advance_plain(*args, **kw)
        err = 0.0
        for k in OUTPUTS:
            a, b = got[k], want[k]
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(bits(a), bits(b)):
                fail(f"sim_decode seed {seed}: output {k} differs from the plain version")
            if a.dtype == torch.float64:
                err = max(err, (a - b).nan_to_num(0.0).abs().max().item())
        idle = int((~st["busy"] & (st["nact"] > 0)).sum())
        over = int((st["busy"] & (st["free"] == 0) & (got["k"] == 1)).sum())
        trunc = int(got["trunc_new"].sum())
        if not (idle and over and trunc):
            fail(f"sim_decode seed {seed}: state lacks idle ({idle}), overflow ({over}) "
                 f"or truncating ({trunc}) rows")
        print(f"[sim_decode] (P, I, S) = {shape} seed {seed} t_limit "
              f"{'inf' if t_limit else 'finite'}: 10 outputs bit-identical to the plain "
              f"version; idle rows {idle}, overflow rows {over}, truncations {trunc}", flush=True)
        if not row:
            slots, rows = P * I * S, P * I
            nbytes = slots * sum(SIM_DECODE_SLOT_BYTES) + rows * sum(SIM_DECODE_ROW_BYTES) + 8 + 4 * P
            bnd, by = bound_ms(nbytes, slots * SIM_DECODE_SLOT_OPS, PEAK_F32_FLOPS)
            row = dict(
                shape=shape, max_abs_err=err,
                ms=time_ms(lambda: decode_advance(*args, **kw), flush=flush),
                plain_ms=time_ms(lambda: decode_advance_plain(*args, **kw), flush=flush),
                bound_ms=bnd, bound_by=by,
            )
        row["max_abs_err"] = max(row["max_abs_err"], err)
    print(f"[sim_decode] kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}); no single PyTorch call computes "
          f"this round", flush=True)
    return row


def run_des(pools, cols, dev, *, label: str) -> dict:
    """One fleet run through ``backend="torch"``; prints what the paper's
    tables read and the loop's counters."""
    sim = FleetSim(pools, A100_LLAMA3_70B, b_short=DES["b_short"], backend="torch",
                   device=dev, spillover=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(cols)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = torch_engine.last_run_stats()
    s = res.summary
    n = len(cols)
    if not 0 < stats["iters"] <= n + 1 or stats["rounds"] < stats["iters"]:
        fail(f"{label}: loop counters {stats} out of bounds for n={n}")
    if s.completed + s.rejected != s.num_requests or s.completed == 0:
        fail(f"{label}: {s.completed} completed + {s.rejected} rejected != {s.num_requests}")
    if not (math.isfinite(s.ttft_p99) and math.isfinite(s.tpot_p99)):
        fail(f"{label}: non-finite latency percentiles")
    routed = res.router_stats.get("routed", {name: n for name in pools})
    if sum(routed.values()) != n:
        fail(f"{label}: {sum(routed.values())} routing decisions for {n} requests")
    fractions = {k: round(v / n, 4) for k, v in routed.items()}
    print(f"[des] {label} on {dev.type}: {n} requests, {sum(c for _, c in pools.values())} "
          f"instances; completed {s.completed} rejected {s.rejected} preempted "
          f"{res.preemptions} truncated {s.truncated} (of {s.num_requests} after warm-up); "
          f"TTFT p99 {s.ttft_p99:.4f} s TPOT p99 {s.tpot_p99:.4f} s, meets SLO "
          f"{res.meets_slo()}; routing {fractions}; iters {stats['iters']} rounds "
          f"{stats['rounds']} host syncs {stats['host_syncs']}; {wall:.2f} s wall, "
          f"{n / wall:.1f} simulated requests per wall second", flush=True)
    return dict(sim=sim, res=res, stats=stats, wall_s=wall)


def record_columns(sim) -> dict:
    return {name: pool.record_arrays() for name, pool in sim.pools.items()}


def des_phase(dev, flush) -> dict:
    cols, plan, routed, homo = des_setup()
    n_short = routed["short"][0].n_seq
    shape = (2, max(plan.short.instances, plan.long.instances), max(n_short, 16))
    kernel = sim_decode_phase(dev, flush, shape, [DES["b_short"], 65_536])

    decode_advance.launches = 0
    run_des(routed, cols, dev, label="routed Table-2 fleet")
    launches = decode_advance.launches
    print(f"[des] sim_decode launches on the routed run: {launches}", flush=True)
    if launches == 0:
        fail("sim_decode was never launched on the DES path")
    decode_advance.launches = 0
    run_des(homo, cols, dev, label="homogeneous fleet")
    if decode_advance.launches == 0:
        fail("sim_decode was never launched on the homogeneous run")
    print(f"[des] instances homogeneous {plan.g_homo} vs token-budget {plan.g_dual}: "
          f"savings {plan.savings:.4f}", flush=True)

    short = generate_trace_columns(TraceSpec(
        trace=DES["trace"], num_requests=DES["cross"], rate=DES["rate"], seed=DES["seed"],
    ))
    on_card = run_des(routed, short, dev, label=f"routed, n={DES['cross']}")
    on_cpu = run_des(routed, short, torch.device("cpu"), label=f"routed, n={DES['cross']}")
    for key in ("iters", "rounds"):
        if on_card["stats"][key] != on_cpu["stats"][key]:
            fail(f"CUDA and CPU runs differ in {key}: {on_card['stats']} vs {on_cpu['stats']}")
    a, b = record_columns(on_card["sim"]), record_columns(on_cpu["sim"])
    for pool in a:
        for col, va in a[pool].items():
            vb = b[pool][col]
            if va.dtype != vb.dtype or va.tobytes() != vb.tobytes():
                fail(f"CUDA and CPU runs differ in {pool}.{col}")
    print(f"[des] n={DES['cross']}: CUDA and CPU records bit-identical "
          f"({sum(len(v['request_id']) for v in a.values())} rows), iters/rounds "
          f"{on_card['stats']['iters']}/{on_card['stats']['rounds']} on both", flush=True)
    profile_des(routed, dev)
    return dict(kernel=kernel, launches=launches)


def profile_des(pools, dev) -> dict:
    """Where a DES round's time goes on the card: the routed fleet on a
    ``DES["profile"]``-request trace under torch.profiler. Returns the wall
    and device time per round, the device's busy share of the wall and the
    kernels by device time (the profiler's own cost is in the wall)."""
    from torch.profiler import ProfilerActivity, profile

    cols = generate_trace_columns(TraceSpec(
        trace=DES["trace"], num_requests=DES["profile"], rate=DES["rate"], seed=DES["seed"],
    ))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = run_des(pools, cols, dev, label="routed, profiled")
    rounds = run["stats"]["rounds"]
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    wall_ms = run["wall_s"] * 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out = dict(
        round_ms=wall_ms / rounds, device_ms_per_round=busy_ms / rounds,
        busy_share=busy_ms / wall_ms, kernels_per_round=sum(e.count for e in kernels) / rounds,
    )
    print(f"[des-profile] {rounds} rounds: {out['round_ms']:.3f} ms of wall and "
          f"{1e3 * out['device_ms_per_round']:.1f} us of device time per round, "
          f"{out['kernels_per_round']:.1f} kernels per round; device busy "
          f"{100 * out['busy_share']:.2f}% of the wall")
    for e in top:
        print(f"[des-profile]   {e.self_device_time_total / rounds:8.2f} us/round "
              f"{e.count / rounds:6.2f}/round  {e.key[:70]}")
    return out


def sass_hgmma_counts() -> dict:
    """Each built library's count of HGMMA instructions, from its SASS."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    counts = {}
    for name in _build.KERNELS:
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = sum(line.count("HGMMA") for line in sass.splitlines())
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(reports)} kernels in {build_s:.1f} s into {_build.BUILD_DIR}")
    for name, rep in reports.items():  # ptxas -v, summed over each library's kernels
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", rep)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", rep)]
        if not regs:
            print(f"[build] {name}: built before this run, no ptxas report")
            continue
        print(f"[build] {name}: {len(regs)} kernels, registers per thread {min(regs)}-"
              f"{max(regs)}, {sum(s > 0 for s in spills)} with spills (at most "
              f"{max(spills)} bytes stored)")
    hgmma = sass_hgmma_counts()
    print(f"[build] HGMMA instructions in each library's SASS: {hgmma}", flush=True)
    if not hgmma["flash_attention"]:
        fail("the flash_attention library has no HGMMA (wgmma) instruction")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    dense_cfg, hybrid_cfg = get_config(DENSE), get_config(HYBRID)
    dense_heads = (dense_cfg.n_heads, dense_cfg.n_kv_heads, dense_cfg.head_dim)
    hybrid_heads = (hybrid_cfg.n_heads, hybrid_cfg.n_kv_heads, hybrid_cfg.head_dim)
    flash_rows = flash_phase(dev, flush, heads=dense_heads,
                             lengths=(64, 256, 512, 1024, 4096), tag=DENSE)
    flash80 = flash_phase(dev, flush, heads=hybrid_heads, lengths=(256, 200), tag=HYBRID)
    paged_rows = paged_phase(dev, flush, heads=dense_heads, tag=DENSE, pools=POOLS + (LONG_POOL,))
    paged80 = paged_phase(dev, flush, heads=hybrid_heads, tag=HYBRID)
    paged8 = paged_phase(dev, flush, heads=dense_heads, tag=f"{DENSE} int8", int8=True,
                         pools=POOLS + (LONG_POOL,))
    ssd_rows = ssd_phase(dev, flush)
    del flush

    served = serve_phase(DENSE, ("flash_attention", "paged_attention"), "serve")
    profile_decode(served["server"], "profile")
    served8 = serve_int8_phase(served["server"])  # before logits_check tempers the weights
    profile_decode(served8["server"], "profile-int8")
    logits_check(served["server"], "logits")
    logits_int8_check(served8["server"])
    served_launches, int8_launches = served["launches"], served8["launches"]
    del served, served8
    gc.collect()
    torch.cuda.empty_cache()

    hybrid = serve_phase(HYBRID, ("flash_attention", "paged_attention", "ssd_scan"),
                         "serve-hybrid")
    profile_decode(hybrid["server"], "profile-hybrid")
    logits_check(hybrid["server"], "logits-hybrid")
    del hybrid["server"]
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    des = des_phase(dev, flush)
    del flush

    # The JSON line carries each kernel at its path's shapes: the largest
    # prompt bucket of yi-6b (L=256) and zamba2's longest short-pool prompt
    # (L=256), the short pool's decode at each model's widths (and int8
    # pages), zamba2's SSD scan at L=256, the Table-2 fleet's stacked slot
    # arrays. Launches are each path's count.
    def entry(name, source, replaces, path, launches, row, shape):
        return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
                    replaces=replaces, path=path, shape=shape, launches=launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row.get("library_ms"))

    flash_src, paged_src = "flash_attention.cu", "paged_attention.cu"
    flash_rep = "src/repro/kernels/flash_attention.py:96"
    paged_rep = "src/repro/kernels/paged_attention.py:96"
    h_launch = hybrid["launches"]
    kernels = [
        entry("flash_attention", flash_src, flash_rep, f"serve {DENSE}",
              served_launches["flash_attention"], flash_rows[256], "H=32 K=4 D=128 L=256"),
        entry("flash_attention_d80", flash_src, flash_rep, f"serve {HYBRID}",
              h_launch["flash_attention"], flash80[256], "H=32 K=32 D=80 L=256"),
        entry("paged_attention", paged_src, paged_rep, f"serve {DENSE}",
              served_launches["paged_attention"], paged_rows["short"],
              "8 slots x 512, H=32 K=4 D=128, bf16 pages"),
        entry("paged_attention_d80", paged_src, paged_rep, f"serve {HYBRID}",
              h_launch["paged_attention"], paged80["short"],
              "8 slots x 512, H=32 K=32 D=80, bf16 pages"),
        entry("paged_attention_int8", paged_src, "src/repro/kernels/paged_attention.py:69",
              f"serve {DENSE} kv_dtype=int8", int8_launches["paged_attention"],
              paged8["short"], "8 slots x 512, H=32 K=4 D=128, int8 pages, f16 scales"),
        entry("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:91", f"serve {HYBRID}",
              h_launch["ssd_scan"], ssd_rows[256], "B=1 H=80 P=64 N=64 L=256"),
        entry("sim_decode", "sim_decode.cu", "src/repro/kernels/sim_decode.py:243",
              "DES routed Table-2 fleet", des["launches"], des["kernel"],
              f"(P, I, S) = {des['kernel']['shape']}"),
    ]
    kernels[4]["dequant_ms"] = paged8["short"]["dequant_ms"]
    for k, row in zip(kernels[:5], (flash_rows[256], flash80[256], paged_rows["short"],
                                    paged80["short"], paged8["short"])):
        k.update({key: row[key] for key in ("variant", "splits") if key in row})
    print("[prior] the earlier design's ms at these shapes (PERF.md's table, not measured "
          "in this run): " + ", ".join(f"{k} {v}" for k, v in PRIOR_MS.items()))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
