"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and nvcc:

1. builds every CUDA kernel of the port from ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, all at once), prints the build time and
   each library's counts of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)
   instructions in its SASS (``cuobjdump``); the flash library must have
   HGMMA, the SSD scan's library one of the two. Then reads ``time_ms``'s own
   floor (a one-element fill under the same flush, sleep and events);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving paths give it (bf16; yi-6b's head_dim 128, zamba2's
   80, yi-6b's int8 pages with f16 scales; zamba2's SSD scan at its prompt
   lengths, a ragged one included) and at the long-pool shapes (flash at
   yi-6b L=4096, paged at 2 slots x 65,536), with the tolerance, flash's
   variant and paged's split count printed, and times the kernel, the
   plain version and, where one exists, one PyTorch call computing the same
   function as a yardstick (the port never calls it);
2b. the flash kernel's backward (``[flash-bwd]``): the forward's
   log-sum-exp and ``csrc/flash_attention_bwd.cu`` against their plain
   versions at yi-6b's heads (B 2, L 1024 and 2048), qwen3's G 16, zamba2's
   D 80, musicgen's non-causal 200 x 256 and one f32 shape; two launches
   bit for bit; the kernel, the plain backward and SDPA's backward timed
   (the library must have HMMA). Then training (``[train]``): 12 AdamW
   steps of yi-6b at full width with 8 of its 32 layers (B 2 x L 2048,
   every layer rematerialized), the losses finite and falling, exactly two
   flash forwards and one tensor-core backward a layer and step (counters
   set to 0 just before, read just after), step time, tokens/s, peak
   memory and one profiled step's kernels and busy share;
   ``[train-grad]``: the loss and every gradient leaf at 2 layers against
   autograd through the plain attention; ``[train-restart]``:
   ``launch.train.train`` on reduced yi-6b with an injected failure,
   resumed at its checkpoint;
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
5b. the MoE family at full width, depth cut (``MOE_LAYERS``; the cut and
   the weights' bytes printed): qwen3-235b-a22b (4 of 94 layers, 128
   experts top-8, GQA group 16) serves the same 16-request draw through the
   two pools at the default ``moe_group`` (``[serve-moe]``, flash and paged
   must run), is profiled as above with the host syncs inside one decode
   step counted, which must be 0 (``[profile-moe]``), and its decode-step
   logits are held against a forward at ``moe_group=1``
   (``[logits-moe]``); llama4-scout (2 of 48 layers, 16 experts top-1 and
   a shared one, GQA group 5) prefills 8 slots and decodes ``SCOUT_STEPS``
   steps, each slot's logits held against a forward (``[moe-scout]``). The
   kernel phase (2) adds flash and paged at both head layouts (paged at
   qwen3's on both pools, scout's on the short pool it decodes in);
5c. the rest of the model stack at full width and depth, random bf16
   weights from seed 0: xlstm-350m (21 mLSTM and 3 sLSTM blocks, an f32
   state of 88 MB a slot and no KV cache) serves the same 16-request draw
   through the two pools (``[serve-xlstm]``; its path runs none of the
   port's kernels, and a served prompt must be longer than 128 and not a
   multiple of it, which the reference's mLSTM refuses), is profiled as
   above with 0 host syncs required inside the decode step
   (``[profile-xlstm]``), and its decode-step logits are held against a
   forward with the mLSTM's ``w_q``/``w_k`` and the sLSTM's gate
   projections tempered (``[logits-xlstm]``); qwen2-vl-7b (``[vlm]``: M-RoPE
   over a 16-wide patch grid, GQA group 7) and musicgen-medium (``[audio]``:
   a 256-position conditioning memory, cross-attention, four codebook
   heads), which take embeddings and so are not served by the engine,
   prefill two sequences (256 and 200 positions) into the port's
   ``SlotKVCache`` and decode 8 steps, the launch counters set to 0 just
   before and read just after (flash and paged must run), every step's
   logits held against a forward. The kernel phase (2) adds flash and
   paged at these layouts: G 7, D 64 causal, D 64 non-causal with 200
   queries against 256 keys, and the cross cache with every position valid;
6. the fleet DES (``FleetSim(backend="torch", device="cuda")``) on the
   paper's Table-2 fleet: an Azure trace at 1,000 req/s (seed 0),
   B_short 8192, the A100/Llama-3-70B timing model, short pool c_max 8192
   and long pool c_max 65,536 sized by ``plan_fleet``, spillover off. It
   holds the ``sim_decode`` kernel against its plain version bit for bit at
   that fleet's stacked shapes (idle rows, ``t_limit = inf``, truncation at
   c_max, KV growth past the free blocks) and times both; runs the routed
   fleet (10,000 requests) and the homogeneous fleet (2,000) through the
   kernel (its launch counter set to 0 just before each run and read just
   after; it must be > 0); and runs the 2,000-request routed trace on the
   card and on the CPU, whose records
   and loop counters must be equal bit for bit; and profiles a short
   routed run (device busy share, kernels per round). The kernel takes the
   grid's lane axis; a single run is one lane, ``(G, P, I, S) = (1, 2, 224,
   128)``;
7. the batched grid (``run_fleet_grid(device="cuda")``, ``[grid]`` lines):
   the DES half of Figure 6 as ``benchmarks/fig6_sensitivity.py::run_des``
   runs it (Azure and LMSYS, 2,000 requests at 20 req/s, thresholds 2048 to
   32,768, short pool c_max 32,768 x 2, long pool 65,536 x 1), with goodput,
   TTFT p99 and the short fraction per lane; the Azure grid at 1,000
   requests on the card and on the CPU, whose records and loop counts must
   be equal bit for bit; the ``sim_decode`` kernel against its plain version
   at the 16-lane Table-2 shape, a time limit a lane and one at +inf; and
   the walls of threshold ladders of 1, 4 and 16 lanes (512 to 8192) and of
   the single-lane ``FleetSim`` on one 2,000-request Table-2 trace, each with
   its loop counts, host syncs, lanes a second and the device's busy share
   (read on a 250-request trace, plain and under the profiler). Every run's
   ``sim_decode`` counter is set to 0 just before it and read just after:
   one launch a round;
7b. windowed telemetry on the card (``[telemetry]`` lines): the routed
   Table-2 fleet of phase 6 (10,000 requests) again with
   ``TelemetryConfig(window=512, events=False)``; it prints every sample
   (queue depth, active slots and KV share per pool), the wall, iters,
   rounds, host syncs and ``sim_decode`` launches (counter set to 0 just
   before, > 0 required); its records must equal phase 6's routed run bit
   for bit with the same iters, rounds and host syncs, its export must pass
   ``validate_telemetry`` and its windowed deltas sum to the run's
   counters. Then the same fleet with its short pool cut to 20 % and an
   ``AdaptiveController`` over windows of 100 requests, on 2,000 requests
   on the card and on the CPU: every telemetry column, the controller's
   history and the loop counts must be equal;
7c. the paper's tables from the port's own scripts (``[tables]`` lines):
   ``benchmarks/port_table1_pools.py``, ``port_table2_cost.py``,
   ``port_table4_calibration.py``, ``port_table5_mi300x.py`` and
   ``port_cost_model_gap.py`` on the host, ``port_table3_latency.py`` at
   its default 1/5 scale on the card (``sim_decode`` counter set to 0 just
   before, > 0 required); Table 2's Azure instance counts (72 + 232
   against 364 on the table's seed-42 trace; 72 + 224 against 355 on
   phase 6's seed-0 trace) and both of Table 3's fleets meeting
   ``PAPER_SLO`` are checked;
8. prints the earlier design's times at the JSON line's shapes on a line
   of their own (``[prior]``, copied from PERF.md, not measured here), the
   kernels' JSON line (each entry carries the timing floor; flash and paged
   entries their variant or split count, the SSD scan its P split and CTA
   count; flash and paged also at the MoE family's head layouts, ``_g16``
   on the qwen3 serve's path, ``_g5`` on the scout run's; ``_g7`` on the
   qwen2-vl run's, ``_d64`` and ``_cross`` on the musicgen run's;
   ``sim_decode_telemetry`` with the telemetry run's launches;
   ``flash_attention_bwd`` with the ``[train]`` run's launches), the card's name
   and power limit, and last
   ``{"ok": true, "device": {...}}``.

Each phase ends with a ``[time]`` line, the seconds since the script
started. Any failed phase raises, so the script exits non-zero and prints no result;
so does a machine without a GPU, and a directory without the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.adaptive import AdaptiveController  # noqa: E402
from repro_torch.core.cost_model import closed_form_savings  # noqa: E402
from repro_torch.core.pools import (  # noqa: E402
    PoolConfig,
    homogeneous_pool,
    n_seq_for_cmax,
)
from repro_torch.distributed.fault import SimulatedFailure  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward_variant,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
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
from repro_torch.kernels.ssd_scan import P_TILE, ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.launch.serve import run_workload, serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import quantize_kv  # noqa: E402
from repro_torch.obs import TelemetryConfig, validate_telemetry  # noqa: E402
from repro_torch.obs.validate import check_window_deltas  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ServeRequest,
    ServingEngine,
    SlotKVCache,
    TwoPoolServer,
)
from repro_torch.sim import (  # noqa: E402
    A100_LLAMA3_70B,
    PAPER_SLO,
    FleetSim,
    plan_fleet,
    run_fleet_grid,
)
from repro_torch.sim import torch_engine  # noqa: E402
from repro_torch.sim.fleet import record_columns, same_records  # noqa: E402
from repro_torch.traces import TraceSpec, generate_trace_columns  # noqa: E402
from repro_torch.training import (  # noqa: E402
    DataConfig,
    SyntheticLM,
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.training.tree import leaves  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor-core
# rates, the float32 rate outside the tensor cores, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
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
#: The MoE family's configs on the card and the layers each keeps of its
#: published depth (full widths; ``dataclasses.replace(cfg, n_layers=...)``):
#: qwen3-235b-a22b's 4 of 94 take ~22.4 GB in bf16 and serve through the
#: two pools; llama4-scout's 2 of 48, ~12.9 GB, decode 8 slots.
MOE, SCOUT = "qwen3-235b-a22b", "llama4-scout-17b-a16e"
MOE_LAYERS = {MOE: 4, SCOUT: 2}
#: Decode steps of the scout run (after the 8 slots' prefills).
SCOUT_STEPS = 16
#: The xLSTM (O(1) decode state, no KV cache), served at full width and
#: depth; the vlm and audio stacks (embeddings frontend), which the engine
#: does not serve, run prefill and decode through the port's slot cache.
XLSTM, VLM, AUDIO = "xlstm-350m", "qwen2-vl-7b", "musicgen-medium"
#: ``[vlm]`` / ``[audio]``: sequences, prompt length and decode steps.
EMBED_RUN = {VLM: dict(seqs=2, prompt=256, steps=8), AUDIO: dict(seqs=2, prompt=200, steps=8)}
SERVE = dict(
    requests=16, short_cmax=512, long_cmax=2048,
    short_slots=8, long_slots=2, seed=0, full_width=True,
)
#: Launch counters, by the name the JSON line gives each kernel's wrapper.
COUNTERS = {"flash_attention": flash_attention, "paged_attention": paged_attention,
            "ssd_scan": ssd_scan}
#: Kernels per decode step (8 busy slots) that the profiled steps may not
#: exceed: the counts the served paths had before the attention kernels
#: were redesigned (the split combines inside the paged launch); the MoE
#: path's and the xLSTM's are their first readings on the card
#: (qwen3-235b-a22b, 4 layers; xlstm-350m, 24 blocks).
MAX_KERNELS_PER_STEP = {"profile": 1665, "profile-int8": 2081, "profile-hybrid": 3910,
                        "profile-moe": 426, "profile-xlstm": 1304}
#: Profiles whose decode step must make no host sync (the MoE routing reads
#: no per-expert count on the host; the xLSTM writes its state in place).
SYNC_FREE_PROFILES = ("profile-moe", "profile-xlstm")
#: The earlier design's device times (ms) at the JSON line's shapes, read
#: on the same card model (NVIDIA H100 80GB HBM3, 700 W; PERF.md's table);
#: printed on their own line, never in the kernels' JSON line.
PRIOR_MS = {"flash_attention": 0.1287, "flash_attention_d80": 0.0835,
            "paged_attention": 0.0677, "paged_attention_d80": 0.0334,
            "paged_attention_int8": 0.0626, "ssd_scan": 0.0695, "sim_decode": 0.0108}
#: The paged rows: (name, slots, c_max); the long-pool row runs at yi-6b's
#: widths only (bf16 and int8 pages).
POOLS = (("short", 8, 512), ("long", 2, 2048))
LONG_POOL = ("long64k", 2, 65_536)

# The paper's Table 2 fleet (1,000 req/s, B_short = 8192) on the DES.
# ``requests`` is the routed run's trace length, ``cross`` the
# CUDA-against-CPU trace's and the homogeneous run's (the shorter trace
# keeps the whole script, grid phase included, near 750 s), ``profile`` the
# profiled run's.
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
# The batched grid (``run_fleet_grid``). ``fig6``: the DES half of the
# paper's Figure 6 as ``benchmarks/fig6_sensitivity.py::run_des`` runs it
# (short pool c_max 32,768 x 2 instances, long pool 65,536 x 1); ``cross``
# the Azure grid's length for the card-against-CPU check. ``ladders``: the
# threshold ladders run on the Table-2 fleet over ``requests`` requests,
# each lane count's thresholds in even steps from 512 to 8192; each run's
# device busy share is read on a ``profile``-request trace of the same spec
# (the profiler's own reading takes ~65 ms a round here, so a full run's
# would cost minutes).
GRID = dict(fig6_requests=2000, fig6_rate=20.0, fig6_seed=42,
            fig6_thresholds=(2048, 4096, 8192, 16_384, 32_768), cross=1000,
            requests=2000, ladders=(1, 4, 16), profile=250)
# Windowed telemetry (``[telemetry]``): the routed Table-2 run of ``[des]``
# with windows of ``window`` dispatched requests; the card-against-CPU
# check on a ``cross``-request trace of the same spec, the short pool cut
# to ``cut`` of its instances so the AIMD controller (windows of
# ``control_window``) moves the boundary.
TELEMETRY = dict(window=512, cross=2000, cut=0.2, control_window=100)
# Table 2's Azure instance counts (short, long, homogeneous): the table's
# own trace (seed 42, ``benchmarks/table2_cost.py``) and the ``[des]``
# trace (seed 0), as the reference's ``plan_fleet`` sizes them.
TABLE2_AZURE = (72, 232, 364)
TABLE2_DES = (72, 224, 355)
# The flash backward's rows (``[flash-bwd]``): (tag, B, H, K, D, Lq, Lk,
# causal, dtype). yi-6b's heads at the training phase's B 2 and L 2048 and
# at L 1024, qwen3's GQA group of 16, zamba2's D 80 MHA, musicgen's D 64
# cross-attention (200 queries, 256 memory positions, non-causal), and one
# f32 shape (the CUDA-core forward).
FLASH_BWD = (
    ("yi-6b", 2, 32, 4, 128, 1024, 1024, True, torch.bfloat16),
    ("yi-6b", 2, 32, 4, 128, 2048, 2048, True, torch.bfloat16),
    ("qwen3-235b-a22b", 1, 64, 4, 128, 1024, 1024, True, torch.bfloat16),
    ("zamba2-2.7b", 1, 32, 32, 80, 256, 256, True, torch.bfloat16),
    ("musicgen-medium", 2, 24, 24, 64, 200, 256, False, torch.bfloat16),
    ("f32", 1, 8, 2, 64, 512, 512, True, torch.float32),
)
# The forward's log-sum-exp against the plain version's (f32 both; the
# kernel sums exp2 of scaled scores in another order).
LSE_TOL = 1e-4
# The f32 backward row: the kernel and the plain version sum the same f32
# products in other orders (relative to the largest gradient).
F32_GRAD_TOL = 2e-5
# ``[train]``: yi-6b at full width, ``layers`` of its 32 (through
# ``dataclasses.replace``, as the MoE phases cut depth), B x L tokens from
# ``SyntheticLM``, AdamW at ``peak_lr`` with the launcher's warm-up, every
# layer rematerialized. ``[train-grad]``: the same widths at ``grad_layers``
# layers and ``grad_batch`` x ``grad_seq``; ``[train-restart]``: the
# launcher on reduced yi-6b.
TRAIN = dict(layers=8, batch=2, seq=2048, steps=12, peak_lr=1e-3, remat="full",
             grad_layers=2, grad_batch=1, grad_seq=1024,
             restart=dict(steps=8, seq_len=128, global_batch=4, ckpt_every=2, fail_at=5))
# Loss and every gradient leaf of the kernels' path against autograd through
# the plain attention, both bf16 (relative L2 a leaf): the two round P, dS
# and the outputs at different points, and every bf16 rounding is 2**-8
# relative; two layers keep that within a percent or two.
GRAD_REL_TOL = 2e-2


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


def timing_floor(dev, flush: torch.Tensor) -> float:
    """``time_ms``'s own floor: the reading for a launch that does almost
    nothing (a one-element fill) under the same flush, sleep and events."""
    one = torch.empty(1, device=dev)
    floor = time_ms(lambda: one.fill_(1.0), flush=flush)
    print(f"[timing] floor {floor:.4f} ms (a one-element fill under time_ms)", flush=True)
    return floor


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


def flash_cross_phase(dev, flush, *, heads: tuple[int, int, int], lq: int, lk: int,
                      tag: str) -> dict:
    """Full (non-causal) attention of ``lq`` queries against ``lk`` keys:
    the cross-attention's prefill call, bf16."""
    gen = torch.Generator(device=dev).manual_seed(4)
    H, K, D = heads
    q = torch.randn(1, H, lq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(1, K, lk, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(1, K, lk, D, generator=gen, device=dev).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    err, ulps = check_close(out, flash_attention_plain(q, k, v, causal=False),
                            f"flash {tag} Lq={lq} Lk={lk}")
    nbytes = 2 * (2 * H * lq * D + 2 * K * lk * D)
    bnd, by = bound_ms(nbytes, 4 * H * D * lq * lk)
    row = dict(
        L=lq, lk=lk, max_abs_err=err, variant=flash_mod.variant(D, q.dtype),
        ms=time_ms(lambda: flash_attention(q, k, v, causal=False), flush=flush),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, causal=False), flush=flush),
        library_ms=time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, enable_gqa=True),
            flush=flush),
        bound_ms=bnd, bound_by=by,
    )
    print(f"[flash] {tag} H={H} K={K} D={D} Lq={lq} Lk={lk} non-causal variant "
          f"{row['variant']} err {err:.3g} (tol {KERNEL_TOL}), worst row {ulps:.3g} ulps (tol "
          f"{ROW_ULPS}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa "
          f"{row['library_ms']:.4f} ms bound {bnd:.4f} ms ({by})", flush=True)
    return row


def paged_phase(dev, flush, *, heads: tuple[int, int, int], tag: str, int8: bool = False,
                pools: tuple = POOLS, full: bool = False) -> dict:
    """Decode over one layer's slot cache viewed as 16-token pages, at the
    serving pools' shapes (short: 8 slots x 512, long: 2 slots x 2048, and
    where asked the paper's long pool, 2 x 65,536), ragged lengths, plus a
    poison check of the pages past each length. With ``full`` every
    position of every slot is valid (a cross-attention cache).
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
        if full:
            lengths.fill_(c_max)
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
    ragged length. The bound counts the function's fewest FLOPs at the TF32
    tensor-core rate over the kernel's three passes (its f32 products are
    split in three TF32 ones), beside the f32 CUDA-core bound the first
    design had."""
    cfg = get_config(HYBRID)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(3)
    splits = -(-P // P_TILE)
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
        flops = H * ssd_min_flops(L, P, N)
        bnd, by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS / 3)
        f32_bnd, f32_by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        row = dict(
            L=L, max_abs_err=err,
            ms=time_ms(lambda: ssd_scan(x, log_a, bm, cm), flush=flush),
            plain_ms=time_ms(lambda: ssd_scan_plain(x, log_a, bm, cm), flush=flush),
            bound_ms=bnd, bound_by=by, library_ms=None, p_split=splits, ctas=H * splits,
        )
        rows[L] = row
        print(f"[ssd_scan] B=1 H={H} P={P} N={N} L={L} P split {splits} x {P_TILE} columns, "
              f"{H * splits} CTAs: max |kernel - plain| {err:.3g} (tol {SSD_ATOL} + "
              f"{SSD_RTOL}*|plain|); kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"bound {bnd:.4f} ms ({by}; 3xTF32 at {PEAK_TF32_FLOPS / 3e12:.0f} TFLOP/s), "
              f"f32 CUDA-core bound {f32_bnd:.4f} ms ({f32_by}); no single PyTorch call "
              f"computes this scan", flush=True)
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
    from torch.profiler import ProfilerActivity, profile, schedule

    model, params = srv.short_engine.model, srv.short_engine.params
    eng = ServingEngine(model, params, c_max=SERVE["short_cmax"], n_slots=SERVE["short_slots"])
    rng = np.random.default_rng(2)
    for i in range(SERVE["short_slots"]):
        prompt = [int(t) for t in rng.integers(0, model.cfg.vocab, 200)]
        eng.submit(ServeRequest(i, prompt, max_new_tokens=steps + 8))
    for _ in range(3):  # admission + prefill, then warm decode steps
        eng.step()
    torch.cuda.synchronize()
    # The device trace can lose a few kernels, mostly at the start of the
    # first profiled step, so a count may read low and never high; one
    # warm-up step under the profiler before the counted ones makes that
    # rarer. The schedule marks each step on the device as "ProfilerStep#",
    # which is no kernel.
    traced = []  # the counted steps' events, handed over when the trace ends
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: traced.extend(p.key_averages())) as prof:
        eng.step()
        prof.step()
        t0 = time.perf_counter()
        for k in range(steps):
            eng.step()  # ends on the sampled tokens' copy to the host
            if k == steps - 1:  # before the last prof.step(), which ends the trace
                wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    kernels = [
        e for e in traced
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not e.key.startswith("ProfilerStep")
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out = dict(
        step_ms=wall_ms / steps, busy_share=busy_ms / wall_ms,
        top=[(e.key[:60], e.count // steps, e.self_device_time_total / 1e3 / steps) for e in top],
    )
    out["kernels_per_step"] = sum(e.count for e in kernels) / steps
    out["host_syncs"] = decode_syncs(eng)
    print(f"[{tag}] short pool, 8 busy slots: {out['step_ms']:.3f} ms per decode step, "
          f"device busy {100 * out['busy_share']:.1f}% of the wall, "
          f"{out['kernels_per_step']:.1f} kernels per step (at most {MAX_KERNELS_PER_STEP[tag]}), "
          f"{out['host_syncs']} host syncs inside the model's decode step")
    for key, n, ms in out["top"]:
        print(f"[{tag}]   {ms:8.4f} ms/step  {n:4d}/step  {key}")
    if out["kernels_per_step"] > MAX_KERNELS_PER_STEP[tag]:
        fail(f"{tag}: {out['kernels_per_step']:.1f} kernels per decode step, more than "
             f"{MAX_KERNELS_PER_STEP[tag]}")
    if tag in SYNC_FREE_PROFILES and out["host_syncs"]:
        fail(f"{tag}: {out['host_syncs']} host syncs inside one decode step")
    return out


def decode_syncs(eng) -> int:
    """Host syncs inside one call of the model's decode step on ``eng``'s
    slots, as torch's sync debug mode reports them (the engine's own read
    of the sampled tokens, and its copy of the token and index buffers to
    the card, are outside the call). The first call of a process reads one
    sync inside torch's own ``torch/cuda/__init__.py`` that a second call
    does not, so the step is run twice and the second call counted. Each
    call rewrites each slot's K/V at the position the engine writes next."""
    batch = {"tokens": torch.from_numpy(eng._token_buf[:, None]).to(eng.device),
             "index": torch.from_numpy(eng._index_buf).to(eng.device)}
    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.model.decode_step(eng.params, eng.cache.state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts.append([f"{Path(w.filename).name}:{w.lineno}" for w in caught
                       if "synchroniz" in str(w.message)])
    print(f"[syncs] host syncs inside the decode step, first and second call: {counts}")
    return len(counts[1])


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


TEMPERED = ("w_q", "w_k", "cross_w_q", "cross_w_k")
SLSTM_GATES = ("w_z", "w_i", "w_f", "w_o")


def temper_attention(params: dict, keys: tuple = TEMPERED) -> None:
    """Scales every ``w_q`` and ``w_k`` in the tree by 0.1, in place (the
    dense layers, the MoE family's dense and MoE blocks, the hybrid's shared
    attention blocks, musicgen's cross-attention, the xLSTM's mLSTM blocks),
    and the xLSTM's sLSTM gate projections: the reference's fan-in rule
    makes an sLSTM's gate preactivations (std ~16 at xlstm-350m's widths)
    and an mLSTM's q·k as large as it makes attention's scores, and its
    exponential gates and the mLSTM's normalizer, a signed sum near 0, turn
    a bf16 rounding into a different state (a decode step 0.30 rel L2 off a
    forward at full width untempered, 7e-5 in f32; the port on the CPU)."""
    for key, val in params.items():
        if isinstance(val, dict):
            temper_attention(val, keys + SLSTM_GATES if key == "slstm" else keys)
        elif key in keys:
            val.mul_(0.1)


def logits_check(srv, tag: str, model=None) -> float:
    """Decode-step logits against a full forward recompute, full width.

    With the reference's init (q/k projections scaled by the head count, so
    attention scores have a std near 100 at yi-6b widths and softmax is an
    arg-max) the two paths' different bf16 roundings pick different keys
    and the logits decorrelate; that reading is printed, not held. The held
    reading scales w_q and w_k by 0.1 (in place, after serving), which
    leaves the attention soft, so the paths differ by bf16 rounding only.
    ``model`` (the served one if None) runs both paths: the MoE family's at
    ``moe_group=1``, where prefill and forward route each token alone as
    decode does, so no capacity drop tells the paths apart.
    """
    params = srv.short_engine.params
    model = model or srv.short_engine.model
    raw = decode_vs_forward(model, params)
    print(f"[{tag}] reference init (not held): {raw}")
    temper_attention(params)
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


def moe_model(arch: str, tag: str, **kw) -> Model:
    """``Model(cfg, **kw)`` of a MoE config at its published widths with its
    depth cut to ``MOE_LAYERS``; prints the cut and the weights' bytes."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS[arch])
    model = Model(cfg, **kw)
    print(f"[{tag}] {arch}: n_layers cut {full.n_layers} -> {cfg.n_layers} (widths as "
          f"published: d_model {cfg.d_model}, H {cfg.n_heads} K {cfg.n_kv_heads} D "
          f"{cfg.head_dim}, {cfg.n_experts} experts of {cfg.moe_d_ff} top-{cfg.top_k}, "
          f"{cfg.n_shared_experts} shared, padded vocab {cfg.padded_vocab}); "
          f"{model.param_bytes() / 1e9:.2f} GB of bf16 weights, "
          f"{model.active_param_count() / 1e9:.3f} B of {model.param_count() / 1e9:.3f} B "
          f"parameters active a token", flush=True)
    return model


def serve_moe_phase(dev) -> dict:
    """qwen3-235b-a22b at full width, its depth cut, through the two pools
    on the 16-request draw, greedy, at the default ``moe_group``."""
    model = moe_model(MOE, "serve-moe")
    params = model.init(0, device=dev)
    srv = TwoPoolServer(model, params, short_cmax=SERVE["short_cmax"],
                        long_cmax=SERVE["long_cmax"], short_slots=SERVE["short_slots"],
                        long_slots=SERVE["long_slots"])
    reset_counters()
    result = run_workload(srv, requests=SERVE["requests"], seed=SERVE["seed"])
    return check_served(result, MOE, ("flash_attention", "paged_attention"), "serve-moe")


def scout_phase(dev) -> dict:
    """llama4-scout at full width, its depth cut, w_q/w_k tempered as
    ``logits_check`` does: 8 slots' prefills (prompts of 100 to 240 tokens)
    and ``SCOUT_STEPS`` decode steps, the launch counters set to 0 just
    before and read just after (flash and paged must run), then each slot's
    last decode-step logits against a forward over its context, the model at
    ``moe_group=1`` throughout."""
    model = moe_model(SCOUT, "moe-scout", moe_group=1)
    cfg = model.cfg
    params = model.init(0, device=dev)
    temper_attention(params)
    slots = SERVE["short_slots"]
    eng = ServingEngine(model, params, c_max=SERVE["short_cmax"], n_slots=slots)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, 100 + 20 * i)] for i in range(slots)]
    for i, prompt in enumerate(prompts):
        eng.submit(ServeRequest(i, prompt, max_new_tokens=SCOUT_STEPS + 2))  # all stay busy
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SCOUT_STEPS):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: COUNTERS[name].launches for name in ("flash_attention", "paged_attention")}
    launches["flash_attention_tc"] = flash_attention.launches_tc
    print(f"[moe-scout] {slots} prefills and {eng.iterations} decode steps of {slots} slots in "
          f"{wall:.3f} s; kernel launches: {launches}", flush=True)
    if eng.iterations != SCOUT_STEPS or any(n == 0 for n in launches.values()):
        fail(f"moe-scout: {eng.iterations} decode steps, launches {launches}")
    worst = 0.0
    for slot, st in sorted(eng.slots.items()):
        ctx = st.request.tokens + st.generated[:-1]
        ref, _ = model.forward(params, {"tokens": torch.tensor([ctx], device=dev)})
        got, ref = eng.last_logits[slot].float(), ref[0, -1].float()
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            fail(f"moe-scout: slot {slot}: non-finite logits")
        rel = ((got - ref).norm() / ref.norm()).item()
        worst = max(worst, rel)
        print(f"[moe-scout] slot {slot}: {len(ctx)} positions, decode step vs forward rel L2 "
              f"{rel:.4g}, argmax {int(got.argmax())} / {int(ref.argmax())}")
    print(f"[moe-scout] worst rel L2 {worst:.4g} (tol {LOGITS_REL_TOL})", flush=True)
    if not worst <= LOGITS_REL_TOL:
        fail(f"moe-scout: decode logits differ from forward: rel L2 {worst} > {LOGITS_REL_TOL}")
    return dict(launches=launches, rel_l2=worst, wall_s=wall)


def serve_xlstm_phase() -> dict:
    """xlstm-350m at full width and depth through the two pools on the
    16-request draw, greedy. Its path runs no kernel of the port (no
    attention); the gates are check_served's, and that a prompt longer than
    128 that 128 does not divide was served (the reference's mLSTM refuses
    those; the port pads its last chunk)."""
    reset_counters()
    result = serve(XLSTM, **SERVE, device="cuda")
    out = check_served(result, XLSTM, (), "serve-xlstm")
    ragged = [r.prompt_tokens for r in result["responses"]
              if r.prompt_tokens > 128 and r.prompt_tokens % 128]
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    print(f"[serve-xlstm] prompts longer than 128 that 128 does not divide: {ragged}; "
          f"state a slot {state_bytes(out['server']) / 1e6:.1f} MB; launches of the port's "
          f"kernels (none on this path): {launches}", flush=True)
    if not ragged:
        fail("serve-xlstm: no served prompt longer than 128 that 128 does not divide")
    return out


def state_bytes(srv) -> float:
    """Bytes of one slot's xLSTM decode state in the short pool's cache."""
    eng = srv.short_engine
    leaves = (*eng.cache.state["mlstm"], *eng.cache.state["slstm"])
    return sum(t.numel() * t.element_size() for t in leaves) / eng.n_slots


def embed_phase(dev, arch: str, tag: str) -> dict:
    """A model of the embeddings frontend at full width and depth, bf16,
    random weights from seed 0 with w_q/w_k (and cross_w_q/cross_w_k)
    tempered as ``logits_check`` does: ``seqs`` sequences of ``prompt``
    seeded embeddings (std 0.1, as the reference's ``make_batch``) each
    prefilled and copied into a slot of the port's ``SlotKVCache``, then
    ``steps`` decode steps of all slots, the launch counters set to 0 just
    before and read just after (flash and paged must run); each step's
    logits against a forward over the same embeddings. qwen2-vl's M-RoPE
    positions: the prompt as a 16-wide patch grid (temporal = index, height
    = index // 16, width = index % 16), then text at index on all three
    streams; musicgen's memory: 256 seeded conditioning embeddings."""
    run = EMBED_RUN[arch]
    seqs, n, steps = run["seqs"], run["prompt"], run["steps"]
    model = Model(get_config(arch))
    cfg = model.cfg
    params = model.init(0, device=dev)
    temper_attention(params)
    print(f"[{tag}] {arch}: full width and depth ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, H {cfg.n_heads} K {cfg.n_kv_heads} D {cfg.head_dim}); "
          f"{model.param_bytes() / 1e9:.2f} GB of bf16 weights", flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    total = n + steps
    embeds = (torch.randn(seqs, total, cfg.d_model, generator=gen, device=dev) * 0.1).bfloat16()
    extra = {}
    if cfg.pos_type == "mrope":
        idx = torch.arange(total, device=dev)
        grid = torch.stack([idx, idx // 16, idx % 16])
        grid[:, n:] = idx[n:]  # text after the patch grid
        extra["positions"] = grid[:, None].expand(3, seqs, total).to(torch.int32)
    if cfg.cross_attention:
        extra["memory"] = (torch.randn(seqs, cfg.cross_mem_len, cfg.d_model, generator=gen,
                                       device=dev) * 0.1).bfloat16()

    def part(b: slice, cols: slice) -> dict:
        out = {"embeds": embeds[b, cols]}
        if "positions" in extra:
            out["positions"] = extra["positions"][:, b, cols]
        if "memory" in extra:
            out["memory"] = extra["memory"][b]
        return out

    cache = SlotKVCache(model, SERVE["short_cmax"], seqs, device=dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(seqs):
        _, state = model.prefill(params, part(slice(i, i + 1), slice(0, n)))
        cache.insert_prefill(i, state)
    got = []
    for t in range(n, total):
        step = part(slice(None), slice(t, t + 1))
        step.pop("memory", None)  # decode reads the cross cache
        step["index"] = torch.full((seqs,), t, dtype=torch.int32, device=dev)
        logits, _ = model.decode_step(params, cache.state, step)
        got.append(logits.float())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: COUNTERS[name].launches for name in ("flash_attention", "paged_attention")}
    launches["flash_attention_tc"] = flash_attention.launches_tc
    print(f"[{tag}] {seqs} prefills of {n} positions and {steps} decode steps of {seqs} slots "
          f"in {wall:.3f} s; kernel launches: {launches}", flush=True)
    if any(v == 0 for v in launches.values()):
        fail(f"{tag}: a kernel of the path was never launched: {launches}")
    ref, _ = model.forward(params, part(slice(None), slice(0, total)))
    worst = 0.0
    for j, logits in enumerate(got):
        want = ref[:, n + j].float()
        if not (torch.isfinite(logits).all() and torch.isfinite(want).all()):
            fail(f"{tag}: non-finite logits at decode step {j}")
        if logits.shape != want.shape:
            fail(f"{tag}: decode logits {tuple(logits.shape)} against forward {tuple(want.shape)}")
        for b in range(seqs):
            rel = ((logits[b] - want[b]).norm() / want[b].norm()).item()
            worst = max(worst, rel)
    print(f"[{tag}] logits {tuple(got[0].shape)} a step; worst decode step vs forward rel L2 "
          f"{worst:.4g} over {steps} steps x {seqs} slots (tol {LOGITS_REL_TOL}); last step "
          f"argmax {got[-1].argmax(-1).tolist()} / {ref[:, -1].argmax(-1).tolist()}", flush=True)
    if not worst <= LOGITS_REL_TOL:
        fail(f"{tag}: decode logits differ from forward: rel L2 {worst} > {LOGITS_REL_TOL}")
    return dict(launches=launches, rel_l2=worst, wall_s=wall)


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


def sim_decode_phase(dev, flush, shape: tuple[int, int, int, int], c_max: list[int],
                     t_limits: list) -> dict:
    """The kernel against its plain version on the card, bit for bit on all
    ten outputs, at a stacked ``(G, P, I, S)`` shape: the routed fleet's
    (one lane) or the grid's; each of ``t_limits`` is one draw's time
    limit (None: the default, a different one a lane; a list: one a lane).
    Both timed on the first state."""
    G, P, I, S = shape
    row = {}
    for seed, t_limit in enumerate(t_limits):
        st = random_state(seed, c_max, I, S, t_limit=t_limit, lanes=G, device=dev)
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
                fail(f"sim_decode {shape} seed {seed}: output {k} differs from the plain version")
            if a.dtype == torch.float64:
                err = max(err, (a - b).nan_to_num(0.0).abs().max().item())
        idle = int((~st["busy"] & (st["nact"] > 0)).sum())
        over = int((st["busy"] & (st["free"] == 0) & (got["k"] == 1)).sum())
        trunc = int(got["trunc_new"].sum())
        if not (idle and over and trunc):
            fail(f"sim_decode {shape} seed {seed}: state lacks idle ({idle}), overflow ({over}) "
                 f"or truncating ({trunc}) rows")
        limits = ", ".join(f"{x:.3f}" for x in st["t_limit"].tolist())
        print(f"[sim_decode] (G, P, I, S) = {shape} seed {seed} t_limit ({limits}): 10 "
              f"outputs bit-identical to the plain version; idle rows {idle}, overflow rows "
              f"{over}, truncations {trunc}", flush=True)
        if not row:
            slots, rows = G * P * I * S, G * P * I
            nbytes = (slots * sum(SIM_DECODE_SLOT_BYTES) + rows * sum(SIM_DECODE_ROW_BYTES)
                      + 8 * G + 4 * P)
            bnd, by = bound_ms(nbytes, slots * SIM_DECODE_SLOT_OPS, PEAK_F32_FLOPS)
            row = dict(
                shape=shape, max_abs_err=err,
                ms=time_ms(lambda: decode_advance(*args, **kw), flush=flush),
                plain_ms=time_ms(lambda: decode_advance_plain(*args, **kw), flush=flush),
                bound_ms=bnd, bound_by=by,
            )
        row["max_abs_err"] = max(row["max_abs_err"], err)
    print(f"[sim_decode] {shape}: kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); no single PyTorch call "
          f"computes this round", flush=True)
    return row


def run_des(pools, cols, dev, *, label: str, tag: str = "des", **fleet_kw) -> dict:
    """One fleet run through ``backend="torch"`` (``fleet_kw`` go to
    ``FleetSim``: telemetry, a controller); prints what the paper's tables
    read and the loop's counters."""
    sim = FleetSim(pools, A100_LLAMA3_70B, b_short=DES["b_short"], backend="torch",
                   device=dev, spillover=False, **fleet_kw)
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
    print(f"[{tag}] {label} on {dev.type}: {n} requests, {sum(c for _, c in pools.values())} "
          f"instances; completed {s.completed} rejected {s.rejected} preempted "
          f"{res.preemptions} truncated {s.truncated} (of {s.num_requests} after warm-up); "
          f"TTFT p99 {s.ttft_p99:.4f} s TPOT p99 {s.tpot_p99:.4f} s, meets SLO "
          f"{res.meets_slo()}; routing {fractions}; iters {stats['iters']} rounds "
          f"{stats['rounds']} host syncs {stats['host_syncs']}; {wall:.2f} s wall, "
          f"{n / wall:.1f} simulated requests per wall second", flush=True)
    return dict(sim=sim, res=res, stats=stats, wall_s=wall)


def des_phase(dev, flush) -> dict:
    cols, plan, routed, homo = des_setup()
    n_short = routed["short"][0].n_seq
    shape = (1, 2, max(plan.short.instances, plan.long.instances), max(n_short, 16))
    kernel = sim_decode_phase(dev, flush, shape, [DES["b_short"], 65_536],
                              [None, math.inf, None])

    decode_advance.launches = 0
    full = run_des(routed, cols, dev, label="routed Table-2 fleet")
    launches = decode_advance.launches
    print(f"[des] sim_decode launches on the routed run: {launches}", flush=True)
    if launches == 0:
        fail("sim_decode was never launched on the DES path")
    short = generate_trace_columns(TraceSpec(
        trace=DES["trace"], num_requests=DES["cross"], rate=DES["rate"], seed=DES["seed"],
    ))
    decode_advance.launches = 0
    run_des(homo, short, dev, label="homogeneous fleet")
    if decode_advance.launches == 0:
        fail("sim_decode was never launched on the homogeneous run")
    print(f"[des] instances homogeneous {plan.g_homo} vs token-budget {plan.g_dual}: "
          f"savings {plan.savings:.4f}", flush=True)

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
    return dict(kernel=kernel, launches=launches, plan=plan, routed=routed, shape=shape,
                cols=cols, records=record_columns(full["sim"]), stats=full["stats"],
                wall_s=full["wall_s"])


def device_activities(prof) -> dict:
    """A finished profile's device activities (kernels, copies, fills) by
    name: ``(count, device microseconds)``, the sums ``key_averages()``
    gives its CUDA rows. Read from the profiler's raw events: building the
    per-op event tree behind ``key_averages()`` costs the host about 90 us
    an event, minutes on a 1,000-round DES run."""
    out: dict[str, tuple[int, float]] = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA or e.is_async()
                or e.is_user_annotation() or e.duration_ns() <= 0):
            continue
        count, us = out.get(e.name(), (0, 0.0))
        out[e.name()] = (count + 1, us + e.duration_ns() / 1e3)
    if not out:
        fail("the profile holds no device activity")
    return out


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
    kernels = device_activities(prof)
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    wall_ms = run["wall_s"] * 1e3
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    out = dict(
        round_ms=wall_ms / rounds, device_ms_per_round=busy_ms / rounds,
        busy_share=busy_ms / wall_ms,
        kernels_per_round=sum(count for count, _ in kernels.values()) / rounds,
    )
    print(f"[des-profile] {rounds} rounds: {out['round_ms']:.3f} ms of wall and "
          f"{1e3 * out['device_ms_per_round']:.1f} us of device time per round, "
          f"{out['kernels_per_round']:.1f} kernels per round; device busy "
          f"{100 * out['busy_share']:.2f}% of the wall")
    for name, (count, us) in top:
        print(f"[des-profile]   {us / rounds:8.2f} us/round "
              f"{count / rounds:6.2f}/round  {name[:70]}")
    return out


def grid_run(label: str, fn, *, lanes: int, n: int, busy_fn=None) -> dict:
    """One grid (or single-lane) run on the card: its wall, loop counts,
    host syncs and sim_decode launches (the counter set to 0 just before
    and read just after; one launch a round for all lanes). With
    ``busy_fn``, the same call on a shorter trace, run once plain and once
    under torch.profiler, gives the device's busy share: its kernels'
    device time over that plain run's wall."""

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    decode_advance.launches = 0
    out, wall = timed(fn)
    launches = decode_advance.launches
    stats = torch_engine.last_run_stats()
    if launches != stats["rounds"] or launches == 0:
        fail(f"{label}: {launches} sim_decode launches for {stats['rounds']} rounds")
    busy, share = None, "not measured"
    if busy_fn is not None:
        from torch.profiler import ProfilerActivity, profile

        _, short_wall = timed(busy_fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timed(busy_fn)
        busy_ms = sum(us for _, us in device_activities(prof).values()) / 1e3
        busy = busy_ms / (short_wall * 1e3)
        share = f"{100 * busy:.2f}% of the wall ({GRID['profile']}-request run)"
    print(f"[grid] {label}: {lanes} lane(s), {n} requests: {wall:.3f} s wall, iters "
          f"{stats['iters']} rounds {stats['rounds']} host syncs {stats['host_syncs']}, "
          f"{lanes / wall:.3f} lanes a second, device busy {share}", flush=True)
    return dict(out=out, stats=stats, wall_s=wall, busy_share=busy, launches=launches)


def check_grid(grid, n: int, label: str) -> None:
    """Every lane accounts for every request, with finite latencies."""
    if not ((grid.completed + grid.rejected == n).all() and (grid.routed.sum(axis=1) == n).all()):
        fail(f"{label}: completed + rejected or the routing split does not cover {n} requests")
    if not (np.isfinite(grid.ttft_p99).all() and np.isfinite(grid.makespan).all()
            and (grid.completed > 0).all()):
        fail(f"{label}: non-finite metrics or a lane with no completion")


def grid_phase(dev, flush, des: dict) -> dict:
    """``run_fleet_grid`` on the card: the Fig. 6 DES grids, the Azure grid
    on the card against the host CPU, the sim_decode kernel at the 16-lane
    Table-2 shape against its plain version, and the walls of threshold
    ladders of 1, 4 and 16 lanes beside the single-lane run."""
    ths = [[b] for b in GRID["fig6_thresholds"]]
    c_short = max(GRID["fig6_thresholds"])
    fig6_pools = {
        "short": (PoolConfig("short", c_short, n_seq_for_cmax(c_short), headroom=1.05), 2),
        "long": (PoolConfig("long", 65_536, 16, headroom=1.02), 1),
    }
    n6 = GRID["fig6_requests"]
    for trace in ("azure", "lmsys"):
        cols = generate_trace_columns(TraceSpec(trace=trace, num_requests=n6,
                                                rate=GRID["fig6_rate"], seed=GRID["fig6_seed"]))
        run = grid_run(f"fig6 {trace}", lambda: run_fleet_grid(
            cols, fig6_pools, A100_LLAMA3_70B, thresholds=ths, device=dev),
            lanes=len(ths), n=n6)
        grid = run["out"]
        check_grid(grid, n6, f"fig6 {trace}")
        short = grid.routed[:, 0] / grid.routed.sum(axis=1)
        if not (np.diff(short) >= 0).all():
            fail(f"fig6 {trace}: the short fraction falls as the threshold rises: {short}")
        for i, b in enumerate(GRID["fig6_thresholds"]):
            print(f"[grid] fig6/des/{trace}/b{b}: goodput {grid.goodput()[i]:.4f} req/s, TTFT "
                  f"p99 {grid.ttft_p99[i]:.4f} s, short fraction {short[i]:.4f}, completed "
                  f"{grid.completed[i]}, preempted {grid.preemptions[i]}", flush=True)

    # card against host CPU, bit for bit
    cols = generate_trace_columns(TraceSpec(trace="azure", num_requests=GRID["cross"],
                                            rate=GRID["fig6_rate"], seed=GRID["fig6_seed"]))
    runs = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        grid = run_fleet_grid(cols, fig6_pools, A100_LLAMA3_70B, thresholds=ths,
                              return_records=True, device=d)
        runs[d.type] = (grid, torch_engine.last_run_stats())
        print(f"[grid] azure fig6 grid, n={GRID['cross']}, on {d.type}: "
              f"{time.perf_counter() - t0:.3f} s wall", flush=True)
    (gg, gs), (cg, cs) = runs["cuda"], runs["cpu"]
    for key in ("iters", "rounds", "iters_total", "rounds_total"):
        if gs[key] != cs[key]:
            fail(f"grid on the card and the CPU differ in {key}: {gs} vs {cs}")
    for col, v in cg.records.items():
        if gg.records[col].dtype != v.dtype or gg.records[col].tobytes() != v.tobytes():
            fail(f"grid on the card and the CPU differ in records[{col!r}]")
    print(f"[grid] azure fig6 grid, n={GRID['cross']}: card and CPU records bit-identical in "
          f"all {len(ths)} lanes ({len(cg.records)} columns), iters/rounds "
          f"{gs['iters']}/{gs['rounds']} (totals {gs['iters_total']}/{gs['rounds_total']}) on both",
          flush=True)

    # the kernel at the 16-lane Table-2 shape: a limit a lane, one at +inf
    G = max(GRID["ladders"])
    _, P, I, S = des["shape"]
    limits = [1.5 + 0.05 * g for g in range(G - 1)] + [math.inf]
    kernel = sim_decode_phase(dev, flush, (G, P, I, S), [DES["b_short"], 65_536],
                              [limits, None])

    # walls on the Table-2 fleet: ladders of 1, 4 and 16 lanes and the
    # single-lane FleetSim, all on one trace
    n = GRID["requests"]
    cols, short = (generate_trace_columns(TraceSpec(trace=DES["trace"], num_requests=k,
                                                    rate=DES["rate"], seed=DES["seed"]))
                   for k in (n, GRID["profile"]))
    routed = des["routed"]

    def single(trace):
        return lambda: FleetSim(routed, A100_LLAMA3_70B, b_short=DES["b_short"], backend="torch",
                                device=dev, spillover=False).run(trace)

    def ladder_of(g, trace):
        ladder = [[int(b)] for b in np.linspace(512, 8192, g)] if g > 1 else [[8192]]
        return lambda: run_fleet_grid(trace, routed, A100_LLAMA3_70B, thresholds=ladder,
                                      device=dev)

    walls = {"single": grid_run("FleetSim, single lane", single(cols), lanes=1, n=n,
                                busy_fn=single(short))}
    for g in GRID["ladders"]:
        span = "8192" if g == 1 else "512..8192"
        walls[g] = grid_run(f"ladder of {g} ({span})", ladder_of(g, cols), lanes=g, n=n,
                            busy_fn=ladder_of(g, short))
        check_grid(walls[g]["out"], n, f"ladder of {g}")
    one = walls["single"]["wall_s"]
    ratio = walls[G]["wall_s"] / (G * one)
    print(f"[grid] {G}-lane wall / ({G} x single-lane wall) = {ratio:.4f}", flush=True)
    return dict(kernel=kernel, launches=walls[G]["launches"])


# ---------------------------------------------------------------------------
# Windowed telemetry on the card, and the paper's tables from the port
# ---------------------------------------------------------------------------


def telemetry_phase(dev, des: dict) -> dict:
    """``[telemetry]``: the routed Table-2 fleet of ``[des]`` (10,000
    requests) again, with windows of ``TELEMETRY["window"]`` dispatched
    requests: its records must equal ``[des]``'s routed run bit for bit,
    with the same rounds and host syncs; its export must validate and its
    windowed deltas sum to the run's counters. Then the same fleet with its
    short pool cut to ``TELEMETRY["cut"]`` of its instances and an
    ``AdaptiveController`` over windows of ``TELEMETRY["control_window"]``,
    on ``TELEMETRY["cross"]`` requests on the card and on the CPU: every
    column and the controller's history must be equal."""
    decode_advance.launches = 0
    run = run_des(des["routed"], des["cols"], dev, label="routed Table-2 fleet, telemetry",
                  tag="telemetry", telemetry=TelemetryConfig(window=TELEMETRY["window"],
                                                             events=False))
    launches = decode_advance.launches
    sim, res, stats, wall = run["sim"], run["res"], run["stats"], run["wall_s"]
    if launches == 0:
        fail("sim_decode was never launched on the telemetry run")
    tel = res.telemetry
    doc = validate_telemetry(tel.to_json())
    n = len(des["cols"])
    cols = tel.columns
    pools = list(tel.pool_names)
    for i in range(tel.num_samples):
        print(f"[telemetry] sample {i}: t_req {cols['t_req'][i]} t_sim {cols['t_sim'][i]:.4f} s "
              + " ".join(f"{p}: queue {cols[f'queue_depth.{p}'][i]} active "
                         f"{cols[f'active.{p}'][i]} kv {cols[f'kv_frac.{p}'][i]:.4f}"
                         for p in pools), flush=True)
    try:
        check_window_deltas(tel, res)
    except ValueError as err:
        fail(f"telemetry: {err}")
    if not same_records(record_columns(sim), des["records"]):
        fail("telemetry: the records differ from [des]'s routed run")
    for key in ("iters", "rounds", "host_syncs"):
        if stats[key] != des["stats"][key]:
            fail(f"telemetry: {key} {stats[key]} differs from [des]'s {des['stats'][key]}")
    if doc["num_samples"] != n // TELEMETRY["window"] + 1:
        fail(f"telemetry: {doc['num_samples']} samples for {n} requests")
    print(f"[telemetry] routed Table-2 fleet, {n} requests, windows of {TELEMETRY['window']}: "
          f"{tel.num_samples} samples, export valid; {wall:.2f} s wall ([des] {des['wall_s']:.2f} "
          f"s without telemetry), iters {stats['iters']} rounds {stats['rounds']} host syncs "
          f"{stats['host_syncs']} (equal to [des]'s), sim_decode launches {launches}; records "
          f"bit-identical to [des]'s routed run", flush=True)

    short_cfg, n_short = des["routed"]["short"]
    cut = dict(des["routed"], short=(short_cfg, max(1, int(n_short * TELEMETRY["cut"]))))
    trace = generate_trace_columns(TraceSpec(trace=DES["trace"], num_requests=TELEMETRY["cross"],
                                             rate=DES["rate"], seed=DES["seed"]))
    runs = []
    for d in (dev, torch.device("cpu")):
        ctrl = AdaptiveController(b_min=512)
        r = run_des(cut, trace, d, label=f"controlled fleet (short pool {cut['short'][1]} of "
                    f"{n_short})", tag="telemetry", controller=ctrl,
                    control_window=TELEMETRY["control_window"],
                    telemetry=TelemetryConfig(window=TELEMETRY["control_window"], events=False))
        tel_d = r["res"].telemetry
        runs.append((tel_d, ctrl, r["stats"]))
        print(f"[telemetry] controlled fleet on {d.type}: {tel_d.num_samples} samples, "
              f"{len(ctrl.history)} boundary moves, final thresholds {ctrl.thresholds}",
              flush=True)
    (gt, gc, gs), (ct, cc, cs) = runs
    if gt.num_samples != ct.num_samples or set(gt.columns) != set(ct.columns):
        fail("telemetry: the card's and the CPU's samples or column sets differ")
    for name in ct.columns:
        if not np.array_equal(gt.column(name), ct.column(name), equal_nan=True):
            fail(f"telemetry: column {name} differs between the card and the CPU")
    if [dataclasses.astuple(m) for m in gc.history] != [dataclasses.astuple(m) for m in cc.history]:
        fail("telemetry: the controller's history differs between the card and the CPU")
    if not cc.history:
        fail("telemetry: the controlled fleet never moved a boundary")
    if (gs["iters"], gs["rounds"]) != (cs["iters"], cs["rounds"]):
        fail(f"telemetry: loop counters differ between the card and the CPU: {gs} vs {cs}")
    print(f"[telemetry] n={TELEMETRY['cross']}: card and CPU equal in all {len(ct.columns)} "
          f"columns x {ct.num_samples} samples and the controller's {len(cc.history)} moves",
          flush=True)
    return dict(launches=launches, wall_s=wall, samples=tel.num_samples, stats=stats)


def tables_phase(dev, des: dict) -> dict:
    """``[tables]``: the paper's tables from the port's scripts: Tables 1,
    2, 4 and 5 and the Eq. 7 / 8 gap on the host, Table 3 at its default
    1/5 scale on the card (its sim_decode counter set to 0 just before and
    read just after). Table 2's Azure instance counts and both of Table 3's
    fleets meeting the paper's SLO are checked."""
    import contextlib
    import io

    from benchmarks import (
        common, port_cost_model_gap, port_table1_pools, port_table2_cost,
        port_table3_latency, port_table4_calibration, port_table5_mi300x,
    )

    out = {}

    def rows(label, fn, **kw):
        common.reset_rows()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out[label] = fn(**kw)
        wall = time.perf_counter() - t0
        for row in common.rows_as_json()["rows"]:
            print(f"[tables] {row['name']} {row['derived_raw']} ({row['us_per_call']:.1f} us)",
                  flush=True)
        print(f"[tables] {label}: {wall:.2f} s", flush=True)

    for label, mod in (("table1", port_table1_pools), ("table2", port_table2_cost),
                       ("table4", port_table4_calibration), ("table5", port_table5_mi300x),
                       ("cost_model_gap", port_cost_model_gap)):
        rows(label, mod.run)
    decode_advance.launches = 0
    rows("table3", port_table3_latency.run, device=dev)
    launches = decode_advance.launches
    if launches == 0:
        fail("sim_decode was never launched on Table 3's runs")

    az = out["table2"]["azure"]
    got = (az.short.instances, az.long.instances, az.g_homo)
    if got != TABLE2_AZURE:
        fail(f"Table 2 (Azure, seed 42): short + long against homogeneous {got}, "
             f"expected {TABLE2_AZURE}")
    plan = des["plan"]
    if (plan.short.instances, plan.long.instances, plan.g_homo) != TABLE2_DES:
        fail(f"the [des] plan (seed {DES['seed']}) is not {TABLE2_DES}")
    for key in ("homogeneous", "token_budget"):
        res = out["table3"][key]
        if not res.summary.meets_slo(PAPER_SLO):
            fail(f"Table 3 {key} misses the paper's SLO: TTFT p99 {res.summary.ttft_p99} s, "
                 f"TPOT p99 {res.summary.tpot_p99} s")
    print(f"[tables] Table 2 Azure {got[0]} + {got[1]} against {got[2]} (seed 42), the [des] "
          f"plan {TABLE2_DES[0]} + {TABLE2_DES[1]} against {TABLE2_DES[2]} (seed "
          f"{DES['seed']}); Table 3 both fleets meet PAPER_SLO on the card, sim_decode launches "
          f"{launches}", flush=True)
    return dict(launches=launches)


def embed_kernel_rows(dev, flush) -> dict:
    """Flash and paged at the layouts the vlm and audio stacks give them:
    qwen2-vl's GQA group of 7 (its 256-position prompt; the serving pools'
    pages), musicgen's D 64 MHA (its 200-position prompt, causal, and the
    prompt against its 256-position memory, non-causal; a decode slot cache
    and the cross cache, every position valid)."""
    vlm, audio = get_config(VLM), get_config(AUDIO)
    vlm_heads = (vlm.n_heads, vlm.n_kv_heads, vlm.head_dim)
    audio_heads = (audio.n_heads, audio.n_kv_heads, audio.head_dim)
    n, mem = EMBED_RUN[AUDIO]["prompt"], audio.cross_mem_len
    return dict(
        flash_g7=flash_phase(dev, flush, heads=vlm_heads, lengths=(256,), tag=VLM),
        paged_g7=paged_phase(dev, flush, heads=vlm_heads, tag=VLM),
        flash_d64=flash_phase(dev, flush, heads=audio_heads, lengths=(n, 256), tag=AUDIO),
        flash_cross=flash_cross_phase(dev, flush, heads=audio_heads, lq=n, lk=mem, tag=AUDIO),
        paged_d64=paged_phase(dev, flush, heads=audio_heads, tag=AUDIO, pools=POOLS[:1]),
        paged_cross=paged_phase(dev, flush, heads=audio_heads, tag=f"{AUDIO} cross",
                                pools=(("cross", EMBED_RUN[AUDIO]["seqs"], mem),), full=True),
    )


def new_model_phases(dev, stamp) -> dict:
    """``[serve-xlstm]`` with its profile and logits check, ``[vlm]`` and
    ``[audio]``; each frees the card after it."""
    xl = serve_xlstm_phase()
    profile_decode(xl["server"], "profile-xlstm")
    logits_check(xl["server"], "logits-xlstm")
    del xl["server"]
    stamp("xlstm serve")
    runs = {}
    for arch, tag in ((VLM, "vlm"), (AUDIO, "audio")):
        gc.collect()
        torch.cuda.empty_cache()
        runs[arch] = embed_phase(dev, arch, tag)
        stamp(tag)
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def embed_entries(entry, rows: dict, runs: dict) -> list:
    """The JSON line's rows of the vlm and audio paths (the audio path's
    flash launches count its causal and its cross-attention calls
    together)."""
    flash_src, paged_src = "flash_attention.cu", "paged_attention.cu"
    flash_rep = "src/repro/kernels/flash_attention.py:96"
    paged_rep = "src/repro/kernels/paged_attention.py:96"
    vlm_path = f"prefill and decode {VLM}, {EMBED_RUN[VLM]['seqs']} slots"
    audio_path = f"prefill and decode {AUDIO}, {EMBED_RUN[AUDIO]['seqs']} slots"
    vl, al = runs[VLM]["launches"], runs[AUDIO]["launches"]
    n, mem = EMBED_RUN[AUDIO]["prompt"], get_config(AUDIO).cross_mem_len
    out = [
        entry("flash_attention_g7", flash_src, flash_rep, vlm_path, vl["flash_attention"],
              rows["flash_g7"][256], "H=28 K=4 D=128 L=256"),
        entry("paged_attention_g7", paged_src, paged_rep, vlm_path, vl["paged_attention"],
              rows["paged_g7"]["short"], "8 slots x 512, H=28 K=4 D=128, bf16 pages"),
        entry("flash_attention_d64", flash_src, flash_rep, audio_path, al["flash_attention"],
              rows["flash_d64"][n], f"H=24 K=24 D=64 L={n}"),
        entry("flash_attention_cross", flash_src, flash_rep, audio_path, al["flash_attention"],
              rows["flash_cross"], f"H=24 K=24 D=64 Lq={n} Lk={mem}, non-causal"),
        entry("paged_attention_d64", paged_src, paged_rep, audio_path, al["paged_attention"],
              rows["paged_d64"]["short"], "8 slots x 512, H=24 K=24 D=64, bf16 pages"),
        entry("paged_attention_cross", paged_src, paged_rep, audio_path, al["paged_attention"],
              rows["paged_cross"]["cross"],
              f"{EMBED_RUN[AUDIO]['seqs']} slots x {mem} cross cache, every position valid, "
              f"H=24 K=24 D=64"),
    ]
    for k, row in zip(out, (rows["flash_g7"][256], rows["paged_g7"]["short"],
                            rows["flash_d64"][n], rows["flash_cross"],
                            rows["paged_d64"]["short"], rows["paged_cross"]["cross"])):
        k.update({key: row[key] for key in ("variant", "splits") if key in row})
    return out


def check_grad(out: torch.Tensor, ref: torch.Tensor, what: str) -> tuple[float, float]:
    """Holds a gradient to its plain version: f32 within F32_GRAD_TOL of the
    largest value; bf16 within ROW_ULPS a row and KERNEL_TOL, 1.28 ulps of
    values in [2, 4), doubled for each power of two the tensor's largest
    value lies past that (dk and dv sum a kv head's G query heads and reach
    past 4), so 1.28 ulps at the largest value. A row's scale is floored
    at 2**-8 of the tensor's largest value: a gradient row can cancel to ~0
    (causal query 0's dq is exactly 0) and then carries the f32 rounding of
    the terms it cancels, not of its own size; for unit-scale inputs the
    floor is at least 2**-10 (at L = 1 every dq is such a residue).
    Returns (max abs error, worst row's ulps)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    big = ref.abs().max().item()
    top = ref.abs().amax(-1).clamp_min(max(big * 2.0**-8, 2.0**-10))
    ulps = (err.amax(-1) / torch.exp2(torch.floor(torch.log2(top)) - 7)).max().item()
    worst = err.max().item()
    if out.dtype == torch.float32:
        if worst > F32_GRAD_TOL * max(1.0, big):
            fail(f"{what}: max |kernel - plain| {worst} (limit {F32_GRAD_TOL} x {big})")
        return worst, ulps
    limit = KERNEL_TOL * 2.0 ** max(0, math.floor(math.log2(big)) - 1)
    if not (worst <= limit and ulps <= ROW_ULPS):
        fail(f"{what}: max |kernel - plain| {worst} (limit {limit}, largest |plain| {big}), "
             f"worst row {ulps:.3g} bf16 ulps (limit {ROW_ULPS})")
    return worst, ulps


def flash_bwd_phase(dev, flush) -> dict:
    """``[flash-bwd]``: the forward's log-sum-exp and the backward kernel
    against their plain versions at the FLASH_BWD shapes, two launches
    bit for bit, and the times of the kernel, the plain backward and
    SDPA's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` on a retained graph)."""
    rows = {}
    for tag, B, H, K, D, lq, lk, causal, dtype in FLASH_BWD:
        gen = torch.Generator(device=dev).manual_seed(11)
        q = torch.randn(B, H, lq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, K, lk, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, K, lk, D, generator=gen, device=dev).to(dtype)
        do = torch.randn(B, H, lq, D, generator=gen, device=dev).to(dtype)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        _, lse_ref = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        lse_err = (lse - lse_ref).abs().max().item()
        name = f"flash-bwd {tag} B={B} H={H} K={K} D={D} Lq={lq} Lk={lk}"
        if not lse_err <= LSE_TOL:
            fail(f"{name}: lse off by {lse_err} (limit {LSE_TOL})")
        grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
        again = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"{name}: two launches differ")
        refs = flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal)
        errs = [check_grad(g, r, f"{name} d{n}") for n, g, r in zip("qkv", grads, refs)]
        del refs
        size = q.element_size()
        nbytes = size * (4 * B * H * lq * D + 4 * B * K * lk * D)  # q o dO dq; k v dk dv
        flops = 2.5 * 4 * B * H * lq * lk * D * (0.5 if causal else 1.0)
        bnd, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                           else PEAK_F32_FLOPS)
        args = (q, k, v, out, lse, do)
        ms = time_ms(lambda: flash_attention_backward(*args, causal=causal), flush=flush)
        plain_ms = time_ms(lambda: flash_attention_backward_plain(*args, causal=causal),
                           flush=flush)
        lq_, lk_, lv_ = (t.detach().requires_grad_() for t in (q, k, v))
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            lq_, lk_, lv_, is_causal=causal, enable_gqa=True)
        library_ms = time_ms(lambda: torch.autograd.grad(o_lib, (lq_, lk_, lv_), do,
                                                         retain_graph=True), flush=flush)
        del o_lib
        row = dict(B=B, H=H, K=K, D=D, L=lq, lk=lk, causal=causal, lse_err=lse_err,
                   variant=backward_variant(D, dtype),
                   max_abs_err=max(e for e, _ in errs), worst_row_ulps=max(u for _, u in errs),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd, bound_by=by)
        rows[(tag, lq)] = row
        print(f"[flash-bwd] {tag} B={B} H={H} K={K} D={D} Lq={lq} Lk={lk} "
              f"{'causal' if causal else 'non-causal'} {str(dtype)[6:]} variant {row['variant']}: "
              f"lse err {lse_err:.3g} "
              f"(tol {LSE_TOL}); dq/dk/dv err {[f'{e:.3g}' for e, _ in errs]}, worst row "
              f"{row['worst_row_ulps']:.3g} ulps; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"sdpa-bwd {library_ms:.4f} ms bound {bnd:.4f} ms ({by}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return rows


def dense_cut(layers: int):
    """yi-6b at full width and ``layers`` of its 32 layers."""
    return dataclasses.replace(get_config(DENSE), n_layers=layers)


def train_phase(dev) -> dict:
    """``[train]``: TRAIN's steps of ``make_train_step`` on yi-6b at full
    width, TRAIN["layers"] layers, every layer rematerialized, w_q/w_k
    tempered by 0.1 as the logits checks temper them: the reference's init
    makes attention a near arg-max, and through 8 layers its gradients
    reach norms of millions (clipped to 1), where 12 AdamW steps leave the
    loss flat (11.555 to 11.554 untempered in a chip run; tempered, d_model
    512 at 8 layers goes from 11.53 to 8.2 on the CPU). Gates: every
    loss finite, the last three below the first, two flash forward
    launches (the forward and its recompute) and one backward a layer and
    step. Then one step under the profiler: kernels a step, the device's
    busy share, the attention backward's share."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dense_cut(TRAIN["layers"])
    model = Model(cfg, remat=TRAIN["remat"])
    steps = TRAIN["steps"]
    tcfg = TrainConfig(peak_lr=TRAIN["peak_lr"], warmup_steps=max(2, steps // 20),
                       total_steps=steps)
    step_fn, _ = make_train_step(model, tcfg)
    params, opt = init_train_state(model, tcfg, 0, device=dev)
    with torch.no_grad():
        temper_attention(params)
    n_params = sum(p.numel() for p in leaves(params))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                  global_batch=TRAIN["batch"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    flash_bwd_before = flash_attention_backward.launches
    losses, walls = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, data.batch(i), i)
        losses.append(float(metrics["loss"]))  # syncs
        walls.append(time.perf_counter() - t0)
    fwd = flash_attention.launches
    bwd = flash_attention_backward.launches - flash_bwd_before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {DENSE} {cfg.n_layers} of {get_config(DENSE).n_layers} layers at full width "
          f"({n_params / 1e9:.3f} G parameters, bf16; AdamW f32 moments), B={TRAIN['batch']} "
          f"L={TRAIN['seq']}, remat {TRAIN['remat']}, peak lr {TRAIN['peak_lr']}: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"[train] a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"[train] the last three losses {losses[-3:]} are not below the first {losses[0]}")
    want_fwd, want_bwd = 2 * cfg.n_layers * steps, cfg.n_layers * steps
    bwd_tc = flash_attention_backward.launches_tc
    if fwd != want_fwd or bwd != want_bwd or bwd_tc != want_bwd:
        fail(f"[train] {fwd} flash forward launches (want {want_fwd}) and {bwd} backward, "
             f"{bwd_tc} of them on tensor cores (want {want_bwd}) in {steps} steps")
    step_ms = 1e3 * float(np.median(walls[2:]))
    tokens = TRAIN["batch"] * TRAIN["seq"]

    batch = data.batch(steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch, steps)
        float(metrics["loss"])
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_activities(prof)
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    bwd_ms = sum(us for name, (_, us) in kernels.items()
                 if re.search(r"::(delta|dkdv|dkdv_tc|dq|dq_tc)_kernel<", name)) / 1e3
    fwd_ms = sum(us for name, (_, us) in kernels.items() if "flash_tc_kernel" in name) / 1e3
    out = dict(
        launches_fwd=fwd, launches_bwd=bwd, losses=losses, step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), peak_gb=peak_gb, n_params=n_params,
        kernels_per_step=sum(c for c, _ in kernels.values()), busy_share=busy_ms / prof_wall_ms,
        attn_bwd_ms=bwd_ms, attn_bwd_share=bwd_ms / busy_ms, attn_fwd_ms=fwd_ms,
        profiled_wall_ms=prof_wall_ms,
    )
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    print(f"[train] step {step_ms:.1f} ms (median of steps 2-{steps - 1}; first {1e3 * walls[0]:.1f} "
          f"ms), {out['tokens_per_s']:.0f} tokens/s, peak memory {peak_gb:.2f} GB; flash launches "
          f"{fwd} forward, {bwd} backward in {steps} steps", flush=True)
    print(f"[train] profiled step: wall {prof_wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * out['busy_share']:.1f}% of the wall), {out['kernels_per_step']} kernels; "
          f"attention backward {bwd_ms:.1f} ms ({100 * out['attn_bwd_share']:.1f}% of the device "
          f"time), attention forward {fwd_ms:.2f} ms", flush=True)
    for name, (count, us) in top:
        print(f"[train]   {us / 1e3:9.3f} ms {count:5d}x  {name[:80]}")
    del params, opt, metrics
    return out


class _PlainFlash:
    """Stands in for the flash kernel's autograd Function in ``[train-grad]``:
    autograd through the plain attention."""

    @staticmethod
    def apply(q, k, v, causal):
        return flash_attention_plain(q, k, v, causal=causal)


def train_grad_phase(dev) -> dict:
    """``[train-grad]``: the loss and every gradient leaf of yi-6b at full
    width (TRAIN["grad_layers"] layers, w_q/w_k tempered as the logits
    checks temper them) through the kernels, against the same with
    autograd through ``flash_attention_plain`` (swapped in here only, with
    ``unittest.mock.patch``). Relative L2 a leaf, GRAD_REL_TOL."""
    from unittest import mock

    cfg = dense_cut(TRAIN["grad_layers"])
    model = Model(cfg)
    params = model.init(1, device=dev)
    temper_attention(params)
    p_leaves = leaves(params)
    for p in p_leaves:
        p.requires_grad_(True)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["grad_seq"],
                                 global_batch=TRAIN["grad_batch"])).batch(0)
    batch = {k: torch.as_tensor(x, device=dev) for k, x in raw.items()}

    def value_and_grad():
        loss, _ = model.loss(params, batch)
        return loss.detach().float(), torch.autograd.grad(loss, p_leaves)

    before = flash_attention_backward.launches
    loss_k, grads_k = value_and_grad()
    launched = flash_attention_backward.launches - before
    with mock.patch.object(flash_mod, "FlashAttention", _PlainFlash):
        loss_p, grads_p = value_and_grad()
    if launched != cfg.n_layers or flash_attention_backward.launches != before + launched:
        fail(f"[train-grad] {launched} backward launches with the kernels (want {cfg.n_layers})")
    rel = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
           for a, b in zip(grads_k, grads_p)]
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst = max(rel)
    print(f"[train-grad] {DENSE} {cfg.n_layers} layers full width B={TRAIN['grad_batch']} "
          f"L={TRAIN['grad_seq']}: loss {loss_k.item():.6f} kernels vs {loss_p.item():.6f} plain "
          f"(rel {loss_rel:.3g}); {len(rel)} gradient leaves, worst rel L2 {worst:.4g} "
          f"(limit {GRAD_REL_TOL}), median {float(np.median(rel)):.4g}", flush=True)
    if not (worst <= GRAD_REL_TOL and loss_rel <= GRAD_REL_TOL):
        fail(f"[train-grad] gradients differ: worst leaf {worst}, loss {loss_rel}")
    return dict(worst_rel=worst, loss_rel=loss_rel, leaves=len(rel))


def train_restart_phase(dev) -> dict:
    """``[train-restart]``: ``launch.train.train`` on reduced yi-6b on the
    card: uninterrupted, then with a failure injected and resumed from the
    latest checkpoint. Gates that the resume starts at the checkpointed
    step; prints the largest loss difference from the uninterrupted run."""
    import tempfile

    kw = TRAIN["restart"]
    run = dict(steps=kw["steps"], seq_len=kw["seq_len"], global_batch=kw["global_batch"],
               ckpt_every=kw["ckpt_every"], device=dev, log_every=1000)
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        full = train(DENSE, ckpt_dir=d1, **run)
        try:
            train(DENSE, ckpt_dir=d2, simulate_failure_at=kw["fail_at"], **run)
            fail("[train-restart] the injected failure did not raise")
        except SimulatedFailure:
            pass
        resumed = train(DENSE, ckpt_dir=d2, **run)
    want = kw["fail_at"] // kw["ckpt_every"] * kw["ckpt_every"]
    diff = max(abs(a - b) for a, b in zip(full["losses"][want:], resumed["losses"]))
    print(f"[train-restart] reduced {DENSE}: failure at step {kw['fail_at']}, resumed at step "
          f"{resumed['start']} (checkpoint every {kw['ckpt_every']}: want {want}); "
          f"{len(resumed['losses'])} steps after the resume, largest loss difference from the "
          f"uninterrupted run {diff:.3g}", flush=True)
    if resumed["start"] != want or len(resumed["losses"]) != kw["steps"] - want:
        fail(f"[train-restart] resumed at {resumed['start']}, want {want}")
    return dict(start=resumed["start"], max_loss_diff=diff)


def sass_mma_counts() -> dict:
    """Each built library's counts of tensor-core instructions in its SASS:
    HGMMA (wgmma) and HMMA (mma.sync)."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    counts = {}
    for name in _build.KERNELS:
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    start = time.perf_counter()

    def stamp(phase: str) -> None:
        """Seconds since the script's start at the end of each phase: the
        run must stay inside its time limit as phases are added."""
        print(f"[time] {phase} done at {time.perf_counter() - start:.1f} s", flush=True)

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
    mma = sass_mma_counts()
    print(f"[build] HGMMA / HMMA instructions in each library's SASS: {mma}", flush=True)
    if not mma["flash_attention"]["HGMMA"]:
        fail("the flash_attention library has no HGMMA (wgmma) instruction")
    if not (mma["ssd_scan"]["HGMMA"] or mma["ssd_scan"]["HMMA"]):
        fail("the ssd_scan library has no HGMMA or HMMA (tensor-core) instruction")
    if not mma["flash_attention_bwd"]["HMMA"]:
        fail("the flash_attention_bwd library has no HMMA (mma.sync) instruction")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    floor = timing_floor(dev, flush)
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
    moe_cfg, scout_cfg = get_config(MOE), get_config(SCOUT)
    moe_heads = (moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.head_dim)
    scout_heads = (scout_cfg.n_heads, scout_cfg.n_kv_heads, scout_cfg.head_dim)
    flash_g16 = flash_phase(dev, flush, heads=moe_heads, lengths=(256, 1024), tag=MOE)
    flash_g5 = flash_phase(dev, flush, heads=scout_heads, lengths=(256,), tag=SCOUT)
    paged_g16 = paged_phase(dev, flush, heads=moe_heads, tag=MOE)
    paged_g5 = paged_phase(dev, flush, heads=scout_heads, tag=SCOUT, pools=POOLS[:1])
    embed_rows = embed_kernel_rows(dev, flush)
    bwd_rows = flash_bwd_phase(dev, flush)
    del flush
    stamp("build and kernel rows")
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_phase(dev)
    train_restart_phase(dev)
    stamp("training")
    gc.collect()
    torch.cuda.empty_cache()

    served = serve_phase(DENSE, ("flash_attention", "paged_attention"), "serve")
    profile_decode(served["server"], "profile")
    served8 = serve_int8_phase(served["server"])  # before logits_check tempers the weights
    profile_decode(served8["server"], "profile-int8")
    logits_check(served["server"], "logits")
    logits_int8_check(served8["server"])
    served_launches, int8_launches = served["launches"], served8["launches"]
    del served, served8
    stamp("yi-6b serves")
    gc.collect()
    torch.cuda.empty_cache()

    hybrid = serve_phase(HYBRID, ("flash_attention", "paged_attention", "ssd_scan"),
                         "serve-hybrid")
    profile_decode(hybrid["server"], "profile-hybrid")
    logits_check(hybrid["server"], "logits-hybrid")
    del hybrid["server"]
    stamp("zamba2 serve")
    gc.collect()
    torch.cuda.empty_cache()

    moe = serve_moe_phase(dev)
    profile_decode(moe["server"], "profile-moe")
    cut = moe["server"].short_engine.model.cfg
    logits_check(moe["server"], "logits-moe", model=Model(cut, moe_group=1))
    del moe["server"]
    stamp("qwen3 serve")
    gc.collect()
    torch.cuda.empty_cache()
    scout = scout_phase(dev)
    stamp("scout decode")
    gc.collect()
    torch.cuda.empty_cache()
    embed_runs = new_model_phases(dev, stamp)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    des = des_phase(dev, flush)
    stamp("des")
    grid = grid_phase(dev, flush, des)
    del flush
    stamp("grid")
    telemetry = telemetry_phase(dev, des)
    stamp("telemetry")
    tables_phase(dev, des)
    stamp("tables")

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
                    library_ms=row.get("library_ms"), floor_ms=floor)

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
              f"(G, P, I, S) = {des['kernel']['shape']}"),
        entry("sim_decode_grid", "sim_decode.cu", "src/repro/kernels/sim_decode.py:243",
              f"run_fleet_grid, Table-2 fleet, {max(GRID['ladders'])} threshold lanes",
              grid["launches"], grid["kernel"], f"(G, P, I, S) = {grid['kernel']['shape']}"),
    ]
    moe_path = f"serve {MOE} ({MOE_LAYERS[MOE]} of {get_config(MOE).n_layers} layers)"
    scout_path = (f"decode {SCOUT} ({MOE_LAYERS[SCOUT]} of {get_config(SCOUT).n_layers} "
                  f"layers), 8 slots")
    kernels += [
        entry("flash_attention_g16", flash_src, flash_rep, moe_path,
              moe["launches"]["flash_attention"], flash_g16[256], "H=64 K=4 D=128 L=256"),
        entry("paged_attention_g16", paged_src, paged_rep, moe_path,
              moe["launches"]["paged_attention"], paged_g16["short"],
              "8 slots x 512, H=64 K=4 D=128, bf16 pages"),
        entry("flash_attention_g5", flash_src, flash_rep, scout_path,
              scout["launches"]["flash_attention"], flash_g5[256], "H=40 K=8 D=128 L=256"),
        entry("paged_attention_g5", paged_src, paged_rep, scout_path,
              scout["launches"]["paged_attention"], paged_g5["short"],
              "8 slots x 512, H=40 K=8 D=128, bf16 pages"),
    ]
    kernels += embed_entries(entry, embed_rows, embed_runs)
    kernels[4]["dequant_ms"] = paged8["short"]["dequant_ms"]
    for k, row in zip(kernels[:6] + kernels[8:],
                      (flash_rows[256], flash80[256], paged_rows["short"], paged80["short"],
                       paged8["short"], ssd_rows[256], flash_g16[256], paged_g16["short"],
                       flash_g5[256], paged_g5["short"])):
        k.update({key: row[key] for key in ("variant", "splits", "p_split", "ctas") if key in row})
    kernels.append(
        entry("flash_attention_bwd", "flash_attention_bwd.cu",
              "src/repro/models/layers.py:108 (no Pallas kernel: the reference differentiates "
              "its jnp attention with jax.grad)",
              f"train {DENSE} ({TRAIN['layers']} of {get_config(DENSE).n_layers} layers), "
              f"{TRAIN['steps']} steps", trained["launches_bwd"], bwd_rows[(DENSE, TRAIN["seq"])],
              f"B={TRAIN['batch']} H=32 K=4 D=128 L={TRAIN['seq']} causal"))
    kernels[-1]["variant"] = bwd_rows[(DENSE, TRAIN["seq"])]["variant"]
    kernels.append(
        entry("sim_decode_telemetry", "sim_decode.cu", "src/repro/kernels/sim_decode.py:243",
              f"DES routed Table-2 fleet, telemetry windows of {TELEMETRY['window']}",
              telemetry["launches"], des["kernel"], f"(G, P, I, S) = {des['kernel']['shape']}"))
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
