"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and nvcc:

1. builds every CUDA kernel of the port from ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, all at once), prints the build time and
   each library's counts of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)
   instructions in its SASS (``cuobjdump``); the flash library and its
   backward's must have HGMMA, the SSD scan's library and its backward's
   one of the two; the flash backward's wgmma kernels' and the SSD
   backward's kernels' registers and spills from ``ptxas -v``. Then
   reads ``time_ms``'s own
   floor (a one-element fill under the same flush, sleep and events);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving paths give it (bf16; yi-6b's head_dim 128, zamba2's
   80, yi-6b's int8 pages with f16 scales; zamba2's SSD scan at its prompt
   lengths, a ragged one included) and at the long-pool shapes (flash at
   yi-6b L=4096, paged at 2 slots x 65,536), with the tolerance, flash's
   variant and paged's split count printed, and times the kernel, the
   plain version and, where one exists, one PyTorch call computing the same
   function as a yardstick (the port never calls it); the paged kernel's
   log-sum-exp at yi-6b's short pool, bf16 and int8 pages: against the
   plain version's, a cache cut into two halves by position merged by
   ``combine_partials`` (as the sequence-parallel decode merges its
   shards) against the whole cache's kernel output, a row of length 0
   (output 0, lse -inf), the kernel's ms with and without the lse;
2b. the flash kernel's backward (``[flash-bwd]``): the forward's
   log-sum-exp and ``csrc/flash_attention_bwd.cu`` against their plain
   versions at yi-6b's heads (B 2, L 1024 and 2048), qwen3's G 16, zamba2's
   D 80, musicgen's non-causal 200 x 256 and one f32 shape; two launches
   bit for bit; the kernel, the plain backward and SDPA's backward timed;
   at yi-6b's L 2048 and qwen3's rows the device ms of each of the three
   launches (profiler), the schedule's head split and CTAs. Then training
   (``[train]``): 12 AdamW
   steps of yi-6b at full width with 8 of its 32 layers (B 2 x L 2048,
   every layer rematerialized), the losses finite and falling, exactly two
   flash forwards and one tensor-core backward a layer and step (counters
   set to 0 just before, read just after), step time, tokens/s, peak
   memory and one profiled step's kernels and busy share;
   ``[train-grad]``: the loss and every gradient leaf at 2 layers against
   autograd through the plain attention; ``[train-restart]``:
   ``launch.train.train`` on reduced yi-6b with an injected failure,
   resumed at its checkpoint;
2c. the SSD scan's backward (``[ssd-bwd]``): ``csrc/ssd_scan_bwd.cu``
   against ``ssd_scan_backward_plain`` at zamba2's widths (B 2 x L 2048,
   the training shape; L 256; a ragged L 200), bf16 B/C, a nonzero
   final-state gradient, both on the kernel forward's chunk states; two
   launches bit for bit; kernel, plain and bound ms, the chunk kernel's
   variant and head group, the CTAs of the sweep and the chunk kernel,
   each launch's device ms (profiler) and the bytes the design moves (by
   arithmetic) beside the bound's; at the training shape the forward's ms
   with and without the chunk states, y bit for bit equal. Then ``[train-hybrid]``: 12 AdamW steps of zamba2-2.7b at
   full width with 12 of its 54 Mamba-2 blocks (two groups, both shared
   attention blocks), B 2 x L 2048, remat full, w_q/w_k tempered; the
   losses finite and falling, exactly two SSD forwards and one SSD
   backward (its tensor-core chunk kernel) a block and step, two flash forwards and one tensor-core
   backward an attention invocation and step (counters set to 0 just
   before, read just after); step time, tokens/s, peak memory and one
   profiled step's kernels, busy share and the SSD launches' shares;
   ``[train-hybrid-grad]``: one group's loss and gradient leaves through
   the kernels against autograd through the plain SSD scan and attention
   (f32 within 2e-2 rel L2 a leaf; bf16 no farther from the f32 gradients
   than the plain path plus 2e-2). ``[flash-bwd]`` has a row at zamba2's
   training shape too;
2d. the sharded path on a one-rank NCCL group, after the training phases
   (``[train-restart]`` runs the launcher without a group): ``[mesh]``
   starts the group (if NCCL does not start, the script fails; there is
   no fallback), builds ``make_host_mesh(1)`` on cuda and runs
   ``make_compressed_grad_sync`` over one yi-6b layer's gradient shapes in
   bf16, equal bit for bit to the formula at one rank, its ms printed;
   ``[train-mesh]`` trains yi-6b at full width with 4 of 32 layers (B 2 x L
   2048) for 3 steps through ``launch.train.train`` on DTensors, restores
   its step-2 checkpoint onto the mesh (``placements=``) and runs the next
   step (its loss must equal the uninterrupted run's), destroys the group
   and runs the same 3 steps on plain tensors: each loss within 1e-3
   (bit-equality printed), the flash forward and backward counters equal
   on the two paths, both step times printed. Before it, on the same
   group: ``[decode-mesh-moe]`` prefills 8 slots of qwen3-235b-a22b at full
   width with 2 of 94 layers and an int8 KV cache, then decodes 16 greedy
   steps on DTensors (the experts sharded on the model axis) and on plain
   tensors: the tokens identical, the int8 paged kernel's launches equal,
   one more mesh step under ``CommCounter`` with no all-gather of an
   expert weight and every expert leaf still placed as it was, both step
   times printed; and the mesh side of ``[train-mesh-hybrid]``: 4 steps of
   zamba2-2.7b at full width with one group of 6 Mamba-2 blocks (the shared
   attention applied once), B 2 x L 2048, through ``launch.train.train`` on
   DTensors, no checkpoint written. Its plain side runs after
   ``[train-mesh]`` (``train`` takes the mesh path while a group is up):
   each loss within 1e-3 (bit-equality printed), the SSD scan's forward and
   backward and flash's forward and backward launched as often on both
   sides, both step times printed. Also on the group, before it:
   ``[decode-mesh-vlm-audio]`` prefills 8 slots of qwen2-vl-7b and of
   musicgen-medium, each at full width with 2 of its layers, and decodes 8
   greedy steps on DTensors and on plain tensors (musicgen's self and
   cross caches laid out along their sequence, as the 16-wide mesh lays
   them out, so its decode runs the sequence-parallel path with the
   kernel's lse): the tokens identical, flash and paged launched as often
   on both sides, both step times printed; and the mesh side of
   ``[train-mesh-xlstm]``: 2 steps of xlstm-350m at full width and depth
   (24 blocks), B 2 x L 256, on DTensors, no checkpoint written; its plain
   side runs after ``[train-mesh-hybrid]``'s: each loss within 1e-3
   (bit-equality printed), both step times printed;
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
5. the same on full-width zamba2-2.7b, depth cut (``CUT_LAYERS``: 18 of
   its 54 Mamba-2 blocks, the 2 shared attention blocks applied 3 times;
   random bf16 weights from seed 0): the SSD scan, flash and paged kernels
   must each run;
5b. the MoE family at full width, depth cut (``CUT_LAYERS``, through
   ``cut_model``; the cut and the weights' bytes printed): qwen3-235b-a22b (4 of 94 layers, 128
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
5d. the five configs first run on the card, at full width with their depth
   cut (``CUT_LAYERS``, printed): llama3-70b (4 of 80 layers), gemma-2b (4
   of 18), granite-3-8b (4 of 40) and granite-34b (4 of 88) each serve the
   16-request draw through the two pools (``[serve-llama3]``,
   ``[serve-gemma]``, ``[serve-granite8]``, ``[serve-granite34]``: flash on
   its tensor-core variant and paged must run, the CUDA-core flash must
   not) and hold a decode step's logits against a forward
   (``[logits-llama3]`` ...); llama3-70b's short pool is profiled as above
   with 0 host syncs required (``[profile-llama3]``); llama4-maverick (2 of
   48 layers: one dense, one MoE) decodes as scout does
   (``[moe-maverick]``). The kernel phase (2) adds flash and paged at their
   layouts: gemma's D 256 on one KV head, granite-34b's G 48 on one KV
   head, llama3-70b's H 64 K 8 (flash also at L 1024, paged also on the
   long pool) and granite-3-8b's H 32 K 8;
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
   Table-2 fleet of phase 6's 1,000-request run again with
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
7d. ``[roofline]``, after the five configs' phases: the least time on
   ``H100_SXM`` (``analytic_cost``, ``Roofline``) and the model-FLOPs share
   of ``[train]``'s step, ``[train-hybrid]``'s step and
   ``[profile-llama3]``'s decode step beside their measured times, with
   the card's name and power limit; a bound above a measured time fails
   the script. ``[dryrun]``: the dry run's command line on llama3-70b's
   decode_32k and train_4k on the 16 x 16 mesh, in a process of its own
   started when the script starts (``chip_smoke.py --dryrun-side``) and
   read here: it must exit 0, and each record must be ``ok`` with per-rank
   bytes, the three roofline terms and ``memory_analysis`` (a peak at
   least the held bytes, ``fits`` equal to the peak within the budget; held
   and peak printed). ``[mem-peak]``: the same process first counts
   ``[train]``'s step and one of ``[profile]``'s decode steps on meta
   tensors under ``MemCounter``; the card's allocator read the same two
   steps (``[train]`` takes its step on weights drawn for it alone, before
   its own steps); each meta peak must be within ``MEM_PEAK_TOL`` of the
   card's, printed by held bytes and temporaries. ``[simlint]``, after
   the build: the port's simlint over ``src/repro_torch``, clean;
8. prints the earlier design's times at the JSON line's shapes on a line
   of their own (``[prior]``, copied from PERF.md, not measured here), the
   kernels' JSON line (each entry carries the timing floor; flash and paged
   entries their variant or split count, the SSD scan its P split and CTA
   count; flash and paged also at the MoE family's head layouts, ``_g16``
   on the qwen3 serve's path, ``_g5`` on the scout run's; ``_g7`` on the
   qwen2-vl run's, ``_d64`` and ``_cross`` on the musicgen run's;
   ``_d256``, ``_g48``, ``_g8`` and ``_g4`` on the gemma-2b, granite-34b,
   llama3-70b and granite-3-8b serves' (``_g5`` also carries maverick's
   run, which has scout's layout, beside scout's);
   ``sim_decode_telemetry`` with the telemetry run's launches;
   ``flash_attention_bwd`` with the ``[train]`` run's launches,
   ``flash_attention_bwd_d80`` and ``ssd_scan_bwd`` with
   ``[train-hybrid]``'s, and with ``ssd_scan`` and ``flash_attention_d80``
   ``[train-mesh-hybrid]``'s in ``launches_by_path``;
   ``paged_attention_int8_g16``, held in phase 2 at qwen3's H 64 K 4 on
   int8 pages, with ``[decode-mesh-moe]``'s; the ``_g7``, ``_d64`` and
   ``_cross`` rows with ``[decode-mesh-vlm-audio]``'s in
   ``launches_by_path``; ``paged_attention`` and ``paged_attention_int8``
   with the lse's ms beside the same launch's without it), the card's name
   and power limit, and last
   ``{"ok": true, "device": {...}}``.

Phase 2c (the SSD backward's rows and zamba2's training) runs with the
other training phases, before serving and the DES phases, in the same
process. Each phase ends with a ``[time]`` line, the seconds since
the script started. Any failed phase raises, so the script exits non-zero and prints no result;
so does a machine without a GPU, and a directory without the repository.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import re
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

from repro_torch.configs import ShapeCell, get_config  # noqa: E402
from repro_torch.core.adaptive import AdaptiveController  # noqa: E402
from repro_torch.core.cost_model import H100_SXM, closed_form_savings  # noqa: E402
from repro_torch.core.pools import (  # noqa: E402
    PoolConfig,
    homogeneous_pool,
    n_seq_for_cmax,
)
from repro_torch.distributed.collectives import (  # noqa: E402
    make_compressed_grad_sync,
    quantize_int8,
)
from repro_torch.distributed.fault import SimulatedFailure  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward_schedule,
    backward_variant,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_plain,
)
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    combine_partials,
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
    KERNEL_CHUNK,
    P_TILE,
    bwd_group,
    bwd_variant,
    ssd_scan,
    ssd_scan_backward,
    ssd_scan_backward_plain,
    ssd_scan_plain,
)
from repro_torch.distributed.sharding import (  # noqa: E402
    AxisRules,
    distribute_tree,
    tree_placements,
    use_rules,
)
from repro_torch.launch.analytic_cost import cell_cost  # noqa: E402
from repro_torch.launch.comm_count import CommCounter  # noqa: E402
from repro_torch.launch.mem_count import MemCounter, storage_bytes  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.policy import build_policy  # noqa: E402
from repro_torch.launch.roofline import Roofline, model_flops_estimate  # noqa: E402
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
from repro_torch.training.train_loop import abstract_train_state  # noqa: E402
from repro_torch.training.tree import flatten_with_paths, leaves  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor-core
# rates, the float32 rate outside the tensor cores, and HBM3; the bf16 rate
# and HBM's are the port's ``H100_SXM`` spec, so the two stay one number.
PEAK_BF16_FLOPS = H100_SXM.peak_flops_bf16
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = H100_SXM.hbm_bw
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
# Where 0.1 leaves a config's attention scores more spread than yi-6b's
# (``temper_factor``), its reading at 0.1 is near an arg-max: which keys win
# turns on bf16 rounding, so the reading is the model's own noise as much as
# the kernels'. There the reading through the kernels may exceed the same
# steps' reading through the plain attention by LOGITS_EXCESS, half the
# logits limit: a share or tile weighed wrongly decorrelates the logits
# (0.27-1.18 rel L2 at the reference's init).
LOGITS_EXCESS = 2.5e-2
# The int8 cache's decode logits against the bf16 forward: on top of the
# above, K and V carry int8 quantization noise (half a step of amax/127 per
# value, ~0.4 % of the row's largest value) through every layer.
INT8_LOGITS_REL_TOL = 1e-1
# The SSD scan's f32 output against its plain version: the two sum the
# same chunked products in different orders (elementwise |a - b| <=
# SSD_ATOL + SSD_RTOL * |b|).
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4

DENSE, HYBRID = "yi-6b", "zamba2-2.7b"
MOE, SCOUT = "qwen3-235b-a22b", "llama4-scout-17b-a16e"
#: Four dense configs served at full width with their depth cut:
#: llama3-70b (the paper's serving model; H 64 K 8 D 128, rope_theta
#: 500,000), gemma-2b (H 8 K 1 D 256, GeGLU, tied 256,000-row head),
#: granite-3-8b (H 32 K 8, vocab 49,155 padded to 49,408) and granite-34b
#: (H 48 K 1, the plain GELU MLP). llama4-maverick (dense and top-1 MoE
#: layers alternating) decodes as scout does.
LLAMA3, GEMMA, GRANITE8, GRANITE34 = "llama3-70b", "gemma-2b", "granite-3-8b", "granite-34b"
MAVERICK = "llama4-maverick-400b-a17b"
#: Each one's phase tag and the suffix of its rows in the kernels JSON line.
WIDTH_SERVES = {LLAMA3: ("serve-llama3", "g8"), GEMMA: ("serve-gemma", "d256"),
                GRANITE8: ("serve-granite8", "g4"), GRANITE34: ("serve-granite34", "g48")}
#: The layers each depth-cut config keeps of its published depth (full
#: widths; ``cut_model``): qwen3-235b-a22b's 4 of 94 take ~22.4 GB in bf16;
#: llama4-scout's 2 of 48 ~12.9 GB; maverick's 2 of 48 (one dense and one
#: MoE layer) ~37 GB, past one card at 4; llama3-70b's 4 of 80 ~11 GB (all
#: 80 would be ~141 GB, past one card). The other three are cut for the
#: run's time: with the four dense configs at 8 layers the script read
#: 1211.6 s of its 1200 s on one H100 host (their serves are host bound,
#: each decode step's time about its launches'), so each keeps 4. zamba2's
#: serve keeps 18 of its 54 Mamba-2 blocks (3 groups: both shared attention
#: blocks run) for the same reason: whole, its serve took 194 s of a run
#: that ended at 1128.8 s on a slow host.
CUT_LAYERS = {MOE: 4, SCOUT: 2, MAVERICK: 2, LLAMA3: 4, GEMMA: 4, GRANITE8: 4, GRANITE34: 4,
              HYBRID: 18}
#: Decode steps of the scout and maverick runs (after the 8 slots' prefills).
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
#: path's, the xLSTM's and llama3-70b's are their first readings on the
#: card (qwen3-235b-a22b, 4 layers; xlstm-350m, 24 blocks; llama3-70b, 4
#: layers).
MAX_KERNELS_PER_STEP = {"profile": 1665, "profile-int8": 2081, "profile-hybrid": 3910,
                        "profile-moe": 426, "profile-xlstm": 1304, "profile-llama3": 237}
#: Profiles whose decode step must make no host sync (the MoE routing reads
#: no per-expert count on the host; the xLSTM writes its state in place;
#: llama3-70b's dense step).
SYNC_FREE_PROFILES = ("profile-moe", "profile-xlstm", "profile-llama3")
#: The earlier design's device times (ms) at the JSON line's shapes, read
#: on the same card model (NVIDIA H100 80GB HBM3, 700 W; PERF.md's table);
#: printed on their own line, never in the kernels' JSON line.
PRIOR_MS = {"flash_attention": 0.1287, "flash_attention_d80": 0.0835,
            "paged_attention": 0.0677, "paged_attention_d80": 0.0334,
            "paged_attention_int8": 0.0626, "ssd_scan": 0.0695, "sim_decode": 0.0108,
            "flash_attention_bwd": 2.1907, "flash_attention_bwd yi-6b L 1024": 0.8553,
            "flash_attention_bwd qwen3 G 16 L 1024": 1.4859,
            "flash_attention_bwd zamba2 D 80": 0.0627,
            "flash_attention_bwd musicgen D 64": 0.0587,
            "ssd_scan_bwd": 1.2050, "ssd_scan_bwd L 256": 0.1495,
            "ssd_scan_bwd L 200": 0.1479}
#: The paged rows: (name, slots, c_max); the long-pool row runs at yi-6b's
#: widths only (bf16 and int8 pages).
POOLS = (("short", 8, 512), ("long", 2, 2048))
LONG_POOL = ("long64k", 2, 65_536)

# The paper's Table 2 fleet (1,000 req/s, B_short = 8192) on the DES.
# ``requests`` is the routed run's trace length, ``cross`` the
# CUDA-against-CPU trace's and the homogeneous run's, ``profile`` the
# profiled run's. The shorter traces here and in GRID keep the whole script
# inside its 1200 s on a slow host: with 2,000-request cross and grid
# traces it read 1015.7 s on one H100 host and 1232.6 s on another.
DES = dict(trace="azure", rate=1000.0, seed=0, b_short=8192, requests=10_000, cross=1_000,
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
GRID = dict(fig6_requests=500, fig6_rate=20.0, fig6_seed=42,
            fig6_thresholds=(2048, 4096, 8192, 16_384, 32_768), cross=500,
            requests=500, ladders=(1, 4, 16), profile=100)
# Windowed telemetry (``[telemetry]``): ``[des]``'s routed run of ``DES["cross"]``
# requests with windows of ``window`` dispatched requests; the card-against-CPU
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
# f32 shape (the CUDA-core forward); zamba2's D 80 at L 256 and at
# ``[train-hybrid]``'s B 2 x L 2048.
FLASH_BWD = (
    ("yi-6b", 2, 32, 4, 128, 1024, 1024, True, torch.bfloat16),
    ("yi-6b", 2, 32, 4, 128, 2048, 2048, True, torch.bfloat16),
    ("qwen3-235b-a22b", 1, 64, 4, 128, 1024, 1024, True, torch.bfloat16),
    ("zamba2-2.7b", 1, 32, 32, 80, 256, 256, True, torch.bfloat16),
    ("zamba2-2.7b", 2, 32, 32, 80, 2048, 2048, True, torch.bfloat16),
    ("musicgen-medium", 2, 24, 24, 64, 200, 256, False, torch.bfloat16),
    ("f32", 1, 8, 2, 64, 512, 512, True, torch.float32),
)
# The FLASH_BWD rows whose three launches (delta, dkdv, dq) ``[flash-bwd]``
# times one by one from the profiler's device events, by (tag, Lq).
FLASH_BWD_LAUNCHES = (("yi-6b", 2048), ("qwen3-235b-a22b", 1024), ("zamba2-2.7b", 2048))
#: The backward's kernels by the names the profiler gives them.
BWD_KERNEL_RE = r"::(delta|dkdv|dq)(_wgmma)?_kernel<"
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
# ``[train-hybrid-grad]``: zamba2 at full width, the kernels' path against
# the plain one. In f32 each leaf (and the loss) is held to HYBRID_F32_TOL,
# six times the worst leaf read on an H100 (1.59e-5): a backward that lost
# f32 accuracy (bf16 internals read ~2**-9 relative) fails it. In bf16 each
# leaf's distance from the f32 plain gradient through the kernels may
# exceed the plain path's by HYBRID_BF16_EXCESS, 2.6 times the worst excess
# read (0.0039); the phase prints the excess of a control, the kernels'
# path with the SSD backward's dx and dlog_a rounded to bf16, beside it.
HYBRID_F32_TOL = 1e-4
HYBRID_BF16_EXCESS = 1e-2
HYBRID_BF16_LOSS_TOL = 1e-3
# ``[ssd-bwd]``: the SSD scan's backward kernel against its plain version at
# zamba2's widths (H 80 SSM heads, P = N = 64): (B, L) at the training
# phase's B 2 x L 2048, a prompt of 256 and a ragged 200; bf16 B/C as the
# model gives them, f32 x and dy, a nonzero final-state gradient. Both read
# the kernel forward's chunk states; dx and dlog_a (f32) are held to
# F32_GRAD_TOL of their largest value, dB and dC (bf16, each an f32 sum over
# 80 heads rounded once) as ``check_grad`` holds bf16 gradients.
SSD_BWD = ((2, 2048), (1, 256), (1, 200))
# ``[train-hybrid]``: zamba2 at full width with ``layers`` of its 54 Mamba-2
# blocks (``layers // attn_every`` groups, so both shared attention blocks
# and their LoRAs), the rest as ``[train]``. ``[train-hybrid-grad]``: one
# group (6 blocks, one shared attention invocation) at ``grad_batch`` x
# ``grad_seq``.
TRAIN_HYBRID = dict(layers=12, batch=2, seq=2048, steps=12, peak_lr=1e-3, remat="full",
                    grad_layers=6, grad_batch=1, grad_seq=1024)
#: The SSD backward's kernels by the names the profiler gives them (the dS
#: sweep, the chunk kernel of either variant, the sum of the dB/dC
#: partials), and the forward's.
SSD_BWD_KERNEL_RE = r"::(dstate|chunk_tc|chunk_simt|sum_groups)_kernel<"
SSD_FWD_KERNEL_RE = r"ssd_scan_kernel<"


# ``[mesh]`` / ``[train-mesh]``: the sharded path on a one-rank NCCL group.
# ``[train-mesh]``: yi-6b at full width, ``layers`` of its 32, B x L tokens,
# ``steps`` steps through ``launch.train.train`` on DTensors and the same
# steps on plain tensors (each loss within ``loss_rtol``), the mesh run's
# checkpoint at ``ckpt_at`` restored onto the mesh (``placements=``); steps
# 1 to ``ckpt_at`` - 1 are timed, as no checkpoint write overlaps them.
MESH_TRAIN = dict(layers=4, batch=2, seq=2048, steps=4, ckpt_at=3, loss_rtol=1e-3)
# ``[train-mesh-hybrid]``: zamba2 at full width with one group of Mamba-2
# blocks (``layers`` = its ``attn_every``: the fewest that apply the shared
# attention once), B x L tokens, ``steps`` steps through
# ``launch.train.train`` on DTensors and on plain tensors, no checkpoint
# written; steps 1 to ``steps`` - 1 timed.
MESH_TRAIN_HYBRID = dict(layers=6, batch=2, seq=2048, steps=4, loss_rtol=1e-3)
# ``[decode-mesh-moe]``: qwen3-235b-a22b at full width, ``layers`` of its 94,
# an int8 KV cache of ``slots`` x ``c_max`` (the short pool's), a prefill of
# ``prompt`` tokens a slot, then ``steps`` greedy decode steps, on DTensors
# and on plain tensors; steps 1 to ``steps`` - 1 timed.
MESH_DECODE_MOE = dict(layers=2, slots=8, c_max=512, prompt=128, steps=16)
# ``[train-mesh-xlstm]``: xlstm-350m at full width and depth (24 blocks),
# B x L tokens, ``steps`` steps through ``launch.train.train`` on DTensors
# and on plain tensors, no checkpoint written; the last step is timed (the
# first pays DTensor's sharding propagation, which it then caches).
MESH_TRAIN_XLSTM = dict(layers=24, batch=2, seq=256, steps=2, loss_rtol=1e-3)
# ``[decode-mesh-vlm-audio]``: qwen2-vl-7b and musicgen-medium at full width,
# ``layers`` of their 28 and 48, ``slots`` x ``c_max`` caches (musicgen's self
# and cross caches laid out along their sequence, as a model axis its 24 KV
# heads do not divide lays them out), ``prompt`` positions a slot prefilled,
# then ``steps`` greedy decode steps, on DTensors and on plain tensors; steps
# 1 to ``steps`` - 1 timed.
MESH_DECODE_EMBED = dict(layers=2, slots=8, c_max=512, prompt=128, steps=8)
# ``[dryrun]``: ``python -m repro_torch.launch.dryrun`` on llama3-70b's
# decode_32k and train_4k on the 16 x 16 mesh, a process of its own started
# with the script and read after ``[roofline]``.
DRYRUN = dict(arch="llama3-70b", shapes=("decode_32k", "train_4k"), timeout=900)
#: ``[mem-peak]``: how far the dry run's meta count of a step's peak may
#: stand from the card's (a share of the card's peak). The meta count sees
#: every storage an op makes; the card also holds what a library allocates
#: inside a call (cuBLAS's workspace) and what a cached block rounds up to.
MEM_PEAK_TOL = 0.05


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


def paged_lse_phase(dev, flush, *, heads: tuple[int, int, int], tag: str,
                    int8: bool = False) -> dict:
    """``[paged]``'s log-sum-exp at the short pool (8 slots x 512, ragged
    lengths, one inside the first half; bf16 pages, or int8 with f16
    scales): the kernel's lse against the plain version's (LSE_TOL); the
    cache cut into two halves by position, each half's kernel output and
    lse with q in f32 (as the sequence-parallel decode runs it, local
    lengths ``clamp(length - offset, 0, half)``) merged by
    ``combine_partials`` (the sequence-parallel path's function), cast once
    to bf16, against the whole cache's kernel output (KERNEL_TOL and
    ROW_ULPS a row) and its lse; a row of length 0 gives an output of 0 and
    an lse of -inf, no NaN, the other rows unchanged; the output bit for
    bit with and without the lse; the kernel's ms with and without it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    H, K, D = heads
    _, slots, c_max = POOLS[0]
    half = c_max // 2
    q = torch.randn(slots, H, D, generator=gen, device=dev).to(torch.bfloat16)
    kc = torch.randn(slots, c_max, K, D, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(slots, c_max, K, D, generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.randint(1, c_max + 1, (slots,), generator=gen, device=dev, dtype=torch.int32)
    lengths[-1] = half // 3
    sc: tuple = ()
    if int8:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
        sc = (ks, vs)

    def paged(qx, cache: tuple, lens, **kw):
        n = cache[0].shape[1]
        bt = ops.slot_block_table(slots, n, dev)
        pages = (t.view(-1, ops.PAGE, K, t.shape[-1]) for t in cache)
        k_p, v_p, *s_p = pages
        return paged_attention(qx, k_p, v_p, bt, lens, *s_p, **kw)

    cache = (kc, vc, *sc)
    out, lse = paged(q, cache, lengths, return_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(out, paged(q, cache, lengths)):
        fail(f"[paged] {tag}: the output with the lse differs from the output without it")
    bt = ops.slot_block_table(slots, c_max, dev)
    plain_out, plain_lse = paged_attention_plain(
        q, *(t.view(-1, ops.PAGE, K, t.shape[-1]) for t in cache[:2]), bt, lengths,
        *(t.view(-1, ops.PAGE, K, 1) for t in sc), return_lse=True)
    lse_err = (lse - plain_lse).abs().max().item()
    parts = [paged(q.float(), tuple(t[:, i:i + half].contiguous() for t in cache),
                   (lengths - i).clamp(0, half).to(torch.int32), return_lse=True)
             for i in (0, half)]

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    merged, merged_lse = combine_partials(torch.stack([o for o, _ in parts]),
                                          torch.stack([l_ for _, l_ in parts]), stacked)
    err, ulps = check_close(merged.to(torch.bfloat16), out, f"[paged] {tag} two halves merged")
    merged_lse_err = (merged_lse - lse).abs().max().item()
    empty = not torch.isneginf(parts[1][1][-1]).all().item()
    zero = lengths.clone()
    zero[0] = 0
    out0, lse0 = paged(q, cache, zero, return_lse=True)
    torch.cuda.synchronize()
    zero_ok = (not out0.isnan().any().item() and not lse0.isnan().any().item()
               and not out0[0].any().item() and torch.isneginf(lse0[0]).all().item()
               and torch.equal(out0[1:], out[1:]) and torch.equal(lse0[1:], lse[1:]))
    row = dict(lse_err=lse_err, merged_err=err, merged_ulps=ulps, merged_lse_err=merged_lse_err,
               ms=time_ms(lambda: paged(q, cache, lengths), flush=flush),
               lse_ms=time_ms(lambda: paged(q, cache, lengths, return_lse=True), flush=flush))
    print(f"[paged] {tag} lse at {slots} x {c_max} (lengths {lengths.tolist()}): kernel vs plain "
          f"max |diff| {lse_err:.3g} (tol {LSE_TOL}); two halves by position merged by "
          f"combine_partials vs the whole cache's kernel: err {err:.3g}, worst row {ulps:.3g} "
          f"ulps (tol {ROW_ULPS}), lse {merged_lse_err:.3g}; a row of length 0: output 0, lse "
          f"-inf, no NaN, other rows unchanged: {zero_ok}; kernel {row['ms']:.4f} ms without "
          f"the lse, {row['lse_ms']:.4f} ms with it", flush=True)
    if not lse_err <= LSE_TOL or not merged_lse_err <= LSE_TOL:
        fail(f"[paged] {tag}: lse differs from the plain version's ({lse_err}) or the merged "
             f"halves' from the whole's ({merged_lse_err}), tol {LSE_TOL}")
    if empty:
        fail(f"[paged] {tag}: the second half of a row inside the first half gave a finite lse")
    if not zero_ok:
        fail(f"[paged] {tag}: a row of length 0 gave {out0[0]}, lse {lse0[0]}")
    return row


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
    if launches.get("flash_attention_simt"):
        fail(f"{tag}: bf16 prefill took the CUDA-core flash variant")
    return {"launches": launches, "server": result["server"], "decode_tokens": decode_tokens,
            "wall_s": result["wall_s"]}


def whole_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def reset_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    flash_mod.reset_counters()
    ssd_mod.reset_counters()


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


def card_step_memory(fn, held: tuple) -> dict:
    """One call of ``fn`` on the card, as ``[mem-peak]`` compares it with
    the meta count: ``held_bytes``, the storages of the trees in ``held``
    (each rounded as the caching allocator rounds a block, as
    ``storage_bytes`` counts them on meta tensors), ``temp_bytes``, the most
    the allocator held during the call above what it held before it, and
    ``peak_bytes``, their sum."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - before
    del out
    held_bytes = storage_bytes(*held)
    return {"held_bytes": held_bytes, "temp_bytes": temp, "peak_bytes": held_bytes + temp}


def profile_decode(srv, tag: str, steps: int = 10) -> dict:
    """Where a decode step's time goes: the short pool's engine with all 8
    slots busy, ``steps`` decode steps under torch.profiler. Returns the
    step time, the device's busy share and the kernels by device time; for
    ``[profile]``, also one decode step's memory on the card (``mem``, for
    ``[mem-peak]``)."""
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
    mem = None
    if tag == "profile":  # [mem-peak]'s card side: one decode step's peak
        batch = {"tokens": torch.from_numpy(eng._token_buf[:, None]).to(eng.device),
                 "index": torch.from_numpy(eng._index_buf).to(eng.device)}
        mem = card_step_memory(lambda: eng.model.decode_step(eng.params, eng.cache.state, batch),
                               (eng.params, eng.cache.state))
        print(f"[mem-peak] a [{tag}] decode step on the card (8 slots x "
              f"{SERVE['short_cmax']}): held {mem['held_bytes'] / 1e9:.3f} GB, temporaries "
              f"{mem['temp_bytes'] / 1e9:.4f} GB, peak {mem['peak_bytes'] / 1e9:.3f} GB", flush=True)
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
    out["mem"] = mem
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
    of the same context, over the config's vocabulary (not its padding)."""
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(0, model.cfg.vocab, 150)]
    eng = ServingEngine(model, params, c_max=SERVE["short_cmax"], n_slots=1)
    eng.submit(ServeRequest(0, prompt, max_new_tokens=4))
    comps = []
    while not comps:
        comps = eng.step()
    gen = comps[0].output_tokens
    vocab = model.cfg.vocab  # the padded tail holds f32 min in both
    got = eng.last_logits[0, :vocab].float()
    ref, _ = model.forward(params, {"tokens": torch.tensor([prompt + gen[:-1]], device=got.device)})
    ref = ref[0, -1, :vocab].float()
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


def temper_attention(params: dict, keys: tuple = TEMPERED, factor: float = 0.1) -> None:
    """Scales every ``w_q`` and ``w_k`` in the tree by ``factor``, in place (the
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
            temper_attention(val, keys + SLSTM_GATES if key == "slstm" else keys, factor)
        elif key in keys:
            val.mul_(factor)


def score_spread(cfg) -> float:
    """The std of an attention score q·k/sqrt(D) at the reference's init for
    unit-RMS input: its fan-in rule draws w_q and w_k, (d, heads, D), with
    std 1/sqrt(heads), so q and k have std sqrt(d/H) and sqrt(d/K), and a
    score d/sqrt(H K)."""
    return cfg.d_model / math.sqrt(cfg.n_heads * cfg.n_kv_heads)


def temper_factor(cfg) -> float:
    """What the logits checks scale w_q and w_k by: 0.1, which leaves
    yi-6b's scores a std of 3.62, or less where 0.1 leaves a config's
    scores more spread than yi-6b's: the factor that brings them to
    yi-6b's spread. Only the one-KV-head configs pass it (gemma-2b 7.24,
    granite-34b 8.87 at 0.1); there softmax is near an arg-max at 0.1, and
    ``logits_check`` holds that reading against the plain attention's on
    the same steps (LOGITS_EXCESS) instead."""
    return 0.1 * min(1.0, math.sqrt(score_spread(get_config(DENSE)) / score_spread(cfg)))


@contextlib.contextmanager
def plain_attention():
    """The model's prefill and decode attention through the plain versions
    (``flash_attention_plain``, ``paged_attention_plain``) on the card,
    swapped in with ``unittest.mock.patch`` for the block only."""
    from unittest import mock

    with mock.patch.object(flash_mod, "flash_attention", flash_attention_plain), \
            mock.patch.object(paged_mod, "paged_attention", paged_attention_plain):
        yield


def logits_check(srv, tag: str, model=None) -> float:
    """Decode-step logits against a full forward recompute, full width.

    With the reference's init (q/k projections scaled by the head count, so
    attention scores have a std of d/sqrt(H K), 362 at yi-6b's widths, and
    softmax is an arg-max) the two paths' different bf16 roundings pick
    different keys and the logits decorrelate; that reading is printed, not
    held. The held reading scales w_q and w_k by ``temper_factor`` (in
    place, after serving), which leaves the attention soft, so the paths
    differ by bf16 rounding only. Where that factor is below 0.1 the
    reading at 0.1 is also taken through the plain attention
    (:func:`plain_attention`) on the same steps, and the kernels' may
    exceed it by LOGITS_EXCESS. ``model`` (the served one if
    None) runs both paths: the MoE family's at ``moe_group=1``, where
    prefill and forward route each token alone as decode does, so no
    capacity drop tells the paths apart.
    """
    params = srv.short_engine.params
    model = model or srv.short_engine.model
    raw = decode_vs_forward(model, params)
    print(f"[{tag}] reference init (not held): {raw}")
    factor = temper_factor(model.cfg)
    if factor < 0.1:
        temper_attention(params)
        r = decode_vs_forward(model, params)
        launched = {name: c.launches for name, c in COUNTERS.items()}
        with plain_attention():
            p = decode_vs_forward(model, params)
        if {name: c.launches for name, c in COUNTERS.items()} != launched:
            fail(f"{tag}: the plain attention's pass launched a kernel")
        excess = r["rel_l2"] - p["rel_l2"]
        print(f"[{tag}] w_q, w_k x0.1 (scores of std {0.01 * score_spread(model.cfg):.3g}, "
              f"past yi-6b's): decode step vs forward rel L2 {r['rel_l2']:.4g} through the "
              f"kernels, {p['rel_l2']:.4g} through the plain attention, excess {excess:.4g} "
              f"(limit {LOGITS_EXCESS}); argmax {r['argmax']} / {p['argmax']}")
        if not excess <= LOGITS_EXCESS:
            fail(f"{tag}: at w_q, w_k x0.1 the kernels' decode logits lie {excess} farther "
                 f"from the forward than the plain attention's (limit {LOGITS_EXCESS})")
        temper_attention(params, factor=factor / 0.1)
    else:
        temper_attention(params)
    r = decode_vs_forward(model, params)
    print(f"[{tag}] w_q, w_k x{factor:.4g}: decode step vs forward rel L2 {r['rel_l2']:.4g} "
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


def cut_config(arch: str, layers: int, tag: str):
    """``arch`` at its published widths with ``layers`` of its layers
    (``dataclasses.replace``): every depth cut of this script is made, and
    printed, here."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    moe = (f", {cfg.n_experts} experts of {cfg.moe_d_ff} top-{cfg.top_k}, "
           f"{cfg.n_shared_experts} shared, MoE every {cfg.moe_every}" if cfg.is_moe else "")
    print(f"[{tag}] {arch}: n_layers cut {full.n_layers} -> {layers} (widths as published: "
          f"d_model {cfg.d_model}, H {cfg.n_heads} K {cfg.n_kv_heads} D {cfg.head_dim}, "
          f"d_ff {cfg.d_ff} {cfg.activation}{moe}, vocab {cfg.vocab} padded to "
          f"{cfg.padded_vocab}{', tied head' if cfg.tie_embeddings else ''}, rope_theta "
          f"{cfg.rope_theta:g})", flush=True)
    return cfg


def cut_model(arch: str, layers: int, tag: str, **kw) -> Model:
    """``Model(cfg, **kw)`` of ``arch`` cut to ``layers`` layers
    (:func:`cut_config`); prints the weights' bytes and parameters."""
    model = Model(cut_config(arch, layers, tag), **kw)
    print(f"[{tag}] {model.param_bytes() / 1e9:.2f} GB of bf16 weights, "
          f"{model.active_param_count() / 1e9:.3f} B of {model.param_count() / 1e9:.3f} B "
          f"parameters active a token", flush=True)
    return model


def cut_serve_phase(dev, arch: str, tag: str,
                    kernels: tuple[str, ...] = ("flash_attention", "paged_attention")) -> dict:
    """``arch`` at full width with its depth cut (``CUT_LAYERS``) through the
    two pools on the 16-request draw, greedy, at the default ``moe_group``
    (each of ``kernels`` must run)."""
    model = cut_model(arch, CUT_LAYERS[arch], tag)
    params = model.init(0, device=dev)
    srv = TwoPoolServer(model, params, short_cmax=SERVE["short_cmax"],
                        long_cmax=SERVE["long_cmax"], short_slots=SERVE["short_slots"],
                        long_slots=SERVE["long_slots"])
    reset_counters()
    result = run_workload(srv, requests=SERVE["requests"], seed=SERVE["seed"])
    return check_served(result, arch, kernels, tag)


def width_phases(dev, stamp) -> dict:
    """The four dense configs of ``WIDTH_SERVES``, each served
    (``cut_serve_phase``) and its decode logits held against a forward
    (``[logits-*]``); llama3-70b's short pool profiled (``[profile-llama3]``,
    0 host syncs in the model's step); then maverick's decode run
    (``[moe-maverick]``). Each frees the card after it; prints the five
    phases' seconds together."""
    t0 = time.perf_counter()
    runs = {}
    for arch, (tag, _) in WIDTH_SERVES.items():
        gc.collect()
        torch.cuda.empty_cache()
        out = cut_serve_phase(dev, arch, tag)
        if arch == LLAMA3:
            out["profile"] = profile_decode(out["server"], "profile-llama3")
        out["rel_l2"] = logits_check(out["server"], tag.replace("serve", "logits"))
        del out["server"]
        runs[arch] = out
        stamp(tag)
    gc.collect()
    torch.cuda.empty_cache()
    runs[MAVERICK] = moe_decode_phase(dev, MAVERICK, "moe-maverick")
    stamp("moe-maverick")
    print(f"[time] the five configs' phases took {time.perf_counter() - t0:.1f} s together",
          flush=True)
    return runs


def moe_decode_phase(dev, arch: str, tag: str) -> dict:
    """A llama4 config (scout, maverick) at full width, its depth cut, w_q/w_k
    tempered as ``logits_check`` does: 8 slots' prefills (prompts of 100 to
    240 tokens) and ``SCOUT_STEPS`` decode steps, the launch counters set to
    0 just before and read just after (flash and paged must run), then each
    slot's last decode-step logits against a forward over its context, the
    model at ``moe_group=1`` throughout."""
    model = cut_model(arch, CUT_LAYERS[arch], tag, moe_group=1)
    cfg = model.cfg
    params = model.init(0, device=dev)
    temper_attention(params, factor=temper_factor(cfg))
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
    print(f"[{tag}] {slots} prefills and {eng.iterations} decode steps of {slots} slots in "
          f"{wall:.3f} s; kernel launches: {launches}", flush=True)
    if eng.iterations != SCOUT_STEPS or any(n == 0 for n in launches.values()):
        fail(f"{tag}: {eng.iterations} decode steps, launches {launches}")
    worst = 0.0
    for slot, st in sorted(eng.slots.items()):
        ctx = st.request.tokens + st.generated[:-1]
        ref, _ = model.forward(params, {"tokens": torch.tensor([ctx], device=dev)})
        got, ref = eng.last_logits[slot, :cfg.vocab].float(), ref[0, -1, :cfg.vocab].float()
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            fail(f"{tag}: slot {slot}: non-finite logits")
        rel = ((got - ref).norm() / ref.norm()).item()
        worst = max(worst, rel)
        print(f"[{tag}] slot {slot}: {len(ctx)} positions, decode step vs forward rel L2 "
              f"{rel:.4g}, argmax {int(got.argmax())} / {int(ref.argmax())}")
    print(f"[{tag}] worst rel L2 {worst:.4g} (tol {LOGITS_REL_TOL})", flush=True)
    if not worst <= LOGITS_REL_TOL:
        fail(f"{tag}: decode logits differ from forward: rel L2 {worst} > {LOGITS_REL_TOL}")
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
                wall_s=full["wall_s"],
                cross=dict(cols=short, records=a, stats=on_card["stats"],
                           wall_s=on_card["wall_s"]))


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
    """``[telemetry]``: the routed Table-2 fleet of ``[des]``'s
    ``DES["cross"]``-request run again (the 10,000-request run's length put
    the script near its time limit on a slow host), with windows of
    ``TELEMETRY["window"]`` dispatched requests: its records must equal
    that run's bit for bit, with the same rounds and host syncs; its export
    must validate and its windowed deltas sum to the run's counters. Then the same fleet with its
    short pool cut to ``TELEMETRY["cut"]`` of its instances and an
    ``AdaptiveController`` over windows of ``TELEMETRY["control_window"]``,
    on ``TELEMETRY["cross"]`` requests on the card and on the CPU: every
    column and the controller's history must be equal."""
    ref = des["cross"]
    decode_advance.launches = 0
    run = run_des(des["routed"], ref["cols"], dev, label="routed Table-2 fleet, telemetry",
                  tag="telemetry", telemetry=TelemetryConfig(window=TELEMETRY["window"],
                                                             events=False))
    launches = decode_advance.launches
    sim, res, stats, wall = run["sim"], run["res"], run["stats"], run["wall_s"]
    if launches == 0:
        fail("sim_decode was never launched on the telemetry run")
    tel = res.telemetry
    doc = validate_telemetry(tel.to_json())
    n = len(ref["cols"])
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
    if not same_records(record_columns(sim), ref["records"]):
        fail("telemetry: the records differ from [des]'s routed run")
    for key in ("iters", "rounds", "host_syncs"):
        if stats[key] != ref["stats"][key]:
            fail(f"telemetry: {key} {stats[key]} differs from [des]'s {ref['stats'][key]}")
    if doc["num_samples"] != n // TELEMETRY["window"] + 1:
        fail(f"telemetry: {doc['num_samples']} samples for {n} requests")
    print(f"[telemetry] routed Table-2 fleet, {n} requests, windows of {TELEMETRY['window']}: "
          f"{tel.num_samples} samples, export valid; {wall:.2f} s wall ([des] {ref['wall_s']:.2f} "
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


def width_kernel_rows(dev, flush) -> dict:
    """Flash (L 256; llama3-70b also L 1024) and paged (the short pool;
    llama3-70b also the long pool) at the layouts ``WIDTH_SERVES`` give
    them: gemma-2b's D 256 on one KV head (G 8), granite-34b's G 48 on one
    KV head (six head-group CTAs of the paged kernel), llama3-70b's H 64 K 8
    and granite-3-8b's H 32 K 8."""
    rows = {}
    for arch in WIDTH_SERVES:
        cfg = get_config(arch)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        long = arch == LLAMA3
        rows[arch] = dict(
            flash=flash_phase(dev, flush, heads=heads, lengths=(256, 1024) if long else (256,),
                              tag=arch),
            paged=paged_phase(dev, flush, heads=heads, tag=arch,
                              pools=POOLS if long else POOLS[:1]))
    return rows


def width_entries(entry, rows: dict, runs: dict) -> list:
    """The JSON line's rows of the four dense configs' serving paths: flash
    and paged at each one's layout."""
    out = []
    for arch, (_, suffix) in WIDTH_SERVES.items():
        cfg = get_config(arch)
        heads = f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.head_dim}"
        path = f"serve {arch} ({CUT_LAYERS[arch]} of {cfg.n_layers} layers)"
        launches = runs[arch]["launches"]
        for name, source, rep, row, shape in (
                ("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:96",
                 rows[arch]["flash"][256], f"{heads} L=256"),
                ("paged_attention", "paged_attention.cu", "src/repro/kernels/paged_attention.py:96",
                 rows[arch]["paged"]["short"], f"8 slots x 512, {heads}, bf16 pages")):
            out.append(entry(f"{name}_{suffix}", source, rep, path, launches[name], row, shape))
            out[-1].update({key: row[key] for key in ("variant", "splits") if key in row})
    return out


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


def bwd_launch_ms(args, causal: bool, calls: int = 5, tries: int = 3) -> dict | None:
    """Device ms of each of the backward's launches (delta, dkdv, dq), the
    mean over ``calls`` calls under the profiler. A profile that comes back
    without the three kernels is taken again, up to ``tries`` times; then
    the split is not measured (None). One run on an H100 saw every profile
    of this phase after its first come back without device events (PERF.md
    §7); the split is a measurement and gates nothing."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flash_attention_backward(*args, causal=causal)
            torch.cuda.synchronize()
        out = {}
        for e in prof.profiler.kineto_results.events():
            m = re.search(BWD_KERNEL_RE, e.name())
            if m and e.device_type() == torch.autograd.DeviceType.CUDA:
                out[m.group(1)] = out.get(m.group(1), 0.0) + e.duration_ns() / 1e6 / calls
        if set(out) == {"delta", "dkdv", "dq"}:
            return out
    print(f"[flash-bwd] per-launch split not measured: {tries} profiles show the backward's "
          f"launches as {sorted(out)}", flush=True)
    return None


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
        if (tag, lq) in FLASH_BWD_LAUNCHES:
            row["launch_ms"] = bwd_launch_ms(args, causal)
            sched = backward_schedule(B, H, K, lq, lk, causal,
                                      torch.cuda.get_device_properties(dev).multi_processor_count)
            row.update(split=sched.split, dkdv_ctas=len(sched.items), dq_ctas=sched.dq_ctas)
            split = row["launch_ms"] and {k: round(v, 4) for k, v in row["launch_ms"].items()}
            print(f"[flash-bwd] {tag} B={B} H={H} K={K} L={lq}: device ms a launch "
                  f"{split or 'not measured'}; head split "
                  f"{sched.split} of G={H // K}, dkdv {len(sched.items)} CTAs, dq "
                  f"{sched.dq_ctas} CTAs", flush=True)
        rows[(tag, lq)] = row
        print(f"[flash-bwd] {tag} B={B} H={H} K={K} D={D} Lq={lq} Lk={lk} "
              f"{'causal' if causal else 'non-causal'} {str(dtype)[6:]} variant {row['variant']}: "
              f"lse err {lse_err:.3g} "
              f"(tol {LSE_TOL}); dq/dk/dv err {[f'{e:.3g}' for e, _ in errs]}, worst row "
              f"{row['worst_row_ulps']:.3g} ulps; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"sdpa-bwd {library_ms:.4f} ms bound {bnd:.4f} ms ({by}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return rows


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
    busy share, the attention backward's share. Before the steps, one step
    on weights drawn for it alone gives ``[mem-peak]`` the card's peak
    (``mem``)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cut_config(DENSE, TRAIN["layers"], "train")
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
    # [mem-peak]'s card side: one step's peak, read by the allocator; the
    # step trains the weights, so [train]'s steps start from a fresh draw
    mem = card_step_memory(lambda: step_fn(params, opt, data.batch(0), 0), (params, opt))
    print(f"[mem-peak] [train]'s step on the card: held {mem['held_bytes'] / 1e9:.3f} GB, "
          f"temporaries {mem['temp_bytes'] / 1e9:.3f} GB, peak {mem['peak_bytes'] / 1e9:.3f} GB",
          flush=True)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    params, opt = init_train_state(model, tcfg, 0, device=dev)
    with torch.no_grad():
        temper_attention(params)
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
                 if re.search(BWD_KERNEL_RE, name)) / 1e3
    fwd_ms = sum(us for name, (_, us) in kernels.items() if "flash_tc_kernel" in name) / 1e3
    out = dict(
        launches_fwd=fwd, launches_bwd=bwd, losses=losses, step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), peak_gb=peak_gb, n_params=n_params,
        kernels_per_step=sum(c for c, _ in kernels.values()), busy_share=busy_ms / prof_wall_ms,
        attn_bwd_ms=bwd_ms, attn_bwd_share=bwd_ms / busy_ms, attn_fwd_ms=fwd_ms,
        profiled_wall_ms=prof_wall_ms, mem=mem,
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

    cfg = cut_config(DENSE, TRAIN["grad_layers"], "train-grad")
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


def mesh_phase(dev) -> dict:
    """``[mesh]``: a one-rank NCCL process group on the card (no fallback:
    if it does not start, the script fails), ``make_host_mesh(1)`` on
    cuda, and ``make_compressed_grad_sync`` over the data axis on a tree
    shaped like one yi-6b layer's gradients in bf16, against the plain
    formula, which is exact at one rank: the mean is the int8 payload times
    its scale, the new error-feedback residual what that leaves of the
    input plus the old one."""
    t0 = time.perf_counter()
    rendezvous = Path(tempfile.mkdtemp()) / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_host_mesh(model_parallel=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = Model(get_config(DENSE)).defs["blocks"]  # one entry a layer on axis 0
    grads = {k: (1e-3 * torch.randn(d.shape[1:], generator=gen, device=dev)).to(torch.bfloat16)
             for k, d in layer.items()}
    errors = {k: 1e-6 * torch.randn(g.shape, generator=gen, device=dev) for k, g in grads.items()}
    sync = make_compressed_grad_sync(mesh, ("data",))
    means, new_errors = sync(grads, errors)
    torch.cuda.synchronize()
    for k, g in grads.items():
        q, scale = quantize_int8(g.float() + errors[k])
        want = q.float() * scale
        if not (torch.equal(means[k], want)
                and torch.equal(new_errors[k], g.float() + errors[k] - want)):
            fail(f"[mesh] compressed_all_reduce of {k} differs from the one-rank formula")
    calls = 5
    t1 = time.perf_counter()
    for _ in range(calls):
        sync(grads, errors)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1) / calls
    n = sum(g.numel() for g in grads.values())
    print(f"[mesh] NCCL group of {dist.get_world_size()} rank, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"on {mesh.device_type}; compressed_all_reduce over one {DENSE} layer's {len(grads)} "
          f"gradient leaves ({n / 1e6:.1f} M bf16 values, {n / 1e6:.1f} MB of int8 payload): "
          f"equal to the one-rank formula, mean and residual bit for bit; {ms:.3f} ms a tree "
          f"(host clock, {calls} calls); phase {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(ms=ms, values=n)


def train_mesh_phase(dev) -> dict:
    """``[train-mesh]``: ``launch.train.train`` on DTensors over the
    one-rank mesh (``model_parallel=1``) and then, the group destroyed, the
    same steps from the same seed through ``train`` on plain tensors.
    Gates: each loss within ``loss_rtol`` of the plain path's (and whether
    they are bit-equal is printed); the flash forward and backward launch
    counters equal on the two paths (``local_map`` handed the kernels their
    shards); the mesh run's checkpoint at ``ckpt_at`` restored onto the
    mesh through ``placements=`` (the launcher's resume) gives the next
    step's loss equal to the uninterrupted run's. Prints both paths' step
    times (DTensor's host overhead) over steps 1 to ``ckpt_at`` - 1, which
    no checkpoint write overlaps on either path (the plain run saves only
    after its last step)."""
    import shutil

    t0 = time.perf_counter()
    kw = MESH_TRAIN
    steps = kw["steps"]
    cfg = cut_config(DENSE, kw["layers"], "train-mesh")
    run = dict(steps=steps, seq_len=kw["seq"], global_batch=kw["batch"], device=dev,
               log_every=1000)

    def launches() -> tuple[int, int]:
        return flash_attention.launches, flash_attention_backward.launches

    with tempfile.TemporaryDirectory() as d:
        reset_counters()
        mesh = train(cfg, ckpt_dir=d, ckpt_every=kw["ckpt_at"], model_parallel=1, **run)
        mesh_launches = launches()
        shutil.rmtree(Path(d) / f"step_{steps:08d}")
        resumed = train(cfg, ckpt_dir=d, ckpt_every=kw["ckpt_at"], model_parallel=1, **run)
    dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        reset_counters()
        plain = train(cfg, ckpt_dir=d, ckpt_every=steps + 1, **run)
        plain_launches = launches()
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"], plain["losses"])]
    bit_equal = mesh["losses"] == plain["losses"]
    timed = slice(1, kw["ckpt_at"])
    mesh_ms, plain_ms = (1e3 * float(np.median(r["step_s"][timed])) for r in (mesh, plain))
    print(f"[train-mesh] losses on the mesh {mesh['losses']}, on plain tensors "
          f"{plain['losses']}: largest relative difference {max(rel):.3g} (limit "
          f"{kw['loss_rtol']}), bit-equal {bit_equal}; flash launches (forward, backward) mesh "
          f"{mesh_launches}, plain {plain_launches}", flush=True)
    print(f"[train-mesh] step {mesh_ms:.1f} ms on DTensors against {plain_ms:.1f} ms on plain "
          f"tensors (median of steps 1-{kw['ckpt_at'] - 1}, no checkpoint write in flight, "
          f"host clock; each step's seconds: mesh {[round(t, 4) for t in mesh['step_s']]}, "
          f"plain {[round(t, 4) for t in plain['step_s']]}); checkpoint at step "
          f"{kw['ckpt_at']} restored onto the mesh: resumed at {resumed['start']}, next loss "
          f"{resumed['losses'][0]!r} against {mesh['losses'][kw['ckpt_at']]!r} uninterrupted; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    if max(rel) > kw["loss_rtol"]:
        fail(f"[train-mesh] mesh losses {mesh['losses']} against plain {plain['losses']}")
    if mesh_launches != plain_launches or not all(mesh_launches):
        fail(f"[train-mesh] flash launches on the mesh {mesh_launches}, plain {plain_launches}")
    if resumed["start"] != kw["ckpt_at"] or resumed["losses"][0] != mesh["losses"][kw["ckpt_at"]]:
        fail(f"[train-mesh] the restored run (start {resumed['start']}) gave "
             f"{resumed['losses']}, want {mesh['losses'][kw['ckpt_at']]} first")
    return dict(mesh_ms=mesh_ms, plain_ms=plain_ms, max_rel=max(rel), bit_equal=bit_equal)


def hybrid_launches() -> dict:
    return dict(ssd_fwd=ssd_scan.launches, ssd_bwd=ssd_scan_backward.launches,
                flash_fwd=flash_attention.launches, flash_bwd=flash_attention_backward.launches)


def train_mesh_hybrid_run(dev) -> dict:
    """``[train-mesh-hybrid]``'s mesh side, on the ``[mesh]`` phase's group:
    ``launch.train.train`` on zamba2 (MESH_TRAIN_HYBRID) on DTensors over
    the one-rank mesh, no checkpoint written, the launch counters set to 0
    just before and read just after. The plain side runs once
    ``[train-mesh]`` has destroyed the group (``train_mesh_hybrid_phase``)."""
    kw = MESH_TRAIN_HYBRID
    cfg = cut_config(HYBRID, kw["layers"], "train-mesh-hybrid")
    if cfg.n_layers != cfg.attn_every:
        fail(f"[train-mesh-hybrid] {cfg.n_layers} blocks apply the shared attention "
             f"{cfg.n_layers // cfg.attn_every} times, want once")
    with tempfile.TemporaryDirectory() as d:
        reset_counters()
        out = train(cfg, ckpt_dir=d, ckpt_every=None, model_parallel=1, **_hybrid_run(dev))
    out["launches"] = hybrid_launches()
    out["cfg"] = cfg
    return out


def _hybrid_run(dev) -> dict:
    kw = MESH_TRAIN_HYBRID
    return dict(steps=kw["steps"], seq_len=kw["seq"], global_batch=kw["batch"], device=dev,
                log_every=1000)


def train_mesh_hybrid_phase(dev, mesh: dict) -> dict:
    """``[train-mesh-hybrid]``: the plain side (no process group), the same
    steps from the same seed, then the gates: each loss within
    ``loss_rtol`` of the plain path's (bit-equality printed), and the SSD
    scan's forward and backward and the flash forward and backward
    launched as often on both sides (``local_map`` handed the kernels their
    shards: the SSM heads for the scan, the attention heads for flash).
    Prints both step times (steps 1 to ``steps`` - 1)."""
    t0 = time.perf_counter()
    kw = MESH_TRAIN_HYBRID
    with tempfile.TemporaryDirectory() as d:
        reset_counters()
        plain = train(mesh["cfg"], ckpt_dir=d, ckpt_every=None, **_hybrid_run(dev))
        plain_launches = hybrid_launches()
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"], plain["losses"])]
    bit_equal = mesh["losses"] == plain["losses"]
    timed = slice(1, kw["steps"])
    mesh_ms, plain_ms = (1e3 * float(np.median(r["step_s"][timed])) for r in (mesh, plain))
    print(f"[train-mesh-hybrid] losses on the mesh {mesh['losses']}, on plain tensors "
          f"{plain['losses']}: largest relative difference {max(rel):.3g} (limit "
          f"{kw['loss_rtol']}), bit-equal {bit_equal}; launches mesh {mesh['launches']}, plain "
          f"{plain_launches}", flush=True)
    print(f"[train-mesh-hybrid] step {mesh_ms:.1f} ms on DTensors against {plain_ms:.1f} ms on "
          f"plain tensors ({mesh_ms / plain_ms:.2f}x; median of steps 1-{kw['steps'] - 1}, no "
          f"checkpoint written, host clock; each step's seconds: mesh "
          f"{[round(t, 4) for t in mesh['step_s']]}, plain "
          f"{[round(t, 4) for t in plain['step_s']]}); plain side "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if max(rel) > kw["loss_rtol"]:
        fail(f"[train-mesh-hybrid] mesh losses {mesh['losses']} against plain {plain['losses']}")
    if mesh["launches"] != plain_launches or not all(plain_launches.values()):
        fail(f"[train-mesh-hybrid] launches on the mesh {mesh['launches']}, plain "
             f"{plain_launches}")
    return dict(mesh_ms=mesh_ms, plain_ms=plain_ms, max_rel=max(rel), bit_equal=bit_equal,
                launches=mesh["launches"])


def decode_mesh_moe_phase(dev) -> dict:
    """``[decode-mesh-moe]``, on the ``[mesh]`` phase's group: qwen3-235b-a22b
    at full width with MESH_DECODE_MOE's layers and an int8 KV cache; each
    slot's prompt prefilled and ``steps`` greedy decode steps, on DTensors
    over the one-rank mesh (the policy's placements; the experts sharded on
    the model axis) and on plain tensors, the launch counters set to 0
    just before each side's decode steps and read just after. Gates: every
    step's tokens identical on the two sides; the int8 paged kernel
    launched as often on both; one more mesh decode step under
    ``CommCounter`` all-gathers no expert weight, and every expert weight
    keeps its placements. Prints both step times."""
    t0 = time.perf_counter()
    kw = MESH_DECODE_MOE
    model = cut_model(MOE, kw["layers"], "decode-mesh-moe", kv_dtype="int8")
    cfg = model.cfg
    params = model.init(0, device=dev)
    mesh = make_host_mesh(model_parallel=1)
    cell = ShapeCell("decode-mesh-moe", "decode", kw["c_max"], kw["slots"])
    prefill_cell = ShapeCell("decode-mesh-moe", "prefill", kw["prompt"], kw["slots"])
    policy = build_policy(cfg, cell, mesh)
    rng = np.random.default_rng(4)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (kw["slots"], kw["prompt"])),
                              dtype=torch.int32, device=dev)
    placed = tree_placements(model.axes(), mesh, policy.rules)
    experts = {path: layout for path, layout in flatten_with_paths(placed)
               if path.endswith(("['w_up']", "['w_gate']", "['w_down']")) and "moe" in path}

    def run(on_mesh: bool) -> dict:
        p = distribute_tree(params, placed) if on_mesh else params
        cache = model.init_cache(cell, device=dev)
        if on_mesh:
            axes = model.cache_axes(cell, kv_shardable=policy.kv_heads_sharded)
            cache = distribute_tree(cache, tree_placements(axes, mesh, policy.rules))

        def inputs(batch: dict, c: ShapeCell) -> dict:
            if not on_mesh:
                return batch
            return distribute_tree(batch, tree_placements(model.input_axes(c), mesh,
                                                          policy.rules))

        tokens, walls = [], []
        with use_rules(policy.rules), torch.no_grad():
            logits, pre = model.prefill(p, inputs({"tokens": prompts}, prefill_cell))
            for c, t in zip(cache, pre):
                c[:, :, :kw["prompt"]].copy_(t)
            tok = whole_tensor(logits).argmax(-1).to(torch.int32)
            reset_counters()
            for i in range(kw["steps"]):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                index = torch.full((kw["slots"],), kw["prompt"] + i, dtype=torch.int32,
                                   device=dev)
                logits, cache = model.decode_step(
                    p, cache, inputs({"tokens": tok[:, None], "index": index}, cell))
                tok = whole_tensor(logits).argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
                tokens.append(tok)
            out = dict(tokens=torch.stack(tokens).cpu(), walls=walls,
                       paged=paged_attention.launches, int8=cache[0].dtype == torch.int8)
            if on_mesh:  # one more step, counted
                index = torch.full((kw["slots"],), kw["prompt"] + kw["steps"], dtype=torch.int32,
                                   device=dev)
                with CommCounter() as counter:
                    model.decode_step(p, cache, inputs({"tokens": tok[:, None], "index": index},
                                                       cell))
                out["records"] = counter.records
                out["placements"] = {path: tuple(t.placements) for path, t in
                                     flatten_with_paths(p) if path in experts}
                out["expert_bytes"] = {t.numel() * t.element_size() for path, t in
                                       flatten_with_paths(p) if path in experts}
                out["expert_bytes"] |= {b // (cfg.n_layers // cfg.moe_every)
                                        for b in out["expert_bytes"]}
        del p, cache
        return out

    on_mesh = run(True)
    plain = run(False)
    same = torch.equal(on_mesh["tokens"], plain["tokens"])
    mesh_ms, plain_ms = (1e3 * float(np.median(r["walls"][1:])) for r in (on_mesh, plain))
    gathers = [r for r in on_mesh["records"] if r[0] == "all-gather"]
    expert_gathers = [r for r in gathers if r[1] in on_mesh["expert_bytes"]]
    moved = {path: pl for path, pl in on_mesh["placements"].items()
             if pl != experts[path].placements}
    ops_seen = sorted({r[0] for r in on_mesh["records"]})
    print(f"[decode-mesh-moe] {kw['slots']} slots, prompts of {kw['prompt']} prefilled, "
          f"{kw['steps']} greedy decode steps, int8 KV cache ({on_mesh['int8']}, "
          f"{plain['int8']}): tokens identical on DTensors and plain tensors: {same}; int8 "
          f"paged launches mesh {on_mesh['paged']}, plain {plain['paged']}; the counted step's "
          f"collectives {len(on_mesh['records'])} ({ops_seen}), all-gathers of an expert "
          f"weight's bytes {len(expert_gathers)}, expert leaves moved {len(moved)} of "
          f"{len(experts)}", flush=True)
    print(f"[decode-mesh-moe] step {mesh_ms:.2f} ms on DTensors against {plain_ms:.2f} ms on "
          f"plain tensors ({mesh_ms / plain_ms:.2f}x; median of steps 1-{kw['steps'] - 1}, host "
          f"clock); phase {time.perf_counter() - t0:.1f} s", flush=True)
    if not same:
        fail(f"[decode-mesh-moe] tokens differ: mesh {on_mesh['tokens'].tolist()}, plain "
             f"{plain['tokens'].tolist()}")
    if not (on_mesh["int8"] and plain["int8"]) or on_mesh["paged"] != plain["paged"] \
            or not plain["paged"]:
        fail(f"[decode-mesh-moe] int8 paged launches mesh {on_mesh['paged']}, plain "
             f"{plain['paged']}")
    if expert_gathers or moved:
        fail(f"[decode-mesh-moe] expert weights gathered {expert_gathers} or moved {moved}")
    return dict(mesh_ms=mesh_ms, plain_ms=plain_ms, launches=on_mesh["paged"])


def train_mesh_xlstm_run(dev) -> dict:
    """``[train-mesh-xlstm]``'s mesh side, on the ``[mesh]`` phase's group:
    ``launch.train.train`` on xlstm-350m (MESH_TRAIN_XLSTM) on DTensors over
    the one-rank mesh, no checkpoint written. The plain side runs once
    ``[train-mesh]`` has destroyed the group (``train_mesh_xlstm_phase``)."""
    kw = MESH_TRAIN_XLSTM
    cfg = cut_config(XLSTM, kw["layers"], "train-mesh-xlstm")
    with tempfile.TemporaryDirectory() as d:
        out = train(cfg, ckpt_dir=d, ckpt_every=None, model_parallel=1, **_xlstm_run(dev))
    out["cfg"] = cfg
    return out


def _xlstm_run(dev) -> dict:
    kw = MESH_TRAIN_XLSTM
    return dict(steps=kw["steps"], seq_len=kw["seq"], global_batch=kw["batch"], device=dev,
                log_every=1000)


def train_mesh_xlstm_phase(dev, mesh: dict) -> dict:
    """``[train-mesh-xlstm]``: the plain side (no process group), the same
    steps from the same seed, then the gate: each loss within ``loss_rtol``
    of the plain path's (bit-equality printed: at one rank the reordered
    up-projection is the plain product). Prints both sides' last step
    time. The xLSTM's cells are plain PyTorch on both sides (its reference
    has no Pallas kernel)."""
    t0 = time.perf_counter()
    kw = MESH_TRAIN_XLSTM
    with tempfile.TemporaryDirectory() as d:
        plain = train(mesh["cfg"], ckpt_dir=d, ckpt_every=None, **_xlstm_run(dev))
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"], plain["losses"])]
    bit_equal = mesh["losses"] == plain["losses"]
    mesh_ms, plain_ms = (1e3 * r["step_s"][-1] for r in (mesh, plain))
    print(f"[train-mesh-xlstm] losses on the mesh {mesh['losses']}, on plain tensors "
          f"{plain['losses']}: largest relative difference {max(rel):.3g} (limit "
          f"{kw['loss_rtol']}), bit-equal {bit_equal}", flush=True)
    print(f"[train-mesh-xlstm] step {mesh_ms:.1f} ms on DTensors against {plain_ms:.1f} ms on "
          f"plain tensors ({mesh_ms / plain_ms:.2f}x; step {kw['steps'] - 1}, B {kw['batch']} x "
          f"L {kw['seq']}, remat full, no checkpoint written, host clock; each step's seconds: "
          f"mesh {[round(t, 4) for t in mesh['step_s']]}, plain "
          f"{[round(t, 4) for t in plain['step_s']]}); plain side "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if max(rel) > kw["loss_rtol"]:
        fail(f"[train-mesh-xlstm] mesh losses {mesh['losses']} against plain {plain['losses']}")
    return dict(mesh_ms=mesh_ms, plain_ms=plain_ms, max_rel=max(rel), bit_equal=bit_equal)


def decode_mesh_embed_phase(dev) -> dict:
    """``[decode-mesh-vlm-audio]``, on the ``[mesh]`` phase's group:
    qwen2-vl-7b and musicgen-medium at full width with MESH_DECODE_EMBED's
    layers; ``slots`` seeded prompts of ``prompt`` embeddings (qwen2-vl's
    M-RoPE positions the prompt's index on all three streams, musicgen's
    256 seeded memory embeddings) prefilled into the slot cache, then
    ``steps`` decode steps of seeded embeddings, each step's greedy tokens
    (every codebook's for musicgen) kept; on DTensors over the one-rank
    mesh (the policy's placements; musicgen's self and cross caches laid
    out along their sequence, ``kv_seq`` on the model axis, so its decode
    runs the sequence-parallel path: the paged kernel with its lse on the
    rank's positions and ``combine_partials`` over a group of one) and on
    plain tensors, the launch counters set to 0 just before each side's
    prefill and read after its last step. Gates: the tokens identical on
    the two sides; flash and paged launched as often on both (musicgen's
    counts hold its cross-attention's). Prints both step times."""
    t0 = time.perf_counter()
    kw = MESH_DECODE_EMBED
    slots, n, steps = kw["slots"], kw["prompt"], kw["steps"]
    mesh = make_host_mesh(model_parallel=1)
    cell = ShapeCell("decode-mesh-vlm-audio", "decode", kw["c_max"], slots)
    prefill_cell = ShapeCell("decode-mesh-vlm-audio", "prefill", n, slots)
    out = {}
    for arch in (VLM, AUDIO):
        model = cut_model(arch, kw["layers"], "decode-mesh-vlm-audio")
        cfg = model.cfg
        params = model.init(0, device=dev)
        policy = build_policy(cfg, cell, mesh)
        rules, kv_shardable = policy.rules, policy.kv_heads_sharded
        if cfg.cross_attention:  # as the 16-wide mesh, which 24 KV heads do not divide
            rules = AxisRules(tuple((name, "model" if name == "kv_seq" else target)
                                    for name, target in rules.rules))
            kv_shardable = False
        placed = tree_placements(model.axes(), mesh, rules)
        cache_layout = tree_placements(model.cache_axes(cell, kv_shardable=kv_shardable), mesh,
                                       rules)
        gen = torch.Generator(device=dev).manual_seed(7)
        embeds = (torch.randn(slots, n + steps, cfg.d_model, generator=gen, device=dev)
                  * 0.1).bfloat16()
        memory = (torch.randn(slots, cfg.cross_mem_len, cfg.d_model, generator=gen, device=dev)
                  * 0.1).bfloat16()

        def batch_at(cols: slice, index=None) -> dict:
            b = {"embeds": embeds[:, cols]}
            if cfg.pos_type == "mrope":
                pos = torch.arange(n + steps, device=dev, dtype=torch.int32)[cols]
                b["positions"] = pos.expand(3, slots, -1).contiguous()
            if index is None and cfg.cross_attention:
                b["memory"] = memory
            if index is not None:
                b["index"] = index
            return b

        def run(on_mesh: bool) -> dict:
            p = distribute_tree(params, placed) if on_mesh else params

            def inputs(batch: dict, c: ShapeCell) -> dict:
                if not on_mesh:
                    return batch
                axes = model.input_axes(c)
                return distribute_tree(batch, tree_placements({k: axes[k] for k in batch}, mesh,
                                                              rules))

            tokens, walls = [], []
            reset_counters()
            with use_rules(rules), torch.no_grad():
                logits, pre = model.prefill(p, inputs(batch_at(slice(0, n)), prefill_cell))
                cache = model.init_cache(cell, device=dev)
                for c, t in zip(cache, pre):
                    c[:, :, :t.shape[2]].copy_(whole_tensor(t))
                if on_mesh:
                    cache = distribute_tree(cache, cache_layout)
                placements = sorted({str(t.placements) for t in cache}) if on_mesh else None
                for i in range(steps):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    index = torch.full((slots,), n + i, dtype=torch.int32, device=dev)
                    logits, cache = model.decode_step(
                        p, cache, inputs(batch_at(slice(n + i, n + i + 1), index), cell))
                    tokens.append(whole_tensor(logits).argmax(-1))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t1)
            res = dict(tokens=torch.stack(tokens).cpu(), walls=walls, placements=placements,
                       launches=(flash_attention.launches, paged_attention.launches))
            del p, cache
            return res

        on_mesh, plain = run(True), run(False)
        same = torch.equal(on_mesh["tokens"], plain["tokens"])
        mesh_ms, plain_ms = (1e3 * float(np.median(r["walls"][1:])) for r in (on_mesh, plain))
        print(f"[decode-mesh-vlm-audio] {arch}: {slots} slots, prompts of {n} prefilled, {steps} "
              f"greedy decode steps; cache placements on the mesh {on_mesh['placements']}; "
              f"tokens {tuple(on_mesh['tokens'].shape)} identical on DTensors and plain tensors: "
              f"{same}; (flash, paged) launches mesh {on_mesh['launches']}, plain "
              f"{plain['launches']}", flush=True)
        print(f"[decode-mesh-vlm-audio] {arch}: step {mesh_ms:.2f} ms on DTensors against "
              f"{plain_ms:.2f} ms on plain tensors ({mesh_ms / plain_ms:.2f}x; median of steps "
              f"1-{steps - 1}, host clock)", flush=True)
        if not same:
            fail(f"[decode-mesh-vlm-audio] {arch}: tokens differ: mesh "
                 f"{on_mesh['tokens'].tolist()}, plain {plain['tokens'].tolist()}")
        if on_mesh["launches"] != plain["launches"] or not all(plain["launches"]):
            fail(f"[decode-mesh-vlm-audio] {arch}: launches mesh {on_mesh['launches']}, plain "
                 f"{plain['launches']}")
        if cfg.cross_attention and "Shard(dim=2)" not in " ".join(on_mesh["placements"]):
            fail(f"[decode-mesh-vlm-audio] {arch}: caches not laid out along their sequence: "
                 f"{on_mesh['placements']}")
        out[arch] = dict(mesh_ms=mesh_ms, plain_ms=plain_ms, flash=on_mesh["launches"][0],
                         paged=on_mesh["launches"][1])
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[decode-mesh-vlm-audio] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def roofline_phase(trained: dict, trained_hybrid: dict, llama3: dict, smi: str) -> dict:
    """``[roofline]``: the least time of three measured steps on one H100
    from ``analytic_cost`` and ``Roofline`` on ``H100_SXM`` (one rank, no
    collectives; causal attention counted as the triangle the flash kernel
    computes, every layer rematerialized as the steps are), beside the
    measured time, with the model-FLOPs share (6 N D for training, 2 N D a
    decoded token, over the measured time at the bf16 peak). A bound above
    the measured time is a counting fault and fails the script."""
    out = {}
    cells = (
        ("train", DENSE, TRAIN["layers"], ShapeCell("train", "train", TRAIN["seq"], TRAIN["batch"]),
         trained["step_ms"]),
        ("train-hybrid", HYBRID, TRAIN_HYBRID["layers"],
         ShapeCell("train-hybrid", "train", TRAIN_HYBRID["seq"], TRAIN_HYBRID["batch"]),
         trained_hybrid["step_ms"]),
        ("profile-llama3", LLAMA3, CUT_LAYERS[LLAMA3],
         ShapeCell("profile-llama3", "decode", SERVE["short_cmax"], SERVE["short_slots"]),
         llama3["profile"]["step_ms"]),
    )
    for tag, arch, layers, cell, measured_ms in cells:
        model = Model(cut_config(arch, layers, "roofline"))
        cost = cell_cost(model.cfg, cell, model.param_count(), causal_mode="triangle",
                         remat="full", optimizer="adamw")
        roof = Roofline(cost.flops_total, cost.hbm_bytes, 0.0, 1, hw=H100_SXM)
        train_cell = cell.kind == "train"
        tokens = cell.global_batch * (cell.seq_len if train_cell else 1)
        model_flops = model_flops_estimate(model.active_param_count(), tokens, train=train_cell)
        share = model_flops / (measured_ms / 1e3 * H100_SXM.peak_flops_bf16)
        bound_ms = 1e3 * roof.bound_s
        out[tag] = dict(bound_ms=bound_ms, dominant=roof.dominant, measured_ms=measured_ms,
                        model_flops_share=share, compute_ms=1e3 * roof.compute_s,
                        memory_ms=1e3 * roof.memory_s)
        print(f"[roofline] {tag}: bound {bound_ms:.3f} ms ({roof.dominant}: compute "
              f"{1e3 * roof.compute_s:.3f} ms for {cost.flops_total / 1e12:.2f} TFLOP, memory "
              f"{1e3 * roof.memory_s:.3f} ms for {cost.hbm_bytes / 1e9:.2f} GB) against "
              f"{measured_ms:.3f} ms measured ({bound_ms / measured_ms:.3f} of it); model-FLOPs "
              f"share {share:.4f} ({model_flops / 1e12:.2f} TFLOP of 6/2 N D); {smi}", flush=True)
        if bound_ms > measured_ms:
            fail(f"[roofline] {tag}: bound {bound_ms:.3f} ms above the measured {measured_ms:.3f} ms")
    return out


def meta_step_memory() -> dict:
    """``[mem-peak]``'s meta side (in the ``[dryrun]`` process, on its CPU):
    ``[train]``'s step (the same config, AdamW state and batch) and one of
    ``[profile]``'s decode steps (yi-6b, 8 slots x the short pool's
    c_max) on meta tensors under ``MemCounter``, each with its arguments'
    storages as the held bytes: what the dry run counts, at shapes the
    card runs."""
    cfg = dataclasses.replace(get_config(DENSE), n_layers=TRAIN["layers"])
    model = Model(cfg, remat=TRAIN["remat"])
    tcfg = TrainConfig(peak_lr=TRAIN["peak_lr"], warmup_steps=max(2, TRAIN["steps"] // 20),
                       total_steps=TRAIN["steps"])
    step_fn, _ = make_train_step(model, tcfg)
    params, opt = abstract_train_state(model, tcfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                   global_batch=TRAIN["batch"])).batch(0)
    with MemCounter(storage_bytes(params, opt)) as mem:
        step_fn(params, opt, batch, 0)
    out = {"train": mem.stats()}
    model = Model(get_config(DENSE))
    params = model.abstract()
    cache = SlotKVCache(model, SERVE["short_cmax"], SERVE["short_slots"], device="meta").state
    slots = SERVE["short_slots"]
    batch = {"tokens": torch.zeros((slots, 1), dtype=torch.int32, device="meta"),
             "index": torch.zeros((slots,), dtype=torch.int32, device="meta")}
    with MemCounter(storage_bytes(params, cache)) as mem:
        model.decode_step(params, cache, batch)
    out["decode"] = mem.stats()
    return out


def dryrun_side(out: Path) -> None:
    """The ``[dryrun]`` process's work (``chip_smoke.py --dryrun-side OUT``):
    ``[mem-peak]``'s meta steps into ``OUT/mem_meta.json``, then the dry
    run's command line on ``DRYRUN``'s cells, its records under ``OUT``."""
    (out / "mem_meta.json").write_text(json.dumps(meta_step_memory()))
    from repro_torch.launch import dryrun

    sys.argv = ["dryrun", "--arch", DRYRUN["arch"], "--shape", *DRYRUN["shapes"],
                "--out", str(out)]
    dryrun.main()


def start_dryrun() -> tuple[subprocess.Popen, float, Path]:
    """``[dryrun]``'s process, started at once so that it runs beside the
    card's phases (a process has one process group; the dry run's is fake).
    It is killed at exit if the script ends before reading it."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    out = Path(tempfile.mkdtemp(prefix="dryrun_"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--dryrun-side", str(out)]
    # files, not pipes: nothing reads the process until [dryrun], and a full
    # pipe would stall it
    with open(out / "stdout", "w") as stdout, open(out / "stderr", "w") as stderr:
        proc = subprocess.Popen(cmd, env=env, stdout=stdout, stderr=stderr)
    atexit.register(proc.kill)
    return proc, time.perf_counter(), out


def dryrun_phase(proc: subprocess.Popen, started: float, out: Path) -> list:
    """``[dryrun]``: waits for the dry run's process (a failing one fails
    the script) and gates each record: status ok, per-rank bytes, the three
    roofline terms, and ``memory_analysis``: a peak at least the held
    bytes, and ``fits`` equal to the peak within the budget."""
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=DRYRUN["timeout"])
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"[dryrun] did not end within {DRYRUN['timeout']} s")
    stdout, stderr = ((out / name).read_text() for name in ("stdout", "stderr"))
    if proc.returncode != 0:
        fail(f"[dryrun] exited {proc.returncode}: {stderr[-2000:]}")
    records = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    for line in stdout.splitlines():
        if line.startswith("["):
            print(f"[dryrun] {line}")
    if len(records) != len(DRYRUN["shapes"]):
        fail(f"[dryrun] {len(records)} records, want {len(DRYRUN['shapes'])}")
    for rec in records:
        r = rec["roofline"]
        if rec["status"] != "ok" or not rec["bytes_per_rank"]["total"] or "fits" not in rec or not all(
                isinstance(r[k], float) and r[k] > 0 for k in ("compute_s", "memory_s", "collective_s")):
            fail(f"[dryrun] record incomplete: {rec}")
        mem = rec.get("memory_analysis") or {}
        if not {"argument_bytes", "peak_bytes", "temp_bytes"} <= set(mem):
            fail(f"[dryrun] {rec['shape']}: memory_analysis incomplete: {mem}")
        budget = H100_SXM.mem_util * H100_SXM.hbm_bytes
        if (mem["peak_bytes"] < mem["argument_bytes"] or mem["temp_bytes"] != mem["peak_bytes"]
                - mem["argument_bytes"] or rec["fits"] != (mem["peak_bytes"] <= budget)):
            fail(f"[dryrun] {rec['shape']}: peak {mem['peak_bytes']} against held "
                 f"{mem['argument_bytes']}, fits {rec['fits']} against a budget of {budget:.0f}")
        print(f"[dryrun] {DRYRUN['arch']} {rec['shape']}: held {mem['argument_bytes'] / 1e9:.3f} "
              f"GB, peak {mem['peak_bytes'] / 1e9:.3f} GB a rank"
              + (" (a lower bound)" if "lower_bound" in mem else "")
              + f", fits {rec['fits']} ({budget / 1e9:.1f} GB budget)", flush=True)
    print(f"[dryrun] {len(records)} records of {DRYRUN['arch']} on pod16x16, ok; the process "
          f"ran beside the card's phases from {t0 - started:.1f} s before this phase; waited "
          f"{time.perf_counter() - t0:.1f} s for it", flush=True)
    return records


def mem_peak_phase(out: Path, card: dict) -> dict:
    """``[mem-peak]``: the dry run's meta count of ``[train]``'s step and of
    a ``[profile]`` decode step (``mem_meta.json`` from the ``[dryrun]``
    process) against the card's reading of the same steps: the peaks must
    be within ``MEM_PEAK_TOL`` of the card's; printed by held bytes and by
    temporaries."""
    meta = json.loads((out / "mem_meta.json").read_text())
    for name, what in (("train", f"[train]'s step ({DENSE} {TRAIN['layers']} layers, "
                                 f"B={TRAIN['batch']} L={TRAIN['seq']}, remat "
                                 f"{TRAIN['remat']}, AdamW)"),
                       ("decode", f"a [profile] decode step ({DENSE}, "
                                  f"{SERVE['short_slots']} slots x {SERVE['short_cmax']})")):
        c, m = card[name], meta[name]
        rel = (m["peak_bytes"] - c["peak_bytes"]) / c["peak_bytes"]
        print(f"[mem-peak] {what}: card held {c['held_bytes'] / 1e9:.4f} GB + temporaries "
              f"{c['temp_bytes'] / 1e9:.4f} GB = {c['peak_bytes'] / 1e9:.4f} GB; meta held "
              f"{m['held_bytes'] / 1e9:.4f} GB + {m['temp_bytes'] / 1e9:.4f} GB = "
              f"{m['peak_bytes'] / 1e9:.4f} GB; meta - card: held "
              f"{(m['held_bytes'] - c['held_bytes']) / 1e6:+.2f} MB, temporaries "
              f"{(m['temp_bytes'] - c['temp_bytes']) / 1e6:+.2f} MB, peak {100 * rel:+.3f} %",
              flush=True)
        if abs(rel) > MEM_PEAK_TOL:
            fail(f"[mem-peak] {name}: the meta peak is {100 * rel:+.2f} % from the card's "
                 f"(at most {100 * MEM_PEAK_TOL:.0f} %)")
    return meta


def simlint_phase() -> None:
    """``[simlint]``: the port's simlint (``repro_torch.analysis``) over
    ``src/repro_torch``; any finding fails the script."""
    from repro_torch.analysis.core import (
        SourceFile,
        analyze_files,
        default_rules,
        iter_python_files,
    )

    t0 = time.perf_counter()
    files = [SourceFile.load(p) for p in iter_python_files([SRC / "repro_torch"])]
    rules = default_rules()
    findings = analyze_files(files, rules)
    ms = 1e3 * (time.perf_counter() - t0)
    for f in findings:
        print(f"[simlint] {f.format()}")
    print(f"[simlint] {'clean' if not findings else f'{len(findings)} finding(s)'}: "
          f"{len(files)} files, {len(rules)} rules ({', '.join(r.name for r in rules)}), "
          f"{ms:.0f} ms", flush=True)
    if findings:
        fail(f"[simlint] {len(findings)} finding(s) in src/repro_torch")


def ssd_bwd_bytes(B: int, H: int, L: int, P: int, N: int, group: int, bc_size: int) -> dict:
    """The bytes each launch of the SSD backward's tensor-core design reads
    and writes, by arithmetic from the design (each read and write the
    kernels issue, L2 re-reads included: B and C, which every CTA of a
    (batch, chunk) or a (batch, head) reads again, come mostly from L2, so
    device memory sees fewer). MB by launch; not a measurement."""
    nck, parts, f = -(-L // KERNEL_CHUNK), -(-H // group), 4
    bhlp, state, grads = f * B * H * L * P, f * B * H * nck * P * N, 2 * f * B * parts * L * N
    sweep = (bhlp + f * B * H * L + B * H * -(-P // 32) * -(-N // 64) * L * min(N, 64) * bc_size
             + f * B * H * P * N + state)
    chunk = (3 * bhlp + 2 * state + 2 * f * B * H * L + B * nck * parts * 2 * 64 * N * bc_size
             + grads)
    sums = grads + 2 * bc_size * B * L * N
    return {k: v / 1e6 for k, v in dict(sweep=sweep, chunk=chunk, sum=sums).items()}


def ssd_bwd_split_ms(args, calls: int = 5, tries: int = 3) -> dict | None:
    """Device ms of each of the SSD backward's launches (the sweep, the
    chunk kernel, the partials' sum; any other device activity of the call
    under its own name), the mean over ``calls`` calls under the profiler.
    A profile without the three launches is taken again, up to ``tries``
    times; then the split is not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ssd_scan_backward(*args)
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            m = re.search(SSD_BWD_KERNEL_RE, e.name())
            key = m.group(1) if m else e.name()[:60]
            out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6 / calls
        if {"dstate", "sum_groups"} <= set(out) and ("chunk_tc" in out or "chunk_simt" in out):
            return out
    print(f"[ssd-bwd] per-launch split not measured: {tries} profiles show the backward's "
          f"launches as {sorted(out)}", flush=True)
    return None


def ssd_bwd_phase(dev, flush) -> dict:
    """``[ssd-bwd]``: the SSD scan's backward kernel against
    ``ssd_scan_backward_plain`` at SSD_BWD's shapes (zamba2's widths, bf16
    B/C, f32 x and dy, a nonzero final-state gradient; both from the kernel
    forward's chunk states), two launches bit for bit, the kernel, plain and
    bound ms, the chunk kernel's variant and head group, the CTAs of the
    sweep and the chunk kernel, each launch's device ms (profiler), the
    bytes the design moves by arithmetic (``ssd_bwd_bytes``) against the
    bound's. At the training shape the forward's ms with the chunk states
    written and without, y and the final state bit
    for bit equal between the two. The bound counts the bytes the function
    must move (x, dy and the chunk states read, dx written in f32; log_a, B,
    C, the final state's gradient, dlog_a, dB, dC) and its fewest FLOPs at
    the TF32 tensor-core rate over three passes, as ``[ssd_scan]`` does,
    beside the f32 CUDA-core bound."""
    cfg = get_config(HYBRID)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for B, L in SSD_BWD:
        gen = torch.Generator(device=dev).manual_seed(13)
        dt = torch.rand((B, H, L), generator=gen, device=dev) * 0.19 + 0.01
        a = -(torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
        x = torch.randn((B, H, L, P), generator=gen, device=dev) * dt[..., None]
        log_a = (a[None, :, None] * dt).contiguous()
        bm = torch.randn((B, L, N), generator=gen, device=dev).to(torch.bfloat16)
        cm = torch.randn((B, L, N), generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn((B, H, L, P), generator=gen, device=dev)
        ds = torch.randn((B, H, P, N), generator=gen, device=dev)
        y, s_final, states = ssd_scan(x, log_a, bm, cm, return_states=True)
        args = (x, log_a, bm, cm, dy, ds, states)
        grads = ssd_scan_backward(*args)
        again = ssd_scan_backward(*args)
        torch.cuda.synchronize()
        name = f"ssd-bwd B={B} H={H} P={P} N={N} L={L}"
        bit_equal = all(torch.equal(g, h) for g, h in zip(grads, again))
        if not bit_equal:
            fail(f"{name}: two launches differ")
        refs = ssd_scan_backward_plain(*args)
        errs = [check_grad(g, r, f"{name} d{n}")
                for n, g, r in zip(("x", "log_a", "B", "C"), grads, refs)]
        del refs
        nck = -(-L // KERNEL_CHUNK)
        nbytes = (4 * (3 * B * H * L * P + B * H * nck * P * N + 2 * B * H * L + B * H * P * N)
                  + 2 * 4 * B * L * N)
        # the fewest FLOPs: twice the forward's, each of its products having
        # two of the same size in the gradient (one for each operand)
        flops = 2 * B * H * ssd_min_flops(L, P, N)
        bnd, by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS / 3)
        f32_bnd, f32_by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        ms = time_ms(lambda: ssd_scan_backward(*args), flush=flush)
        plain_ms = time_ms(lambda: ssd_scan_backward_plain(*args), flush=flush)
        variant, group = bwd_variant(P, N), bwd_group(B, H, L, sms)
        ctas = dict(sweep=-(-P // 32) * -(-N // 64) * H * B, chunk=nck * -(-H // group) * B)
        moved = ssd_bwd_bytes(B, H, L, P, N, group, bm.element_size())
        split = ssd_bwd_split_ms(args)
        row = dict(B=B, L=L, max_abs_err=max(e for e, _ in errs),
                   worst_row_ulps=max(u for _, u in errs), ms=ms, plain_ms=plain_ms,
                   bound_ms=bnd, bound_by=by, library_ms=None, bit_equal=bit_equal,
                   variant=variant, group=group, ctas=ctas, split_ms=split)
        print(f"[ssd-bwd] B={B} H={H} P={P} N={N} L={L} bf16 B/C: dx/dlog_a/dB/dC max "
              f"|kernel - plain| {[f'{e:.3g}' for e, _ in errs]} (f32 limit {F32_GRAD_TOL} x "
              f"the largest value; bf16 as the flash backward's), worst bf16 row "
              f"{row['worst_row_ulps']:.3g} ulps; two launches bit-equal {bit_equal}; kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bnd:.4f} ms ({by}; 3xTF32 at "
              f"{PEAK_TF32_FLOPS / 3e12:.0f} TFLOP/s), f32 CUDA-core bound {f32_bnd:.4f} ms "
              f"({f32_by}); chunk kernel {variant}, {group} heads a CTA; CTAs {ctas['sweep']} "
              f"(dS sweep) + {ctas['chunk']} (chunks); no single PyTorch call computes this "
              f"gradient", flush=True)
        split_txt = ("not measured" if split is None else
                     ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        print(f"[ssd-bwd] B={B} L={L} launches (device ms a call, profiler): {split_txt}; bytes "
              f"the design moves by arithmetic, L2 re-reads included (not measured) "
              f"{sum(moved.values()):.1f} MB "
              f"({', '.join(f'{k} {v:.1f}' for k, v in moved.items())}) against the bound's "
              f"{nbytes / 1e6:.1f} MB", flush=True)
        if (B, L) == SSD_BWD[0]:
            y0, s0 = ssd_scan(x, log_a, bm, cm)
            torch.cuda.synchronize()
            if not (torch.equal(y0, y) and torch.equal(s0, s_final)):
                fail(f"{name}: the forward's y or final state changes when it writes the "
                     f"chunk states")
            row["fwd_ms"] = time_ms(lambda: ssd_scan(x, log_a, bm, cm), flush=flush)
            row["fwd_states_ms"] = time_ms(lambda: ssd_scan(x, log_a, bm, cm, return_states=True),
                                           flush=flush)
            print(f"[ssd-bwd] forward at B={B} L={L}: {row['fwd_ms']:.4f} ms without the chunk "
                  f"states, {row['fwd_states_ms']:.4f} ms writing them "
                  f"({4 * B * H * nck * P * N / 1e6:.1f} MB); y and the final state bit for bit "
                  f"equal", flush=True)
        rows[(B, L)] = row
        del grads, again, states, args
    return rows


def train_hybrid_phase(dev) -> dict:
    """``[train-hybrid]``: TRAIN_HYBRID's steps of ``make_train_step`` on
    zamba2-2.7b at full width, 12 of its 54 Mamba-2 blocks (two groups, so
    both shared attention blocks and their LoRAs), every group
    rematerialized, w_q/w_k tempered by 0.1 as ``[train]`` tempers them.
    Gates: every loss finite, the last three below the first; exactly two
    SSD forward launches (the forward and its recompute) and one SSD
    backward, on its tensor-core chunk kernel, a block and step; two flash forwards and one backward, on
    tensor cores, a shared attention invocation and step. Then one step
    under the profiler: kernels a step, the device's busy share, the SSD
    backward's and forward's shares of the device time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cut_config(HYBRID, TRAIN_HYBRID["layers"], "train-hybrid")
    groups = cfg.n_layers // cfg.attn_every
    model = Model(cfg, remat=TRAIN_HYBRID["remat"])
    steps = TRAIN_HYBRID["steps"]
    tcfg = TrainConfig(peak_lr=TRAIN_HYBRID["peak_lr"], warmup_steps=max(2, steps // 20),
                       total_steps=steps)
    step_fn, _ = make_train_step(model, tcfg)
    params, opt = init_train_state(model, tcfg, 0, device=dev)
    with torch.no_grad():
        temper_attention(params)
    n_params = sum(p.numel() for p in leaves(params))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_HYBRID["seq"],
                                  global_batch=TRAIN_HYBRID["batch"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses, walls = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, data.batch(i), i)
        losses.append(float(metrics["loss"]))  # syncs
        walls.append(time.perf_counter() - t0)
    launches = dict(ssd_fwd=ssd_scan.launches, ssd_bwd=ssd_scan_backward.launches,
                    ssd_bwd_tc=ssd_scan_backward.launches_tc,
                    flash_fwd=flash_attention.launches, flash_bwd=flash_attention_backward.launches,
                    flash_bwd_tc=flash_attention_backward.launches_tc)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train-hybrid] {HYBRID} {cfg.n_layers} of {get_config(HYBRID).n_layers} Mamba-2 "
          f"blocks and {groups} shared attention invocations at full width ({n_params / 1e9:.3f} G "
          f"parameters, bf16; AdamW f32 moments), B={TRAIN_HYBRID['batch']} "
          f"L={TRAIN_HYBRID['seq']}, remat {TRAIN_HYBRID['remat']}, peak lr "
          f"{TRAIN_HYBRID['peak_lr']}: losses {[round(x, 4) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"[train-hybrid] a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"[train-hybrid] the last three losses {losses[-3:]} are not below the first "
             f"{losses[0]}")
    want = dict(ssd_fwd=2 * cfg.n_layers * steps, ssd_bwd=cfg.n_layers * steps,
                ssd_bwd_tc=cfg.n_layers * steps, flash_fwd=2 * groups * steps, flash_bwd=groups * steps,
                flash_bwd_tc=groups * steps)
    if launches != want:
        fail(f"[train-hybrid] launches {launches} in {steps} steps, want {want}")
    step_ms = 1e3 * float(np.median(walls[2:]))
    tokens = TRAIN_HYBRID["batch"] * TRAIN_HYBRID["seq"]

    # one more step under the profiler; a profile that comes back without
    # device events (every profile after the first did in one run of the
    # flash backward's rows, ``bwd_launch_ms``) is taken again on the next
    # step once, and then the shares are not measured (None)
    for step in range(steps, steps + 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, data.batch(step), step)
            float(metrics["loss"])
            prof_wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = device_activities(prof)
        if kernels:
            break
    busy_ms = sum(us for _, us in kernels.values()) / 1e3 or None

    def device_ms(pattern: str) -> float | None:
        if not kernels:
            return None
        return sum(us for name, (_, us) in kernels.items() if re.search(pattern, name)) / 1e3

    def share(ms):
        return None if ms is None else ms / busy_ms

    ssd_bwd_ms, ssd_fwd_ms = device_ms(SSD_BWD_KERNEL_RE), device_ms(SSD_FWD_KERNEL_RE)
    attn_ms = kernels and device_ms(BWD_KERNEL_RE) + device_ms("flash_tc_kernel") or None
    out = dict(
        launches=launches, losses=losses, step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
        peak_gb=peak_gb, n_params=n_params,
        kernels_per_step=sum(c for c, _ in kernels.values()) or None,
        busy_share=busy_ms and busy_ms / prof_wall_ms,
        ssd_bwd_ms=ssd_bwd_ms, ssd_bwd_share=share(ssd_bwd_ms), ssd_fwd_ms=ssd_fwd_ms,
        ssd_fwd_share=share(ssd_fwd_ms), attn_ms=attn_ms, profiled_wall_ms=prof_wall_ms,
    )
    print(f"[train-hybrid] step {step_ms:.1f} ms (median of steps 2-{steps - 1}; first "
          f"{1e3 * walls[0]:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB; launches in {steps} steps {launches}", flush=True)
    if not kernels:
        print(f"[train-hybrid] profiled step: wall {prof_wall_ms:.1f} ms; device time not "
              f"measured (two profiles came back without device events)", flush=True)
    else:
        print(f"[train-hybrid] profiled step: wall {prof_wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ({100 * out['busy_share']:.1f}% of the wall), "
              f"{out['kernels_per_step']} kernels; SSD backward {ssd_bwd_ms:.1f} ms "
              f"({100 * out['ssd_bwd_share']:.1f}% of the device time), SSD forward "
              f"{ssd_fwd_ms:.1f} ms ({100 * out['ssd_fwd_share']:.1f}%), attention forward and "
              f"backward {attn_ms:.2f} ms", flush=True)
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    for name, (count, us) in top:
        print(f"[train-hybrid]   {us / 1e3:9.3f} ms {count:5d}x  {name[:80]}")
    del params, opt, metrics
    return out


class _PlainSSD:
    """Stands in for the SSD scan's autograd Function in
    ``[train-hybrid-grad]``: autograd through the plain scan."""

    @staticmethod
    def apply(x, log_a, b_mat, c_mat):
        return ssd_scan_plain(x, log_a, b_mat, c_mat)


def train_hybrid_grad_phase(dev) -> dict:
    """``[train-hybrid-grad]``: the loss and every gradient leaf of zamba2
    at full width (one group: 6 Mamba-2 blocks and one shared attention
    invocation; w_q/w_k tempered) through the kernels, against the same
    with autograd through ``ssd_scan_plain`` and ``flash_attention_plain``
    (swapped in here only, with ``unittest.mock.patch``), relative L2 a
    leaf. In f32 (the parameters widened; the kernels' f32 variants) each
    leaf and the loss are held to HYBRID_F32_TOL. In bf16 the two paths sit
    about 3 % apart (0.037 the worst leaf on an H100), and that is the bf16
    path's own noise: each leaf's distance from the f32 plain gradients is
    within 0.004 of the other path's. So in bf16 each leaf's distance from
    the f32 plain gradient through the kernels may exceed the plain path's
    by at most HYBRID_BF16_EXCESS, and the loss differs by at most
    HYBRID_BF16_LOSS_TOL. A control, the kernels' path with the SSD
    backward's dx and dlog_a rounded to bf16, shows what that gate sees of
    a backward that keeps bf16 precision; it is printed, not gated."""
    from unittest import mock

    cfg = cut_config(HYBRID, TRAIN_HYBRID["grad_layers"], "train-hybrid-grad")
    groups = cfg.n_layers // cfg.attn_every
    model = Model(cfg)
    params = model.init(1, device=dev)
    temper_attention(params)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_HYBRID["grad_seq"],
                                 global_batch=TRAIN_HYBRID["grad_batch"])).batch(0)
    batch = {k: torch.as_tensor(x, device=dev) for k, x in raw.items()}

    def widened(tree: dict) -> dict:
        return {k: widened(v) if isinstance(v, dict) else v.detach().float()
                for k, v in tree.items()}

    def value_and_grad(ps: dict, plain: bool):
        p_leaves = leaves(ps)
        for p in p_leaves:
            p.requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(flash_mod, "FlashAttention", _PlainFlash))
                stack.enter_context(mock.patch.object(ssd_mod, "SSDScan", _PlainSSD))
            loss, _ = model.loss(ps, batch)
            return loss.detach().float().item(), torch.autograd.grad(loss, p_leaves)

    def rel(got, want) -> list[float]:
        return [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
                for a, b in zip(got, want)]

    reset_counters()
    p32 = widened(params)
    loss32_k, g32_k = value_and_grad(p32, plain=False)
    loss32_p, g32_p = value_and_grad(p32, plain=True)
    loss_k, g_k = value_and_grad(params, plain=False)
    loss_p, g_p = value_and_grad(params, plain=True)
    launched = (ssd_scan_backward.launches, flash_attention_backward.launches)
    if launched != (2 * cfg.n_layers, 2 * groups):
        fail(f"[train-hybrid-grad] (SSD, flash) backward launches {launched} in two kernel "
             f"passes (want {(2 * cfg.n_layers, 2 * groups)}), none in the plain ones")
    real = ssd_mod.SSDScan

    class BwdInBf16(torch.autograd.Function):
        """``SSDScan`` with its backward's dx and dlog_a rounded to bf16."""

        @staticmethod
        def forward(ctx, x, log_a, b_mat, c_mat):
            return real.forward(ctx, x, log_a, b_mat, c_mat)

        @staticmethod
        def backward(ctx, dy, ds_final):
            dx, dla, db, dc = real.backward(ctx, dy, ds_final)
            return (dx.to(torch.bfloat16).to(dx.dtype), dla.to(torch.bfloat16).to(dla.dtype),
                    db, dc)

    with mock.patch.object(ssd_mod, "SSDScan", BwdInBf16):
        _, g_ctrl = value_and_grad(params, plain=False)
    rel32 = rel(g32_k, g32_p)
    loss_rel32 = abs(loss32_k - loss32_p) / abs(loss32_p)
    plain_dist = rel(g_p, g32_p)
    excess = [a - b for a, b in zip(rel(g_k, g32_p), plain_dist)]
    control = [a - b for a, b in zip(rel(g_ctrl, g32_p), plain_dist)]
    direct = rel(g_k, g_p)
    out = dict(worst_rel_f32=max(rel32), loss_rel_f32=loss_rel32, worst_excess_bf16=max(excess),
               worst_excess_bf16_control=max(control),
               worst_rel_bf16=max(direct), median_rel_bf16=float(np.median(direct)),
               loss_rel_bf16=abs(loss_k - loss_p) / abs(loss_p), leaves=len(rel32))
    print(f"[train-hybrid-grad] {HYBRID} {cfg.n_layers} Mamba-2 blocks and {groups} shared "
          f"attention full width B={TRAIN_HYBRID['grad_batch']} L={TRAIN_HYBRID['grad_seq']}, "
          f"{len(rel32)} gradient leaves. f32: loss {loss32_k:.6f} kernels vs {loss32_p:.6f} plain "
          f"(rel {loss_rel32:.3g}), worst leaf rel L2 {max(rel32):.4g} (limit {HYBRID_F32_TOL}), "
          f"median {float(np.median(rel32)):.4g}. bf16: loss rel {out['loss_rel_bf16']:.3g} "
          f"(limit {HYBRID_BF16_LOSS_TOL}), kernels vs plain worst leaf {max(direct):.4g}, "
          f"median {out['median_rel_bf16']:.4g}; distance from the f32 plain gradients through "
          f"the kernels less the plain path's, worst leaf {max(excess):.4g} (limit "
          f"{HYBRID_BF16_EXCESS}); control with the SSD backward's dx and dlog_a rounded to "
          f"bf16: {max(control):.4g}", flush=True)
    if not (max(rel32) <= HYBRID_F32_TOL and loss_rel32 <= HYBRID_F32_TOL
            and max(excess) <= HYBRID_BF16_EXCESS
            and out["loss_rel_bf16"] <= HYBRID_BF16_LOSS_TOL):
        fail(f"[train-hybrid-grad] gradients differ: {out}")
    return out


def ptxas_kernels(report: str, pattern: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) of each entry function in a
    ``ptxas -v`` report whose mangled name matches ``pattern``; the kernel
    named ``<name><D>`` (its int template argument) or ``<name><bf16>`` /
    ``<name><f32>`` (its element type)."""
    out = []
    for chunk in report.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        if not re.search(pattern, mangled):
            continue
        name = re.search(r"\d+([a-z_]*" + pattern + r")", mangled)
        dim = re.search(r"ILi(\d+)E", mangled)
        tag = (dim.group(1) if dim else "bf16" if "nv_bfloat16" in mangled
               else "f32" if "IfE" in mangled else "?")
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((f"{name.group(1) if name else mangled}<{tag}>",
                    int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else 0))
    return out


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

    dryrun = start_dryrun()
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
    if not mma["flash_attention_bwd"]["HGMMA"]:
        fail("the flash_attention_bwd library has no HGMMA (wgmma) instruction")
    if not (mma["ssd_scan_bwd"]["HGMMA"] or mma["ssd_scan_bwd"]["HMMA"]):
        fail("the ssd_scan_bwd library has no HGMMA or HMMA (tensor-core) instruction")
    for name, regs, spill in ptxas_kernels(reports["ssd_scan_bwd"], "_kernel"):
        print(f"[build] ssd_scan_bwd {name}: {regs} registers a thread, {spill} bytes of spill "
              f"stores")
    for name, regs, spill in ptxas_kernels(reports["flash_attention"], "flash_tc_kernel"):
        print(f"[build] flash_attention {name}: {regs} registers a thread, {spill} bytes of spill "
              f"stores")
    for name, regs, spill in ptxas_kernels(reports["flash_attention_bwd"], "wgmma_kernel"):
        print(f"[build] flash_attention_bwd {name}: {regs} registers a thread at launch "
              f"(setmaxnreg: producer 40, consumers 232), {spill} bytes of spill stores")
    for line in reports["flash_attention_bwd"].splitlines():
        if "Performance Loss" in line or "serialized" in line:
            print(f"[build] flash_attention_bwd ptxas: {line.strip()}")
    simlint_phase()

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
    paged_lse = paged_lse_phase(dev, flush, heads=dense_heads, tag=DENSE)
    paged8_lse = paged_lse_phase(dev, flush, heads=dense_heads, tag=f"{DENSE} int8", int8=True)
    ssd_rows = ssd_phase(dev, flush)
    moe_cfg, scout_cfg = get_config(MOE), get_config(SCOUT)
    moe_heads = (moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.head_dim)
    scout_heads = (scout_cfg.n_heads, scout_cfg.n_kv_heads, scout_cfg.head_dim)
    flash_g16 = flash_phase(dev, flush, heads=moe_heads, lengths=(256, 1024), tag=MOE)
    flash_g5 = flash_phase(dev, flush, heads=scout_heads, lengths=(256,), tag=SCOUT)
    paged_g16 = paged_phase(dev, flush, heads=moe_heads, tag=MOE)
    paged_g5 = paged_phase(dev, flush, heads=scout_heads, tag=SCOUT, pools=POOLS[:1])
    paged8_g16 = paged_phase(dev, flush, heads=moe_heads, tag=f"{MOE} int8", int8=True,
                             pools=POOLS[:1])
    embed_rows = embed_kernel_rows(dev, flush)
    width_rows = width_kernel_rows(dev, flush)
    bwd_rows = flash_bwd_phase(dev, flush)
    ssd_bwd_rows = ssd_bwd_phase(dev, flush)
    stamp("build and kernel rows")
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_phase(dev)
    train_restart_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    trained_hybrid = train_hybrid_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_hybrid_grad_phase(dev)
    stamp("training")
    gc.collect()
    torch.cuda.empty_cache()
    t_mesh = time.perf_counter()
    mesh_phase(dev)
    stamp("mesh")
    decoded_mesh = decode_mesh_moe_phase(dev)
    stamp("decode-mesh-moe")
    gc.collect()
    torch.cuda.empty_cache()
    decoded_embed = decode_mesh_embed_phase(dev)
    stamp("decode-mesh-vlm-audio")
    xlstm_on_mesh = train_mesh_xlstm_run(dev)  # its plain side needs the group gone
    stamp("train-mesh-xlstm (mesh side)")
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_on_mesh = train_mesh_hybrid_run(dev)  # its plain side needs the group gone
    stamp("train-mesh-hybrid (mesh side)")
    train_mesh_phase(dev)
    stamp("train-mesh")
    trained_mesh_hybrid = train_mesh_hybrid_phase(dev, hybrid_on_mesh)
    stamp("train-mesh-hybrid")
    train_mesh_xlstm_phase(dev, xlstm_on_mesh)
    mesh_s = time.perf_counter() - t_mesh
    stamp("train-mesh-xlstm")
    gc.collect()
    torch.cuda.empty_cache()

    served = serve_phase(DENSE, ("flash_attention", "paged_attention"), "serve")
    decode_mem = profile_decode(served["server"], "profile")["mem"]
    served8 = serve_int8_phase(served["server"])  # before logits_check tempers the weights
    profile_decode(served8["server"], "profile-int8")
    logits_check(served["server"], "logits")
    logits_int8_check(served8["server"])
    served_launches, int8_launches = served["launches"], served8["launches"]
    del served, served8
    stamp("yi-6b serves")
    gc.collect()
    torch.cuda.empty_cache()

    hybrid = cut_serve_phase(dev, HYBRID, "serve-hybrid",
                             ("flash_attention", "paged_attention", "ssd_scan"))
    profile_decode(hybrid["server"], "profile-hybrid")
    logits_check(hybrid["server"], "logits-hybrid")
    del hybrid["server"]
    stamp("zamba2 serve")
    gc.collect()
    torch.cuda.empty_cache()

    moe = cut_serve_phase(dev, MOE, "serve-moe")
    profile_decode(moe["server"], "profile-moe")
    cut = moe["server"].short_engine.model.cfg
    logits_check(moe["server"], "logits-moe", model=Model(cut, moe_group=1))
    del moe["server"]
    stamp("qwen3 serve")
    gc.collect()
    torch.cuda.empty_cache()
    scout = moe_decode_phase(dev, SCOUT, "moe-scout")
    stamp("scout decode")
    width_runs = width_phases(dev, stamp)
    gc.collect()
    torch.cuda.empty_cache()
    t_roof = time.perf_counter()
    roofline_phase(trained, trained_hybrid, width_runs[LLAMA3], smi)
    dryrun_phase(*dryrun)
    mem_peak_phase(dryrun[2], {"train": trained["mem"], "decode": decode_mem})
    print(f"[time] [mesh], [decode-mesh-moe], [decode-mesh-vlm-audio], [train-mesh], "
          f"[train-mesh-hybrid], [train-mesh-xlstm], [roofline] and the wait for [dryrun] took "
          f"{mesh_s + time.perf_counter() - t_roof:.1f} s together", flush=True)
    stamp("roofline, dryrun and mem-peak")
    embed_runs = new_model_phases(dev, stamp)
    gc.collect()
    torch.cuda.empty_cache()

    des = des_phase(dev, flush)
    stamp("des")
    grid = grid_phase(dev, flush, des)
    stamp("grid")
    telemetry = telemetry_phase(dev, des)
    stamp("telemetry")
    tables_phase(dev, des)
    del flush
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
    hybrid_serve = (f"serve {HYBRID} ({CUT_LAYERS[HYBRID]} of {get_config(HYBRID).n_layers} "
                    f"Mamba-2 blocks)")
    kernels = [
        entry("flash_attention", flash_src, flash_rep, f"serve {DENSE}",
              served_launches["flash_attention"], flash_rows[256], "H=32 K=4 D=128 L=256"),
        entry("flash_attention_d80", flash_src, flash_rep, hybrid_serve,
              h_launch["flash_attention"], flash80[256], "H=32 K=32 D=80 L=256"),
        entry("paged_attention", paged_src, paged_rep, f"serve {DENSE}",
              served_launches["paged_attention"], paged_rows["short"],
              "8 slots x 512, H=32 K=4 D=128, bf16 pages"),
        entry("paged_attention_d80", paged_src, paged_rep, hybrid_serve,
              h_launch["paged_attention"], paged80["short"],
              "8 slots x 512, H=32 K=32 D=80, bf16 pages"),
        entry("paged_attention_int8", paged_src, "src/repro/kernels/paged_attention.py:69",
              f"serve {DENSE} kv_dtype=int8", int8_launches["paged_attention"],
              paged8["short"], "8 slots x 512, H=32 K=4 D=128, int8 pages, f16 scales"),
        entry("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:91", hybrid_serve,
              h_launch["ssd_scan"], ssd_rows[256], "B=1 H=80 P=64 N=64 L=256"),
        entry("sim_decode", "sim_decode.cu", "src/repro/kernels/sim_decode.py:243",
              "DES routed Table-2 fleet", des["launches"], des["kernel"],
              f"(G, P, I, S) = {des['kernel']['shape']}"),
        entry("sim_decode_grid", "sim_decode.cu", "src/repro/kernels/sim_decode.py:243",
              f"run_fleet_grid, Table-2 fleet, {max(GRID['ladders'])} threshold lanes",
              grid["launches"], grid["kernel"], f"(G, P, I, S) = {grid['kernel']['shape']}"),
    ]
    moe_path = f"serve {MOE} ({CUT_LAYERS[MOE]} of {get_config(MOE).n_layers} layers)"
    # maverick decodes at scout's layout (H 40 K 8 D 128): its launches join
    # scout's on the _g5 rows, path by path.
    maverick = width_runs[MAVERICK]
    g5_paths = {arch: f"decode {arch} ({CUT_LAYERS[arch]} of {get_config(arch).n_layers} "
                      f"layers), 8 slots" for arch in (SCOUT, MAVERICK)}
    g5_path = "; ".join(g5_paths.values())
    kernels += [
        entry("flash_attention_g16", flash_src, flash_rep, moe_path,
              moe["launches"]["flash_attention"], flash_g16[256], "H=64 K=4 D=128 L=256"),
        entry("paged_attention_g16", paged_src, paged_rep, moe_path,
              moe["launches"]["paged_attention"], paged_g16["short"],
              "8 slots x 512, H=64 K=4 D=128, bf16 pages"),
        entry("flash_attention_g5", flash_src, flash_rep, g5_path,
              scout["launches"]["flash_attention"] + maverick["launches"]["flash_attention"],
              flash_g5[256], "H=40 K=8 D=128 L=256"),
        entry("paged_attention_g5", paged_src, paged_rep, g5_path,
              scout["launches"]["paged_attention"] + maverick["launches"]["paged_attention"],
              paged_g5["short"], "8 slots x 512, H=40 K=8 D=128, bf16 pages"),
    ]
    for k in kernels[-2:]:
        name = k["name"].removesuffix("_g5")
        k["launches_by_path"] = {g5_paths[SCOUT]: scout["launches"][name],
                                 g5_paths[MAVERICK]: maverick["launches"][name]}
    kernels += embed_entries(entry, embed_rows, embed_runs)
    # [decode-mesh-vlm-audio]'s launches (the mesh side's; the plain side's
    # are equal by its gate) beside each row's own path: qwen2-vl's on its
    # G 7 rows, musicgen's (self and cross attention together, its decode
    # on sequence-sharded caches) on its D 64 rows
    for arch, names in ((VLM, ("g7",)), (AUDIO, ("d64", "cross"))):
        mesh_path = (f"prefill and decode {arch} ({MESH_DECODE_EMBED['layers']} of "
                     f"{get_config(arch).n_layers} layers) on DTensors over a one-rank NCCL mesh, "
                     f"{MESH_DECODE_EMBED['slots']} slots, {MESH_DECODE_EMBED['steps']} steps"
                     + (", caches sharded along their sequence" if arch == AUDIO else ""))
        for k in kernels:
            if k["name"].endswith(names) and k["name"].startswith(("flash", "paged")):
                run = decoded_embed[arch]["flash" if k["name"].startswith("flash") else "paged"]
                k["launches_by_path"] = {k["path"]: k["launches"], mesh_path: run}
    kernels += width_entries(entry, width_rows, width_runs)
    kernels[4]["dequant_ms"] = paged8["short"]["dequant_ms"]
    for k, row in ((kernels[2], paged_lse), (kernels[4], paged8_lse)):
        k.update(lse_ms=row["lse_ms"], no_lse_ms=row["ms"], lse_err=row["lse_err"])
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
    kernels[-1].update({key: bwd_rows[(DENSE, TRAIN["seq"])][key]
                        for key in ("variant", "split", "dkdv_ctas", "dq_ctas", "launch_ms")})
    hybrid_path = (f"train {HYBRID} ({TRAIN_HYBRID['layers']} of {get_config(HYBRID).n_layers} "
                   f"Mamba-2 blocks), {TRAIN_HYBRID['steps']} steps")
    kernels.append(
        entry("flash_attention_bwd_d80", "flash_attention_bwd.cu",
              "src/repro/models/layers.py:108 (no Pallas kernel: the reference differentiates "
              "its jnp attention with jax.grad)", hybrid_path,
              trained_hybrid["launches"]["flash_bwd"], bwd_rows[(HYBRID, TRAIN_HYBRID["seq"])],
              f"B={TRAIN_HYBRID['batch']} H=32 K=32 D=80 L={TRAIN_HYBRID['seq']} causal"))
    kernels[-1].update({key: bwd_rows[(HYBRID, TRAIN_HYBRID["seq"])][key]
                        for key in ("variant", "split", "dkdv_ctas", "dq_ctas", "launch_ms")})
    ssd_train = ssd_bwd_rows[SSD_BWD[0]]
    kernels.append(
        entry("ssd_scan_bwd", "ssd_scan_bwd.cu",
              "src/repro/models/ssm.py:27 (no Pallas kernel: the reference differentiates its "
              "jnp ssd_chunked with jax.grad)", hybrid_path,
              trained_hybrid["launches"]["ssd_bwd"], ssd_train,
              f"B={SSD_BWD[0][0]} H=80 P=64 N=64 L={SSD_BWD[0][1]}, bf16 B/C"))
    kernels[-1].update({key: ssd_train[key] for key in (
        "variant", "group", "ctas", "split_ms", "fwd_ms", "fwd_states_ms")})
    kernels.append(
        entry("sim_decode_telemetry", "sim_decode.cu", "src/repro/kernels/sim_decode.py:243",
              f"DES routed Table-2 fleet, {DES['cross']} requests, telemetry windows of "
              f"{TELEMETRY['window']}",
              telemetry["launches"], des["kernel"], f"(G, P, I, S) = {des['kernel']['shape']}"))
    kernels.append(
        entry("paged_attention_int8_g16", paged_src, "src/repro/kernels/paged_attention.py:69",
              f"decode {MOE} ({MESH_DECODE_MOE['layers']} of {get_config(MOE).n_layers} layers) "
              f"kv_dtype=int8 on DTensors over a one-rank NCCL mesh, "
              f"{MESH_DECODE_MOE['steps']} steps", decoded_mesh["launches"], paged8_g16["short"],
              "8 slots x 512, H=64 K=4 D=128, int8 pages, f16 scales"))
    kernels[-1].update(dequant_ms=paged8_g16["short"]["dequant_ms"],
                       splits=paged8_g16["short"]["splits"])
    # [train-mesh-hybrid]'s launches (the mesh side's; the plain side's are
    # equal by its gate) beside each kernel's own path
    mesh_hybrid_path = (f"train {HYBRID} ({MESH_TRAIN_HYBRID['layers']} Mamba-2 blocks) on "
                        f"DTensors over a one-rank NCCL mesh, {MESH_TRAIN_HYBRID['steps']} steps")
    for name, key in (("ssd_scan", "ssd_fwd"), ("ssd_scan_bwd", "ssd_bwd"),
                      ("flash_attention_d80", "flash_fwd"), ("flash_attention_bwd_d80", "flash_bwd")):
        k = next(k for k in kernels if k["name"] == name)
        k["launches_by_path"] = {k["path"]: k["launches"],
                                 mesh_hybrid_path: trained_mesh_hybrid["launches"][key]}
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
    if sys.argv[1:2] == ["--dryrun-side"]:
        dryrun_side(Path(sys.argv[2]))
    else:
        main()
