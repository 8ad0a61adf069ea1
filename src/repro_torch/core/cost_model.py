"""Closed-form cost model (paper §1.1 Eq. 1–2, §3 Eq. 6–8, §4.7 Table 5).

Everything here is analytical: plug in a traffic CDF and profiled throughput,
get fleet sizes and dollar savings — no infrastructure change required
(paper contribution 3). The DES in ``repro_torch.sim`` provides the definitive
numbers; this module provides the audit-ahead estimates and the memory-side
capacity math.

Hardware adaptation note (DESIGN.md §3): Eq. 1–2 are hardware-neutral — only
the byte constants change between A100, MI300X and TPU v5e. Copied from
``repro.core.cost_model``, whose ``TPU_V5E`` also feeds the reference's
``launch/roofline.py`` (not ported yet).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.pools import KV_BLOCK_TOKENS, TOTAL_KV_BLOCKS


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-accelerator capacity + roofline constants."""

    name: str
    hbm_bytes: float
    mem_util: float  # u in Eq. 2 (gpu_memory_utilization)
    cost_per_hour: float  # $/accelerator-hr
    peak_flops_bf16: float  # FLOP/s
    hbm_bw: float  # bytes/s
    ici_bw: float  # bytes/s per link (interconnect)
    accelerators_per_node: int = 8


A100_80G = HardwareSpec(
    name="A100-80GB",
    hbm_bytes=80e9,
    mem_util=0.90,
    cost_per_hour=2.21,  # AWS p4d.24xlarge per-GPU (paper §4.2)
    peak_flops_bf16=312e12,
    hbm_bw=2.039e12,
    ici_bw=600e9 / 2,  # NVLink3 bidirectional/2
    accelerators_per_node=8,
)

MI300X = HardwareSpec(
    name="MI300X",
    hbm_bytes=192e9,
    mem_util=0.90,  # paper §4.7: 10% safety margin
    cost_per_hour=3.67,  # paper Table 5 cloud rate
    peak_flops_bf16=1.3e15,
    hbm_bw=5.3e12,
    ici_bw=128e9,
    accelerators_per_node=8,
)

#: Target platform for this reproduction (roofline constants from the
#: assignment: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
TPU_V5E = HardwareSpec(
    name="TPU-v5e",
    hbm_bytes=16e9,
    mem_util=0.90,
    cost_per_hour=1.20,  # on-demand us-central ballpark
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    accelerators_per_node=4,  # 2x2 tray
)

#: The port's card: NVIDIA H100 SXM5 80GB, data-sheet dense rates at the
#: full 700 W power limit (989 TFLOP/s bf16, 3.35 TB/s HBM3). ``ici_bw`` is
#: the per-GPU InfiniBand NDR rate (400 Gb/s = 50 GB/s a direction): the
#: production meshes' 16-wide model axis spans two 8-GPU nodes, so its rings
#: cross the network; inside a node NVLink 4 gives 450e9 B/s a direction.
#: ``cost_per_hour``: AWS p5.48xlarge (8 x H100 SXM) on-demand in us-east-1,
#: $98.32 an hour at its 2023 launch list price, per GPU.
H100_SXM = HardwareSpec(
    name="H100-SXM-80GB",
    hbm_bytes=80e9,
    mem_util=0.90,
    cost_per_hour=98.32 / 8,
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw=50e9,
    accelerators_per_node=8,
)


@dataclasses.dataclass(frozen=True)
class KVModelSpec:
    """The model-side constants of Eq. 1 (+ weights/activations for Eq. 2)."""

    name: str
    n_layers: int
    n_kv_heads: int
    head_dim: int
    kv_dtype_bytes: int = 2  # BF16 KV (even under FP8 weights — paper §4.7)
    weight_bytes_total: float = 0.0  # all-shard model weights in bytes
    activation_bytes_per_gpu: float = 0.0
    tensor_parallel: int = 1

    # -- Eq. 1 ---------------------------------------------------------------
    def kv_bytes_per_token(self) -> float:
        """2 · n_l · n_h · d_h · b_dtype — whole-model KV bytes per token."""
        return (
            2.0
            * self.n_layers
            * self.n_kv_heads
            * self.head_dim
            * self.kv_dtype_bytes
        )

    def kv_bytes_per_token_per_gpu(self) -> float:
        return self.kv_bytes_per_token() / self.tensor_parallel

    def m_seq(self, c_max: int) -> float:
        """Eq. 1: KV bytes reserved per sequence (whole model)."""
        return self.kv_bytes_per_token() * c_max

    # -- Eq. 2 ---------------------------------------------------------------
    def kv_budget_per_gpu(self, hw: HardwareSpec) -> float:
        """HBM left for KV pages: M_gpu·u − M_model − M_act (per GPU)."""
        weights_per_gpu = self.weight_bytes_total / self.tensor_parallel
        return (
            hw.hbm_bytes * hw.mem_util
            - weights_per_gpu
            - self.activation_bytes_per_gpu
        )

    def n_seq_memory(self, hw: HardwareSpec, c_max: int) -> int:
        """Eq. 2: max concurrent sequences from the memory budget."""
        budget = self.kv_budget_per_gpu(hw)
        per_seq = self.kv_bytes_per_token_per_gpu() * c_max
        if budget <= 0:
            return 0
        return int(budget // per_seq)

    def n_seq_blocks(self, c_max: int, *, max_slots: int = 128) -> int:
        """Appendix-A block-budget slots (matches the paper's Table 1)."""
        blocks_per_seq = math.ceil(c_max / KV_BLOCK_TOKENS)
        return max(0, min(max_slots, TOTAL_KV_BLOCKS // blocks_per_seq))


# Published model specs used by the paper -----------------------------------

LLAMA3_70B_KV = KVModelSpec(
    name="Llama-3-70B",
    n_layers=80,
    n_kv_heads=8,
    head_dim=128,
    kv_dtype_bytes=2,
    weight_bytes_total=140e9,  # 70B BF16
    activation_bytes_per_gpu=4e9,
    tensor_parallel=8,
)

QWEN3_235B_KV = KVModelSpec(
    name="Qwen3-235B-A22B",
    n_layers=94,
    n_kv_heads=4,
    head_dim=128,
    kv_dtype_bytes=2,  # BF16 KV under FP8 weights
    weight_bytes_total=235e9,  # FP8 weights: 1 byte/param
    activation_bytes_per_gpu=10e9,  # paper §4.7
    tensor_parallel=8,
)


# ---------------------------------------------------------------------------
# Fleet economics (Eq. 6–8)
# ---------------------------------------------------------------------------


def closed_form_savings(alpha: float, rho: float) -> float:
    """Eq. 7: savings = α (1 − 1/ρ).

    α: short-traffic fraction F(B_short); ρ: μ(C_S)/μ(C_H) ≥ 1.
    This is the *planning* estimate; it assumes the long pool keeps the
    homogeneous throughput. For heavy tails use :func:`corrected_savings`.
    """
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0,1], got {alpha}")
    if rho <= 0:
        raise ValueError(f"rho must be positive, got {rho}")
    return alpha * (1.0 - 1.0 / rho)


def homogeneous_fleet(rate: float, mu_homo: float, headroom: float = 1.0) -> int:
    """Eq. 6 first term degenerate case: G_homo = ceil(λ/μ(C_H))·β."""
    return max(1, math.ceil(rate / mu_homo * headroom))


def dual_fleet_naive(
    rate: float, alpha: float, mu_short: float, mu_homo: float
) -> int:
    """Eq. 6 with the *naive* long-pool throughput μ(C_H)."""
    g = 0
    if alpha > 0:
        g += math.ceil(alpha * rate / mu_short)
    if alpha < 1.0:
        g += math.ceil((1.0 - alpha) * rate / mu_homo)
    return max(1, g)


def corrected_savings(
    rate: float,
    alpha: float,
    mu_short: float,
    mu_long_routed: float,
    mu_homo: float,
    *,
    headroom_homo: float = 1.0,
    headroom_short: float = 1.0,
    headroom_long: float = 1.0,
) -> tuple[float, int, int]:
    """Eq. 8 savings. Returns (fraction, G_homo, G_dual).

    μ_long_routed is the long pool's throughput under *routed* (long-only)
    traffic — the quantity whose omission makes Eq. 7 over-predict by up to
    4× on heavy-tailed workloads (paper §4.2, §5).
    """
    g_homo = homogeneous_fleet(rate, mu_homo, headroom_homo)
    g_short = (
        max(1, math.ceil(alpha * rate / mu_short * headroom_short))
        if alpha > 0
        else 0
    )
    g_long = (
        max(1, math.ceil((1.0 - alpha) * rate / mu_long_routed * headroom_long))
        if alpha < 1.0
        else 0
    )
    g_dual = g_short + g_long
    return (g_homo - g_dual) / g_homo, g_homo, g_dual


def annual_cost(instances: int, hw: HardwareSpec, accel_per_instance: int) -> float:
    """$/yr for a fleet of `instances` serving instances."""
    return instances * accel_per_instance * hw.cost_per_hour * 24 * 365


def annual_savings(
    g_homo: int, g_dual: int, hw: HardwareSpec, accel_per_instance: int
) -> float:
    return annual_cost(g_homo - g_dual, hw, accel_per_instance)


# ---------------------------------------------------------------------------
# §4.7 case-study helper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CaseStudyResult:
    kv_kb_per_token_per_gpu: float
    kv_budget_gb_per_gpu: float
    n_seq_short: int
    n_seq_long: int
    concurrency_ratio: float


def mi300x_case_study(
    spec: KVModelSpec = QWEN3_235B_KV,
    hw: HardwareSpec = MI300X,
    *,
    c_short: int = 8192,
    c_long: int = 32_768,
) -> CaseStudyResult:
    """Reproduce the §4.7 memory math: 23.5 KB/token/GPU, 133.4 GB KV budget,
    676 vs 169 concurrent sequences (4×)."""
    kv_kb = spec.kv_bytes_per_token_per_gpu() / 1024
    budget = spec.kv_budget_per_gpu(hw)
    n_short = spec.n_seq_memory(hw, c_short)
    n_long = spec.n_seq_memory(hw, c_long)
    return CaseStudyResult(
        kv_kb_per_token_per_gpu=kv_kb,
        kv_budget_gb_per_gpu=budget / 1e9,
        n_seq_short=n_short,
        n_seq_long=n_long,
        concurrency_ratio=n_short / max(1, n_long),
    )
