"""Core contribution of the paper: token-budget-aware pool routing.

Public API (the counterpart of ``repro.core``'s, name for name; the
reference's ``jax_*`` batch functions are the plain-named tensor functions
here):

* ``EmaCalibrator`` / ``CalibState`` — self-calibrating bytes-per-token EMA,
  scalar and batch (``update``, ``update_stream``, ``estimate_budget``).
* ``TokenBudgetRouter`` / ``Request`` — Algorithm 1 dispatch (N-pool), and
  its batch form ``route_batch`` / ``pool_ids``.
* ``AdaptiveController`` — N-boundary AIMD threshold control (§7/§8).
* ``PoolConfig`` / ``PoolSet`` / ``short_pool`` / ``long_pool`` — pool
  definitions and the budget-ordered pool family.
* ``closed_form_savings`` / ``corrected_savings`` — Eq. 7 / Eq. 8.
"""

from repro_torch.core.adaptive import (
    AdaptiveController,
    AdaptiveThreshold,
    BoundaryMove,
)
from repro_torch.core.calibration import (
    CalibState,
    EmaCalibrator,
    estimate_budget,
    init_state,
    update,
    update_stream,
)
from repro_torch.core.categories import (
    CATEGORY_NAMES,
    COLD_START_RATIO,
    NUM_CATEGORIES,
    TRUE_BYTES_PER_TOKEN,
    Category,
)
from repro_torch.core.cost_model import (
    A100_80G,
    LLAMA3_70B_KV,
    MI300X,
    QWEN3_235B_KV,
    TPU_V5E,
    HardwareSpec,
    KVModelSpec,
    annual_cost,
    annual_savings,
    closed_form_savings,
    corrected_savings,
    dual_fleet_naive,
    homogeneous_fleet,
    mi300x_case_study,
)
from repro_torch.core.pools import (
    KV_BLOCK_TOKENS,
    TOTAL_KV_BLOCKS,
    PoolConfig,
    PoolSet,
    PoolState,
    dual_pool_fleet,
    fleet_instances,
    homogeneous_pool,
    long_pool,
    n_seq_for_cmax,
    short_pool,
)
from repro_torch.core.router import (
    LONG,
    SHORT,
    Request,
    RouteDecision,
    TokenBudgetRouter,
    pool_ids,
    route_batch,
)

__all__ = [
    "AdaptiveController",
    "AdaptiveThreshold",
    "BoundaryMove",
    "CalibState",
    "EmaCalibrator",
    "init_state",
    "estimate_budget",
    "update",
    "update_stream",
    "Category",
    "CATEGORY_NAMES",
    "COLD_START_RATIO",
    "NUM_CATEGORIES",
    "TRUE_BYTES_PER_TOKEN",
    "HardwareSpec",
    "KVModelSpec",
    "A100_80G",
    "MI300X",
    "TPU_V5E",
    "LLAMA3_70B_KV",
    "QWEN3_235B_KV",
    "annual_cost",
    "annual_savings",
    "closed_form_savings",
    "corrected_savings",
    "dual_fleet_naive",
    "homogeneous_fleet",
    "mi300x_case_study",
    "PoolConfig",
    "PoolSet",
    "PoolState",
    "KV_BLOCK_TOKENS",
    "TOTAL_KV_BLOCKS",
    "dual_pool_fleet",
    "fleet_instances",
    "homogeneous_pool",
    "long_pool",
    "n_seq_for_cmax",
    "short_pool",
    "Request",
    "RouteDecision",
    "TokenBudgetRouter",
    "route_batch",
    "pool_ids",
    "SHORT",
    "LONG",
]
