"""Discrete-event simulator for fleet sizing / latency / reliability
(paper Appendix A: instance DES, analytical profiler, fleet verification);
the port of ``repro.sim``.

Three interchangeable fleet backends (``FleetSim(backend=...)``); the
default is ``"torch"`` on ``device="cuda"``, and the host tiers run only
when a caller names them:

* ``"reference"`` — scalar engine (:mod:`repro_torch.sim.engine`): one
  Python object per sequence; ground truth for unit tests.
* ``"vectorized"`` — struct-of-arrays engine
  (:mod:`repro_torch.sim.vector_engine`): all instances of a pool step
  together in masked NumPy ops with event-distance jumps, epoch-batched
  N-way routing and EMA sync on tensors, consuming traces natively as
  :class:`~repro_torch.traces.generator.TraceColumns`.
* ``"torch"`` — device engine (:mod:`repro_torch.sim.torch_engine`), the
  counterpart of the reference's compiled ``jax`` tier: the whole event
  loop as eager PyTorch over fixed-shape slot tensors on ``device``
  (``"cuda"`` by default), its decode-advance round in the hand-written
  ``sim_decode`` CUDA kernel. Bit-identical to the host backends in the
  exact classes and to the reference's ``jax`` tier. Its batched sweep API
  :func:`run_fleet_grid` runs whole fleet simulations across threshold /
  instance-count / controller-gain axes as one run with the grid lanes as
  a leading tensor axis (one ``sim_decode`` launch a round for every
  lane), each lane bit-identical to the reference's vmapped
  ``run_fleet_grid`` lane.

Fleets route over a budget-ordered :class:`~repro_torch.core.pools.PoolSet`
— any pool count, the paper's short/long pair being P=2.

Fault injection (:mod:`repro_torch.sim.faults`): pass
``FleetSim(..., injector=FaultInjector(specs), retry_policy=RetryPolicy())``
to subject either host backend to instance crashes, KV-OOM kills, and
transient slowdowns with retry/timeout/backoff and health-gated routing.
"""

from repro_torch.sim.engine import InstanceSim
from repro_torch.sim.faults import FaultInjector, FaultRuntime, FaultSpec, RetryPolicy
from repro_torch.sim.fleet import FleetResult, FleetSim, PoolSim, run_fleet
from repro_torch.sim.torch_engine import FleetGridResult, run_fleet_grid
from repro_torch.sim.metrics import (
    PAPER_SLO,
    RequestRecord,
    SimSummary,
    SLOTarget,
    concat_record_columns,
    percentile,
    summarize,
    summarize_columns,
)
from repro_torch.sim.vector_engine import VectorPoolSim
from repro_torch.sim.profiler import (
    HEADROOM,
    FleetPlan,
    PoolProfile,
    mean_iterations,
    plan_fleet,
    profile_pool,
    sensitivity_sweep,
    split_by_budget,
)
from repro_torch.sim.timing import (
    A100_LLAMA3_70B,
    MI300X_QWEN3,
    TimingModel,
    tpu_v5e_model,
)

__all__ = [
    "InstanceSim",
    "FaultInjector",
    "FaultRuntime",
    "FaultSpec",
    "RetryPolicy",
    "FleetResult",
    "FleetSim",
    "PoolSim",
    "run_fleet",
    "FleetGridResult",
    "run_fleet_grid",
    "RequestRecord",
    "SimSummary",
    "SLOTarget",
    "PAPER_SLO",
    "concat_record_columns",
    "percentile",
    "summarize",
    "summarize_columns",
    "VectorPoolSim",
    "HEADROOM",
    "FleetPlan",
    "PoolProfile",
    "mean_iterations",
    "plan_fleet",
    "profile_pool",
    "sensitivity_sweep",
    "split_by_budget",
    "A100_LLAMA3_70B",
    "MI300X_QWEN3",
    "TimingModel",
    "tpu_v5e_model",
]
