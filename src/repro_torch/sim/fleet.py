"""Fleet-level discrete-event simulation (paper Appendix A, layer 3).

Drives N instances per pool plus the token-budget router over a trace:

* arrivals are routed with Algorithm 1 over a budget-ordered
  :class:`~repro_torch.core.pools.PoolSet` — any number of pools, the paper's
  short/long pair being the P=2 case (calibrated estimates + spillover,
  reading live queue depths);
* each instance runs the iteration-level engine; instance wake-ups are a
  single heapq (reference backend) or a coalesced per-pool sweep
  (vectorized backend);
* responses feed ``usage.prompt_tokens`` back into the router's EMA.

Three interchangeable backends behind ``FleetSim(backend=...)``. This is the
port's copy of ``repro.sim.fleet``; its third tier is ``torch`` where the
reference's is ``jax``, and it is the default (on ``device="cuda"``). The
host tiers run only when a caller names them:

``"reference"``
    The scalar engine of :mod:`repro_torch.sim.engine` — one Python object per
    sequence, one heap pop per instance iteration, one router call and one
    EMA update per request. Ground truth for unit tests.

``"vectorized"``
    The struct-of-arrays engine of :mod:`repro_torch.sim.vector_engine` — all
    instances of a pool step together in masked NumPy ops, instances that
    share a wake-up epoch advance in one coalesced round, routing happens
    per-epoch through :func:`repro_torch.core.router.route_batch` (N-way
    integer pool ids), and EMA calibration feedback syncs once per epoch
    (:meth:`repro_torch.core.calibration.EmaCalibrator.observe_batch`). Traces
    are consumed natively in columnar form
    (:class:`~repro_torch.traces.generator.TraceColumns`) — no per-request
    ``Request`` objects on the hot path. ~10–100× faster at fleet scale;
    behaviourally equivalent (exactly so for routerless pools, within
    calibration-lag tolerance for routed fleets).

``"torch"``
    The device engine of :mod:`repro_torch.sim.torch_engine`, the
    counterpart of the reference's compiled ``jax`` tier: the same event
    loop (epochs, arrival drain, round sweep, admission fixpoint, sort-free
    eviction) as eager PyTorch over fixed-shape slot tensors on
    ``device`` (``"cuda"`` by default), with the decode-advance round in
    the ``sim_decode`` kernel. Bit-identical to the host backends in the
    exact classes and to the reference's ``jax`` tier everywhere
    (arrival-ordered calibration feedback, spillover off). Fault
    injection and event tracing are not supported (``FleetSim`` raises);
    windowed telemetry is snapshotted on the device at each window and
    replayed into the host registry after the run.

All backends accept either a ``Sequence[Request]`` or a ``TraceColumns``;
the reference backend materializes objects from columns, the columnar
backends columnarize an object list once at entry.

The router reads O(1) ``PoolState`` counters that the engines maintain
incrementally on every submit/admit/preempt/complete — dispatch never
sweeps instances (the paper's O(1) claim, §2.2).

This verifies that the analytically-sized fleet (profiler layer) meets the
SLO under Poisson arrivals — the "definitive numbers" path of the paper.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.adaptive import AdaptiveController
from repro_torch.core.calibration import EmaCalibrator
from repro_torch.core.pools import PoolConfig, PoolSet, PoolState
from repro_torch.core.router import Request, TokenBudgetRouter
from repro_torch.device import resolve_device
from repro_torch.obs.events import (
    ARRIVAL,
    DISPATCH,
    RETRY,
    ROUTER_TRACK,
    SPILL,
    THRESHOLD_MOVE,
    EventTrace,
)
from repro_torch.obs.timeseries import FleetTelemetry, TelemetryConfig
from repro_torch.sim.engine import InstanceSim
from repro_torch.sim.faults import FaultInjector, FaultRuntime, RetryPolicy
from repro_torch.sim.metrics import (
    PAPER_SLO,
    RequestRecord,
    SimSummary,
    SLOTarget,
    concat_record_columns,
    summarize,
    summarize_columns,
)
from repro_torch.sim.timing import TimingModel
from repro_torch.sim.vector_engine import VectorPoolSim
from repro_torch.traces.generator import TraceColumns

Trace = Union[Sequence[Request], TraceColumns]


class PoolSim:
    """A pool of identical instances with join-least-loaded dispatch."""

    def __init__(
        self, config: PoolConfig, num_instances: int, timing: TimingModel
    ) -> None:
        self.config = config
        self.state = PoolState(config=config, num_instances=num_instances)
        self.instances = [
            InstanceSim(
                config,
                timing,
                name=f"{config.name}[{i}]",
                pool_state=self.state,
            )
            for i in range(num_instances)
        ]
        self._n_down = 0

    def refresh_state(self) -> None:
        """Recompute the dispatch counters from scratch.

        The engines maintain ``state.queue_depth``/``state.active``
        incrementally, so this is a consistency check / repair hook rather
        than a per-arrival necessity (it used to be O(instances) on every
        route call).
        """
        self.state.queue_depth = sum(len(i.queue) for i in self.instances)
        self.state.active = sum(len(i.active) for i in self.instances)

    def least_loaded(self) -> InstanceSim:
        # Health gating (fault injection): down instances are ejected from
        # dispatch; with every instance down, fall back to plain least-
        # loaded so requests queue for recovery instead of vanishing. Same
        # tie-break as the vectorized backend's masked argmin.
        if 0 < self._n_down < len(self.instances):
            return min(
                (i for i in self.instances if not i.downed),
                key=lambda i: i.load,
            )
        return min(self.instances, key=lambda i: i.load)

    # -- fault application (repro_torch.sim.faults) --------------------------------
    def install_faults(self) -> None:
        """API twin of ``VectorPoolSim.install_faults`` (the reference
        instances check their fault fields unconditionally)."""

    def set_down(self, instance: int, down: bool, until: float = 0.0) -> None:
        inst = self.instances[instance]
        if down and not inst.downed:
            self._n_down += 1
        if not down and inst.downed:
            self._n_down -= 1
        inst.downed = down
        if down:
            inst.down_until = until

    def set_slow(self, instance: int, factor: float) -> None:
        self.instances[instance].slow_factor = factor

    def fault_crash(self, instance: int, now: float, requeue: bool) -> list[int]:
        return self.instances[instance].fault_crash(now, requeue)

    def fault_oom(
        self, instance: int, now: float, evict_frac: float, requeue: bool
    ) -> list[int]:
        return self.instances[instance].fault_oom(now, evict_frac, requeue)

    def kv_occupancy(self) -> float:
        """Pool-wide KV block utilization: 1 − blocks_free / total_blocks."""
        cap = sum(i.total_blocks for i in self.instances)
        free = sum(i.blocks_free for i in self.instances)
        return 1.0 - free / cap if cap else 0.0

    @property
    def records(self) -> list[RequestRecord]:
        return [r for inst in self.instances for r in inst.records]

    @property
    def preemptions(self) -> int:
        return sum(i.preemption_count for i in self.instances)

    @property
    def rejections(self) -> int:
        return sum(i.rejection_count for i in self.instances)

    @property
    def truncations(self) -> int:
        return sum(i.truncation_count for i in self.instances)


@dataclasses.dataclass
class FleetResult:
    summary: SimSummary
    per_pool: dict[str, SimSummary]
    router_stats: dict
    preemptions: int
    rejections: int
    #: Mid-generation context-window truncations across the fleet — the
    #: third component of the adaptive controller's error signal.
    truncations: int = 0
    #: Fault-injection counters (zero on fault-free runs): re-dispatches of
    #: requests whose in-flight state a fault destroyed, deadline drops,
    #: retry-budget drops, and instance-level fault applications
    #: (crashes + KV-OOM kills).
    retries: int = 0
    timeouts: int = 0
    shed: int = 0
    instance_failures: int = 0
    #: Up instance-seconds / total instance-seconds over [0, t_end].
    availability: float = 1.0
    #: Canonical per-request outcomes — every submitted request appears
    #: exactly once (completed, truncated, or rejected). Populated by the
    #: reference backend; the vectorized backend keeps outcomes columnar
    #: for speed and leaves this None — reach per-request data through
    #: ``FleetSim.pools[name].record_arrays()`` (or ``.records`` to
    #: materialize RequestRecord objects) on the vectorized pools.
    records: Optional[list[RequestRecord]] = None
    #: Fleet-level terminal-failure records (``pool="fleet"``,
    #: ``rejected=True``) for requests dropped by fault injection after
    #: exhausting retries or their deadline. Populated by BOTH backends
    #: (they are few); already folded into ``summary`` and — on the
    #: reference backend — into ``records``, but absent from ``per_pool``.
    fail_records: list[RequestRecord] = dataclasses.field(default_factory=list)
    #: Windowed time series (+ optional event trace at ``telemetry.events``)
    #: from :mod:`repro_torch.obs`; populated when the fleet ran with telemetry.
    telemetry: Optional[FleetTelemetry] = None
    #: The SLO this fleet is evaluated against (``meets_slo()``).
    slo: SLOTarget = PAPER_SLO

    def meets_slo(self) -> bool:
        return self.summary.meets_slo(self.slo)

    def goodput(self) -> float:
        """Useful throughput: completed non-truncated requests per second."""
        s = self.summary
        if s.makespan <= 0:
            return 0.0
        return (s.completed - s.truncated) / s.makespan


class FleetSim:
    """Token-budget-routed fleet over any budget-ordered pool topology.

    ``pools`` maps pool name → ``(PoolConfig, num_instances)``. One pool
    runs routerless (the homogeneous baseline); two or more pools get a
    :class:`~repro_torch.core.router.TokenBudgetRouter` over the budget-ordered
    :class:`~repro_torch.core.pools.PoolSet`. Routing thresholds come from
    ``thresholds`` (ascending, one fewer than the pool count); when omitted
    they default to each non-last pool's ``C_max`` — except for the classic
    ``{"short", "long"}`` pair, where ``b_short`` keeps its original
    meaning as the single boundary.

    Closed-loop adaptive control (paper §7/§8) is a first-class hook:
    pass ``controller=AdaptiveController(...)`` and every
    ``control_window`` dispatched requests the fleet reports windowed
    per-pool error deltas (preemptions + rejections + truncations) plus
    live queue depths, and the controller moves the PoolSet boundaries in
    place — the router's hot path sees the new thresholds immediately.
    Both backends fire the hook on the same request-count windows; the
    vectorized backend caps its routing epoch at the control window so a
    boundary move is never stale by more than one window.
    """

    def __init__(
        self,
        pools: dict[str, tuple[PoolConfig, int]],
        timing: TimingModel,
        *,
        b_short: int = 8192,
        thresholds: Optional[Sequence[int]] = None,
        calibrator: Optional[EmaCalibrator] = None,
        spillover: bool = True,
        backend: str = "torch",
        device: str = "cuda",
        epoch: int = 2048,
        coalesce_dt: Optional[float] = None,
        controller: Optional[AdaptiveController] = None,
        control_window: int = 512,
        telemetry: Union[bool, TelemetryConfig, None] = None,
        slo: SLOTarget = PAPER_SLO,
        injector: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        if backend not in ("reference", "vectorized", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        # Only the torch tier runs on a device; the host tiers take none.
        self.device = resolve_device(device) if backend == "torch" else None
        self.epoch = epoch
        # Arrivals within one wake-up epoch step together (vectorized
        # backend): dispatch state is synced once per window instead of per
        # arrival, trading ≤ one-iteration staleness for ~10× fatter rounds.
        # 0.0 → sync at every arrival (exact reference event order).
        self.coalesce_dt = (
            timing.iter_time(1) if coalesce_dt is None else coalesce_dt
        )
        self.timing = timing
        if backend in ("vectorized", "torch"):
            # The torch backend computes on device and back-fills these
            # VectorPoolSim shells with records/counters afterwards, so
            # per-pool introspection works identically across backends.
            self.pools = {
                name: VectorPoolSim(cfg, n, timing)
                for name, (cfg, n) in pools.items()
            }
        else:
            self.pools = {
                name: PoolSim(cfg, n, timing) for name, (cfg, n) in pools.items()
            }
        self.router: Optional[TokenBudgetRouter] = None
        if len(self.pools) > 1:
            states = sorted(
                (p.state for p in self.pools.values()),
                key=lambda s: s.config.c_max,
            )
            if thresholds is None:
                if set(self.pools) == {"short", "long"}:
                    thresholds = [b_short]
                else:
                    thresholds = [s.config.c_max for s in states[:-1]]
            self.router = TokenBudgetRouter(
                pools=PoolSet(states, thresholds),
                calibrator=calibrator or EmaCalibrator(),
                spillover=spillover,
            )
        # -- closed-loop adaptive control (first-class hook) -----------------
        self.controller = controller
        self.control_window = int(control_window)
        self._ctrl_pools: list = []
        if controller is not None:
            if self.router is None:
                raise ValueError("adaptive control needs at least two pools")
            if self.control_window <= 0:
                raise ValueError("control_window must be positive")
            controller.bind(self.router.pools)
            # Pool sims in PoolSet budget order (the controller's frame),
            # matched by the shared PoolState identity.
            by_state = {id(p.state): p for p in self.pools.values()}
            self._ctrl_pools = [
                by_state[id(s)] for s in self.router.pools.states
            ]
            self._ctrl_prev_errors = [0] * len(self._ctrl_pools)

        # -- telemetry / event tracing (repro_torch.obs) ----------------------------
        self.slo = slo
        if telemetry is True:
            telemetry = TelemetryConfig()
        self.telemetry: Optional[FleetTelemetry] = None
        self.tracer: Optional[EventTrace] = None
        # Pool sims in PoolSet budget order (the frame thresholds and the
        # controller use) — declaration order for the routerless baseline.
        if self.router is not None:
            by_state = {
                id(p.state): (name, p) for name, p in self.pools.items()
            }
            ordered = [by_state[id(s)] for s in self.router.pools.states]
        else:
            ordered = list(self.pools.items())
        self._pool_index = {name: i for i, (name, _) in enumerate(ordered)}
        # -- fault injection (repro_torch.sim.faults) -------------------------------
        # Built in the same budget-ordered frame as telemetry and the
        # controller; None keeps every fault hook off the hot path.
        self.injector = injector
        self.retry_policy = retry_policy
        self._fault_rt: Optional[FaultRuntime] = None
        if injector is not None and backend == "torch":
            raise ValueError(
                "fault injection is not supported on the torch backend; "
                "use backend='vectorized' for chaos runs"
            )
        if injector is not None:
            for _, p in ordered:
                p.install_faults()
            self._fault_rt = FaultRuntime(
                injector,
                retry_policy,
                [name for name, _ in ordered],
                [p for _, p in ordered],
            )
        elif retry_policy is not None:
            raise ValueError("retry_policy has no effect without injector=")
        if telemetry is not None and telemetry.events and backend == "torch":
            raise ValueError(
                "event tracing (telemetry events=True) is not supported "
                "on the torch backend; windowed time series are"
            )
        if telemetry is not None:
            self.telemetry = FleetTelemetry(
                telemetry,
                [name for name, _ in ordered],
                [p for _, p in ordered],
                router=self.router,
                health=self._fault_rt,
            )
            self.tracer = self.telemetry.events
            if self.tracer is not None:
                for idx, (_, p) in enumerate(ordered):
                    engines = (
                        p.instances if isinstance(p, PoolSim) else (p,)
                    )
                    for eng in engines:
                        eng.tracer = self.tracer
                        eng.pool_index = idx
        if self._fault_rt is not None:
            self._fault_rt.tracer = self.tracer
        # Sampling/monitoring windows, counted in dispatched requests. With
        # a controller the window IS the control window (telemetry samples
        # land exactly on controller boundaries); telemetry alone may pick
        # its own window.
        self._win_size = 0
        if controller is not None:
            self._win_size = self.control_window
        elif self.telemetry is not None:
            self._win_size = int(
                self.telemetry.config.window or self.control_window
            )
            if self._win_size <= 0:
                raise ValueError("telemetry window must be positive")
        self._win_seen = 0
        self._win_prev_seen = 0
        self._ctrl_hist_len = 0

    # -- adaptive control ----------------------------------------------------
    def _control_step(self) -> None:
        """One monitoring window: report per-pool deltas, move boundaries.

        Errors follow the controller contract — preemptions + rejections +
        **truncations** accumulated since the previous window; queue depths
        and instance counts are the live O(1) PoolState counters (no
        instance sweep on the hot path). ``window_requests`` is the
        *actual* dispatched-request delta since the previous step, so the
        error rate stays correctly normalized even when the vectorized
        backend's coalesced rounds overshoot the nominal window.
        """
        totals = [
            p.preemptions + p.rejections + p.truncations
            for p in self._ctrl_pools
        ]
        self.controller.update(
            window_requests=self._win_seen - self._win_prev_seen,
            errors=[t - s for t, s in zip(totals, self._ctrl_prev_errors)],
            queues=[p.state.queue_depth for p in self._ctrl_pools],
            instances=[p.state.num_instances for p in self._ctrl_pools],
            t=self._win_seen,
        )
        self._ctrl_prev_errors = totals

    # -- monitoring windows (control + telemetry) -----------------------------
    def _win_tick(self, n: int, now: float) -> None:
        """Advance the dispatched-request counter by ``n``; close one
        monitoring window once at least ``_win_size`` requests have been
        dispatched since the previous boundary."""
        self._win_seen += n
        if self._win_seen - self._win_prev_seen >= self._win_size:
            self._window_step(now)

    def _window_step(self, now: float) -> None:
        """One window boundary: controller first (it may move thresholds),
        then the telemetry sample — so ``threshold.*`` records the vector
        the *next* window's requests will actually be routed with."""
        lo, hi = self._win_prev_seen, self._win_seen
        if self.controller is not None:
            self._control_step()
            if self.tracer is not None:
                hist = self.controller.history
                for mv in hist[self._ctrl_hist_len :]:
                    self.tracer.emit(
                        THRESHOLD_MOVE, now, ROUTER_TRACK, mv.boundary, mv.value
                    )
                self._ctrl_hist_len = len(hist)
        if self.telemetry is not None:
            self.telemetry.sample(t_req=hi, now=now, lo=lo, hi=hi)
        self._win_prev_seen = self._win_seen

    def _finish_windows(self, t_end: float) -> None:
        """Final telemetry-only flush after the drain.

        Captures the residual window plus the drained end state (queues
        empty, last completions). Never fires the controller — a residue
        smaller than a window must not move boundaries, keeping controller
        trajectories identical to runs without telemetry."""
        if self.telemetry is not None:
            self.telemetry.sample(
                t_req=self._win_seen,
                now=t_end,
                lo=self._win_prev_seen,
                hi=self._win_seen,
            )
            self._win_prev_seen = self._win_seen

    # -- routing (reference path) --------------------------------------------
    def _route(self, request: Request) -> PoolSim:
        if self.router is None:
            (pool,) = self.pools.values()
            if self.tracer is not None:
                t = request.arrival_time
                self.tracer.emit(ARRIVAL, t, ROUTER_TRACK, request.request_id)
                self.tracer.emit(DISPATCH, t, 0, request.request_id)
            return pool
        # PoolState counters are maintained incrementally by the engines —
        # dispatch is O(1), no per-arrival instance sweep.
        if self._fault_rt is not None:
            decision = self.router.route(
                request, blocked=self._fault_rt.blocked(request.arrival_time)
            )
        else:
            decision = self.router.route(request)
        if self.tracer is not None:
            t = request.arrival_time
            rid = request.request_id
            self.tracer.emit(ARRIVAL, t, ROUTER_TRACK, rid)
            self.tracer.emit(
                DISPATCH, t, decision.pool_index, rid, decision.estimated_total
            )
            if decision.spilled:
                self.tracer.emit(SPILL, t, decision.pool_index, rid)
        return self.pools[decision.pool]

    # -- fault application (both backends) ------------------------------------
    def _apply_fault(self, tr, on_fail) -> None:
        """Apply one compiled fault transition at exactly ``tr.t``.

        Backend-agnostic: both pool sim classes expose the same
        ``set_down``/``set_slow``/``fault_crash``/``fault_oom`` surface.
        ``on_fail(request_id, t)`` writes the backend's failure record for
        requests that are finally dropped (no retry scheduled).
        """
        rt = self._fault_rt
        pool = rt.pool_sims[tr.pool_idx]
        t = tr.t
        if tr.action == "crash":
            # Down state first: the engines' reschedule logic reads it.
            pool.set_down(tr.instance, True, until=tr.until)
            lost = pool.fault_crash(tr.instance, t, tr.requeue)
            rt.on_instance_fault(tr, len(lost), t)
            for rid in lost:
                if not rt.on_lost(rid, tr.pool_idx, t):
                    on_fail(rid, t)
        elif tr.action == "oom":
            lost = pool.fault_oom(tr.instance, t, tr.frac, tr.requeue)
            rt.on_instance_fault(tr, len(lost), t)
            for rid in lost:
                if not rt.on_lost(rid, tr.pool_idx, t):
                    on_fail(rid, t)
        elif tr.action == "slow":
            pool.set_slow(tr.instance, tr.factor)
            rt.on_slow(tr, t)
        elif tr.action == "recover":
            pool.set_down(tr.instance, False)
            # Warm-up: admit immediately but run degraded until warm.
            pool.set_slow(tr.instance, tr.factor)
            rt.on_recover(tr, t)
        else:  # slow_end / warm-up end
            pool.set_slow(tr.instance, 1.0)
            rt.on_recover(tr, t)

    def _route_retry(self, request: Request, t: float, avoid_idx: int):
        """Re-route one retry: skip the failed pool and any health-blocked
        pool, count it, emit the RETRY event. Returns the target pool sim.

        Retries deliberately do not tick the monitoring windows — windows
        count *trace* arrivals in both backends, keeping controller
        trajectories comparable between faulted and fault-free runs.
        """
        rt = self._fault_rt
        rt.retries += 1
        if self.router is None:
            ((_, pool),) = self.pools.items()
            idx = 0
        else:
            blocked = rt.blocked(t)
            blocked = (
                frozenset((avoid_idx,))
                if blocked is None
                else blocked | {avoid_idx}
            )
            decision = self.router.route(request, blocked=blocked)
            pool = self.pools[decision.pool]
            idx = decision.pool_index
        if self.tracer is not None:
            attempt = rt.attempts.get(request.request_id, 0)
            self.tracer.emit(
                RETRY, t, idx, request.request_id, float(attempt)
            )
        return pool

    # -- main loop -------------------------------------------------------------
    def run(self, trace: Trace) -> FleetResult:
        if self.backend == "torch":
            from repro_torch.sim import torch_engine

            return torch_engine.run_fleet_torch(self, trace)
        if self.backend == "vectorized":
            return self._run_vectorized(trace)
        if isinstance(trace, TraceColumns):
            trace = trace.to_requests()
        return self._run_reference(trace)

    def _run_reference(self, trace: Sequence[Request]) -> FleetResult:
        # Wake-up heap over instances; counter breaks ties deterministically.
        counter = itertools.count()
        heap: list[tuple[float, int, InstanceSim]] = []
        sleeping: set[int] = {id(i) for p in self.pools.values() for i in p.instances}

        def wake(inst: InstanceSim, t: float) -> None:
            if id(inst) in sleeping:
                sleeping.discard(id(inst))
                heapq.heappush(heap, (t, next(counter), inst))

        arrivals = sorted(trace, key=lambda r: r.arrival_time)
        lookup = {r.request_id: r for r in arrivals}
        ai = 0
        if self.telemetry is not None:
            self.telemetry.set_trace(
                np.asarray([r.byte_len for r in arrivals]),
                np.asarray([r.category for r in arrivals]),
                np.asarray([r.true_input_tokens for r in arrivals]),
                np.asarray([r.max_output_tokens for r in arrivals]),
            )
        last_t = 0.0

        # Fault injection: compiled transitions and scheduled retries join
        # the event race below; requests that are finally dropped get a
        # fleet-level failure record (rejected=True at the drop time) so
        # every trace request still appears exactly once in the summary.
        rt = self._fault_rt
        fail_records: list[RequestRecord] = []
        if rt is not None:
            rt.begin(arrival_of=lambda rid: lookup[rid].arrival_time)

        def on_fail(rid: int, t: float) -> None:
            req = lookup[rid]
            fail_records.append(
                RequestRecord(
                    request_id=rid,
                    pool="fleet",
                    arrival=req.arrival_time,
                    first_token=t,
                    finish=t,
                    output_tokens=0,
                    rejected=True,
                )
            )

        while ai < len(arrivals) or heap or (rt is not None and rt.pending()):
            next_arrival = arrivals[ai].arrival_time if ai < len(arrivals) else None
            next_event = heap[0][0] if heap else None

            if rt is not None:
                # Faults and retries win exact-time ties against arrivals
                # and engine iterations (the vectorized pump mirrors this).
                t_f = rt.next_time()
                if (
                    t_f != math.inf
                    and (next_arrival is None or t_f <= next_arrival)
                    and (next_event is None or t_f <= next_event)
                ):
                    kind, item = rt.pop()
                    last_t = t_f
                    if kind == "fault":
                        self._apply_fault(item, on_fail)
                    else:
                        t_r, _, rid, _attempt, avoid = item
                        pool = self._route_retry(lookup[rid], t_r, avoid)
                        inst = pool.least_loaded()
                        if inst.submit(lookup[rid], t_r):
                            wake(inst, t_r)
                    continue

            if next_event is None or (
                next_arrival is not None and next_arrival <= next_event
            ):
                request = arrivals[ai]
                ai += 1
                pool = self._route(request)
                inst = pool.least_loaded()
                if inst.submit(request, request.arrival_time):
                    wake(inst, request.arrival_time)
                last_t = request.arrival_time
                if self._win_size:
                    self._win_tick(1, request.arrival_time)
                continue

            now, _, inst = heapq.heappop(heap)
            last_t = now
            t_iter, done = inst.step(now)
            # `done` feeds the router's EMA only — the records themselves
            # stay on the instance, which is the single canonical store.
            if self.router is not None:
                for rec in done:
                    # usage.prompt_tokens feedback (Algorithm 1, line 15).
                    req = lookup.get(rec.request_id)
                    if req is not None:
                        self.router.on_response(req, req.true_input_tokens)
            if inst.idle:
                sleeping.add(id(inst))
            else:
                heapq.heappush(heap, (now + max(t_iter, 1e-9), next(counter), inst))

        # Canonical record list: one entry per submitted request (completed
        # or rejected), collected exactly once from the instances — plus
        # the fleet-level failure records of requests dropped by faults.
        all_records = [r for p in self.pools.values() for r in p.records]
        all_records.extend(fail_records)
        # Final flush at the drain end (max finish — matching the vectorized
        # backend's notion of the run's end time exactly).
        t_end = max((r.finish for r in all_records), default=last_t)
        self._finish_windows(t_end)
        spills = self.router.spill_count if self.router else 0
        per_pool = {
            name: summarize(name, p.records, total_spills=0)
            for name, p in self.pools.items()
        }
        return FleetResult(
            summary=summarize("fleet", all_records, total_spills=spills),
            per_pool=per_pool,
            router_stats=self.router.stats() if self.router else {},
            preemptions=sum(p.preemptions for p in self.pools.values()),
            rejections=sum(p.rejections for p in self.pools.values()),
            truncations=sum(p.truncations for p in self.pools.values()),
            retries=rt.retries if rt is not None else 0,
            timeouts=rt.timeouts if rt is not None else 0,
            shed=rt.shed if rt is not None else 0,
            instance_failures=rt.instance_failures if rt is not None else 0,
            availability=rt.availability(t_end) if rt is not None else 1.0,
            records=all_records,
            fail_records=fail_records,
            telemetry=self.telemetry,
            slo=self.slo,
        )

    def _dispatch_one(
        self,
        pool_ids: Optional[np.ndarray],
        budgets: Optional[np.ndarray],
        j: int,
        t: float = 0.0,
        rid: int = -1,
    ):
        """Pick the target pool for one arrival (vectorized backend).

        The static N-way decision comes from the epoch's ``route_batch``
        call; the load-dependent tail of Algorithm 1 (hard-constraint
        escalation, spillover, counters) is the router's
        :meth:`~repro_torch.core.router.TokenBudgetRouter.route_decided`, shared
        with the scalar dispatch path. ``t``/``rid`` are only passed (and
        only used) when event tracing or fault injection is on.
        """
        if self.router is None:
            (pool,) = self.pools.values()
            if self.tracer is not None:
                self.tracer.emit(ARRIVAL, t, ROUTER_TRACK, rid)
                self.tracer.emit(DISPATCH, t, 0, rid)
            return pool
        blocked = (
            self._fault_rt.blocked(t) if self._fault_rt is not None else None
        )
        if self.tracer is None:
            name = self.router.route_decided(
                int(pool_ids[j]), int(budgets[j]), blocked
            )
            return self.pools[name]
        spills0 = self.router.spill_count
        name = self.router.route_decided(
            int(pool_ids[j]), int(budgets[j]), blocked
        )
        idx = self._pool_index[name]
        self.tracer.emit(ARRIVAL, t, ROUTER_TRACK, rid)
        self.tracer.emit(DISPATCH, t, idx, rid, float(budgets[j]))
        if self.router.spill_count > spills0:
            self.tracer.emit(SPILL, t, idx, rid)
        return self.pools[name]

    # -- vectorized loop -------------------------------------------------------
    def _run_vectorized(self, trace: Trace) -> FleetResult:
        cols = (
            trace
            if isinstance(trace, TraceColumns)
            else TraceColumns.from_requests(trace)
        ).sorted_by_arrival()
        pools = list(self.pools.values())
        router = self.router

        # Routing observables stay columnar end-to-end: the epoch router
        # batches and the EMA feedback joins below index straight into the
        # trace arrays — no Request objects anywhere on this path.
        ids = cols.request_id
        id_order = np.argsort(ids, kind="stable")
        ids_sorted = ids[id_order]
        arrival = cols.arrival_time
        byte_by = cols.byte_len
        inp_by = cols.true_input_tokens
        out_by = cols.true_output_tokens
        cat_by = cols.category
        mot_by = cols.max_output_tokens
        if self.telemetry is not None:
            self.telemetry.set_trace(byte_by, cat_by, inp_by, mot_by)
        tracer = self.tracer

        def feedback() -> None:
            done = [p.drain_completed_ids() for p in pools]
            if router is None:
                return
            done_ids = np.concatenate([d for d in done if len(d)] or [ids[:0]])
            if not len(done_ids):
                return
            j = id_order[np.searchsorted(ids_sorted, done_ids)]
            router.on_response_batch(byte_by[j], inp_by[j], cat_by[j])

        def sweep_all(t: float) -> float:
            for p in pools:
                if p.wake_min < t:
                    p.sweep(t)
            return min(p.wake_min for p in pools)

        wake_min = np.inf

        # Fault injection: transitions and retries are pumped in time order
        # between coalesced windows, with sweeps to each exact fault time so
        # an instance's state at a crash is the same state the reference
        # backend sees (iterations starting strictly before the fault have
        # run; the one at the fault time has not).
        rt = self._fault_rt
        fail_rows: list[tuple[int, float, float]] = []

        def _trace_index(rid: int) -> int:
            return int(id_order[np.searchsorted(ids_sorted, rid)])

        if rt is not None:
            rt.begin(
                arrival_of=lambda rid: float(arrival[_trace_index(rid)])
            )

        def on_fail(rid: int, t: float) -> None:
            fail_rows.append((rid, float(arrival[_trace_index(rid)]), t))

        def pump_faults(t_until: float) -> None:
            nonlocal wake_min
            while rt.pending():
                t_next = rt.next_time()
                if t_next > t_until:
                    break
                wake_min = sweep_all(t_next)
                kind, item = rt.pop()
                if kind == "fault":
                    self._apply_fault(item, on_fail)
                    wake_min = min(p.wake_min for p in pools)
                else:
                    t_r, _, rid, _attempt, avoid = item
                    jx = _trace_index(rid)
                    req = Request(
                        request_id=rid,
                        byte_len=int(byte_by[jx]),
                        max_output_tokens=int(mot_by[jx]),
                        category=int(cat_by[jx]),
                        arrival_time=float(arrival[jx]),
                        true_input_tokens=int(inp_by[jx]),
                        true_output_tokens=int(out_by[jx]),
                    )
                    pool = self._route_retry(req, t_r, avoid)
                    if pool.submit_raw(
                        pool.least_loaded(),
                        rid,
                        float(arrival[jx]),
                        int(inp_by[jx]),
                        int(out_by[jx]),
                        t_r,
                    ):
                        wake_min = min(wake_min, pool.wake_min)

        n = len(cols)
        pos = 0
        pool_ids = budgets = None
        # Ramp the epoch size (64 → self.epoch): the first requests route
        # with the cold-start calibrator, so sync feedback frequently until
        # the EMA has converged — otherwise early long prompts get
        # underestimated, mis-routed to a too-small pool, and hard-rejected
        # where the per-request reference path would have served them.
        # Under adaptive control the epoch is additionally capped at the
        # control window, so a boundary move reaches route_batch within one
        # window of the request count that triggered it.
        epoch_cap = (
            self.epoch
            if self.controller is None
            else max(1, min(self.epoch, self.control_window))
        )
        chunk_size = min(64, epoch_cap)
        while pos < n:
            start = pos
            pos = min(n, pos + chunk_size)
            chunk_size = min(epoch_cap, chunk_size * 2)
            if router is not None:
                # Epoch-batched Algorithm 1: one jitted routing call per
                # chunk, using the calibration state as of the epoch start
                # and the whole-trace columns built above. route_batch
                # slices its shape-padding off before returning, so only
                # the chunk's real arrivals reach dispatch below.
                pool_ids, budgets = router.route_batch(
                    byte_by[start:pos], mot_by[start:pos], cat_by[start:pos]
                )
            j = start
            while j < pos:
                # Coalesce arrivals sharing one wake-up epoch: one sweep
                # serves the whole window, so due instances step together.
                horizon = arrival[j] + self.coalesce_dt
                jend = j + int(
                    np.searchsorted(arrival[j:pos], horizon, side="right")
                )
                jend = max(jend, j + 1)
                t_sync = arrival[jend - 1]
                if rt is not None:
                    pump_faults(float(t_sync))
                if t_sync > wake_min:
                    wake_min = sweep_all(t_sync)
                for jj in range(j, jend):
                    if tracer is None and rt is None:
                        pool = self._dispatch_one(pool_ids, budgets, jj - start)
                    else:
                        pool = self._dispatch_one(
                            pool_ids,
                            budgets,
                            jj - start,
                            float(arrival[jj]),
                            int(ids[jj]),
                        )
                    if pool.submit_raw(
                        pool.least_loaded(),
                        int(ids[jj]),
                        float(arrival[jj]),
                        int(inp_by[jj]),
                        int(out_by[jj]),
                        float(arrival[jj]),
                    ):
                        wake_min = min(wake_min, pool.wake_min)
                # Monitoring windows align to coalesced rounds: the windowed
                # per-pool error/queue deltas are read after each round's
                # arrivals land, mirroring the reference backend's cadence
                # within one coalescing horizon.
                if self._win_size:
                    self._win_tick(jend - j, float(t_sync))
                j = jend
            # Epoch boundary: sync completed-request feedback into the EMA.
            feedback()

        if rt is not None:
            # Drain the full fault/retry schedule in time order (sweeping to
            # each event), then finish whatever work is still in flight.
            pump_faults(np.inf)
        sweep_all(np.inf)
        feedback()

        per_pool_cols = {name: p.record_arrays() for name, p in self.pools.items()}
        all_cols = list(per_pool_cols.values())
        if rt is not None and fail_rows:
            nf = len(fail_rows)
            zeros = np.zeros(nf, dtype=np.int64)
            t_fail = np.asarray([r[2] for r in fail_rows], dtype=np.float64)
            all_cols.append(
                {
                    "request_id": np.asarray(
                        [r[0] for r in fail_rows], dtype=np.int64
                    ),
                    "arrival": np.asarray(
                        [r[1] for r in fail_rows], dtype=np.float64
                    ),
                    "first_token": t_fail,
                    "finish": t_fail,
                    "output_tokens": zeros,
                    "preemptions": zeros,
                    "truncated": np.zeros(nf, dtype=bool),
                    "rejected": np.ones(nf, dtype=bool),
                }
            )
        fleet_cols = concat_record_columns(all_cols)
        finish = fleet_cols.get("finish")
        t_end = (
            float(finish.max())
            if finish is not None and len(finish)
            else (float(arrival[-1]) if n else 0.0)
        )
        if self.telemetry is not None:
            self._finish_windows(t_end)
        spills = router.spill_count if router else 0
        return FleetResult(
            summary=summarize_columns("fleet", fleet_cols, total_spills=spills),
            per_pool={
                name: summarize_columns(name, c, total_spills=0)
                for name, c in per_pool_cols.items()
            },
            router_stats=router.stats() if router else {},
            preemptions=sum(p.preemptions for p in pools),
            rejections=sum(p.rejections for p in pools),
            truncations=sum(p.truncations for p in pools),
            retries=rt.retries if rt is not None else 0,
            timeouts=rt.timeouts if rt is not None else 0,
            shed=rt.shed if rt is not None else 0,
            instance_failures=rt.instance_failures if rt is not None else 0,
            availability=rt.availability(t_end) if rt is not None else 1.0,
            fail_records=[
                RequestRecord(
                    request_id=rid,
                    pool="fleet",
                    arrival=arr,
                    first_token=t_f,
                    finish=t_f,
                    output_tokens=0,
                    rejected=True,
                )
                for rid, arr, t_f in fail_rows
            ],
            telemetry=self.telemetry,
            slo=self.slo,
        )


def record_columns(sim: FleetSim) -> dict:
    """Every pool's per-request record columns after ``sim.run``."""
    return {name: pool.record_arrays() for name, pool in sim.pools.items()}


def same_records(a: dict, b: dict) -> bool:
    """Two :func:`record_columns` results equal bit for bit: the same
    pools and columns, each with the same dtype and bytes."""
    return a.keys() == b.keys() and all(
        a[p].keys() == b[p].keys()
        and all(
            a[p][c].dtype == b[p][c].dtype and a[p][c].tobytes() == b[p][c].tobytes()
            for c in a[p]
        )
        for p in a
    )


def run_fleet(
    trace: Trace,
    pools: dict[str, tuple[PoolConfig, int]],
    timing: TimingModel,
    *,
    b_short: int = 8192,
    thresholds: Optional[Sequence[int]] = None,
    calibrator: Optional[EmaCalibrator] = None,
    spillover: bool = True,
    backend: str = "torch",
    device: str = "cuda",
    coalesce_dt: Optional[float] = None,
    controller: Optional[AdaptiveController] = None,
    control_window: int = 512,
    telemetry: Union[bool, TelemetryConfig, None] = None,
    slo: SLOTarget = PAPER_SLO,
    injector: Optional[FaultInjector] = None,
    retry_policy: Optional[RetryPolicy] = None,
) -> FleetResult:
    """Convenience wrapper: build a FleetSim and run the trace. The default
    is the torch tier on ``device="cuda"``; ``device`` is read by
    ``backend="torch"`` only."""
    sim = FleetSim(
        pools,
        timing,
        b_short=b_short,
        thresholds=thresholds,
        calibrator=calibrator,
        spillover=spillover,
        backend=backend,
        device=device,
        coalesce_dt=coalesce_dt,
        controller=controller,
        control_window=control_window,
        telemetry=telemetry,
        slo=slo,
        injector=injector,
        retry_policy=retry_policy,
    )
    return sim.run(trace)
