"""Fault injection + failure recovery for the fleet DES.

The failure model is instance-level and fully deterministic: a
:class:`FaultInjector` holds an immutable set of :class:`FaultSpec`\\ s
(scheduled explicitly or generated stochastically from a seed) which
compile into a time-ordered list of state *transitions* — crash, KV-OOM
kill, slowdown onset, recovery, warm-up end. The fleet applies each
transition as a first-class simulation event at its exact timestamp, in
both DES backends, so a faulted run is reproducible bit-for-bit.

Fault kinds
-----------

``crash``     hard instance failure: all in-flight sequences are dropped
              (``requeue=True`` puts them back at the head of the local
              queue with their generated tokens folded into the prompt,
              vLLM recompute-style; ``requeue=False`` loses them — the
              fleet's :class:`RetryPolicy` decides their fate). The
              instance is down for ``duration`` seconds, then recovers;
              with ``warmup > 0`` it admits immediately on recovery but
              runs at ``warmup_factor``× iteration time until warm.
``oom``       KV-OOM kill: the youngest ``evict_frac`` of resident
              sequences are evicted (the instance survives). Same
              requeue-vs-lose disposition as ``crash``.
``slowdown``  transient straggler: iteration time is multiplied by
              ``factor`` for ``duration`` seconds.

Recovery side
-------------

:class:`RetryPolicy` gives lost requests capped exponential backoff with
deterministic (hash-based, order-independent) jitter, a per-request retry
budget, and an optional deadline measured from the original arrival. On
retry the router is asked to *avoid* the pool that failed the request.
Pool-level health is a windowed-error-rate circuit breaker: once a pool
accumulates ``breaker_threshold`` lost requests within
``breaker_window`` sim-seconds, the pool is skipped by nearest-feasible
spillover for ``breaker_cooldown`` seconds (half-open after that — new
failures re-trip it). Instance up/down bookkeeping reuses
:class:`repro_torch.distributed.fault.HealthMonitor` on the sim clock.

Everything here is inert unless ``FleetSim(injector=...)`` is passed:
fault-off runs take exactly the pre-fault code paths (``injector is
None`` guards, same discipline as telemetry).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.distributed.fault import HealthMonitor
from repro_torch.obs.events import FAIL, RECOVER, ROUTER_TRACK, SHED, TIMEOUT

FAULT_KINDS = ("crash", "oom", "slowdown")

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer — cheap, well-mixed 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _unit_hash(seed: int, request_id: int, attempt: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, request, attempt).

    Order-independent by construction — both DES backends evaluate it at
    different points in their loops yet get identical jitter.
    """
    z = _mix64(_mix64(_mix64(seed & _MASK64) ^ (request_id & _MASK64)) ^ attempt)
    return (z >> 11) / float(1 << 53)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled instance-level fault."""

    kind: str
    pool: str
    instance: int = 0
    t: float = 0.0
    #: Downtime (crash) or straggler window (slowdown), seconds.
    duration: float = 0.0
    #: Iteration-time multiplier while a slowdown is active.
    factor: float = 1.0
    #: Fraction of resident sequences evicted by an ``oom`` fault.
    evict_frac: float = 0.5
    #: Re-queue dropped sequences locally instead of losing them.
    requeue: bool = False
    #: Post-recovery warm-up window (crash only), seconds.
    warmup: float = 0.0
    #: Iteration-time multiplier during warm-up.
    warmup_factor: float = 1.5

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; use one of {FAULT_KINDS}")
        if self.t < 0.0 or self.duration < 0.0 or self.warmup < 0.0:
            raise ValueError(f"fault times must be non-negative: {self}")
        if self.kind == "slowdown" and self.factor <= 0.0:
            raise ValueError(f"slowdown factor must be positive: {self.factor}")
        if self.kind == "oom" and not (0.0 < self.evict_frac <= 1.0):
            raise ValueError(f"evict_frac must be in (0, 1]: {self.evict_frac}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + deterministic jitter for lost requests."""

    max_retries: int = 3
    base_backoff: float = 0.05
    max_backoff: float = 1.0
    #: Relative jitter amplitude: backoff is scaled by 1 + jitter·U where
    #: U ~ hash(seed, request, attempt) in [0, 1).
    jitter: float = 0.25
    #: Deadline measured from the request's original arrival; a retry that
    #: would dispatch past it is dropped as a timeout. ``None`` = no deadline.
    timeout: Optional[float] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {self.max_retries}")
        if self.base_backoff < 0.0 or self.max_backoff < self.base_backoff:
            raise ValueError(
                f"need 0 <= base_backoff <= max_backoff: "
                f"{self.base_backoff}, {self.max_backoff}"
            )
        if self.jitter < 0.0:
            raise ValueError(f"jitter must be >= 0: {self.jitter}")

    def backoff(self, request_id: int, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based) of ``request_id``."""
        b = min(self.max_backoff, self.base_backoff * (2.0 ** (attempt - 1)))
        if self.jitter:
            b *= 1.0 + self.jitter * _unit_hash(self.seed, request_id, attempt)
        return b


@dataclasses.dataclass(frozen=True)
class _Transition:
    """One compiled instance state change, applied at exactly ``t``."""

    t: float
    order: int  # stable tie-break: compilation order
    pool_idx: int
    instance: int
    action: str  # crash | oom | slow | recover | slow_end
    requeue: bool = False
    frac: float = 0.0
    factor: float = 1.0
    until: float = 0.0  # crash: recovery time (down_until)


class FaultInjector:
    """Immutable fault schedule + circuit-breaker configuration.

    Per-run mutable state lives in :class:`FaultRuntime`, built by the
    fleet — one injector can drive many runs (e.g. static vs adaptive on
    the same incident).
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        *,
        breaker_threshold: int = 5,
        breaker_window: float = 1.0,
        breaker_cooldown: float = 0.5,
    ) -> None:
        if breaker_threshold <= 0:
            raise ValueError(f"breaker_threshold must be positive: {breaker_threshold}")
        self.specs = tuple(sorted(specs, key=lambda s: (s.t, s.pool, s.instance)))
        self.breaker_threshold = breaker_threshold
        self.breaker_window = breaker_window
        self.breaker_cooldown = breaker_cooldown

    @classmethod
    def stochastic(
        cls,
        pools: Mapping[str, int],
        *,
        horizon: float,
        rate: float,
        seed: int = 0,
        kinds: Sequence[str] = FAULT_KINDS,
        mean_downtime: float = 0.25,
        mean_slow_window: float = 0.25,
        slow_factor: float = 3.0,
        evict_frac: float = 0.5,
        requeue: bool = False,
        warmup: float = 0.0,
        **breaker_kw,
    ) -> "FaultInjector":
        """Seeded Poisson fault schedule over ``pools`` (name → instances).

        Fault count ~ Poisson(rate·horizon); times are uniform on the
        horizon, targets weighted by instance count. Same seed → the
        identical schedule, independent of backend or run order.
        """
        names = list(pools)
        counts = np.asarray([pools[n] for n in names], dtype=np.float64)
        if len(names) == 0 or counts.sum() <= 0:
            raise ValueError("stochastic faults need at least one instance")
        rng = np.random.default_rng(seed)
        n = int(rng.poisson(rate * horizon))
        specs = []
        weights = counts / counts.sum()
        for _ in range(n):
            t = float(rng.uniform(0.0, horizon))
            p = int(rng.choice(len(names), p=weights))
            inst = int(rng.integers(int(counts[p])))
            kind = str(kinds[int(rng.integers(len(kinds)))])
            if kind == "crash":
                specs.append(
                    FaultSpec(
                        "crash",
                        names[p],
                        inst,
                        t,
                        duration=float(rng.exponential(mean_downtime)),
                        requeue=requeue,
                        warmup=warmup,
                    )
                )
            elif kind == "oom":
                specs.append(
                    FaultSpec("oom", names[p], inst, t, evict_frac=evict_frac, requeue=requeue)
                )
            else:
                specs.append(
                    FaultSpec(
                        "slowdown",
                        names[p],
                        inst,
                        t,
                        duration=float(rng.exponential(mean_slow_window)),
                        factor=slow_factor,
                    )
                )
        return cls(specs, **breaker_kw)

    def compile(
        self, pool_names: Sequence[str], num_instances: Sequence[int]
    ) -> list[_Transition]:
        """Resolve pool names → budget-order indices; expand to transitions."""
        index = {name: i for i, name in enumerate(pool_names)}
        out: list[_Transition] = []
        order = itertools.count()
        for s in self.specs:
            if s.pool not in index:
                raise ValueError(f"fault targets unknown pool {s.pool!r}; have {list(index)}")
            p = index[s.pool]
            if not 0 <= s.instance < num_instances[p]:
                raise ValueError(
                    f"fault targets instance {s.instance} of pool {s.pool!r} "
                    f"which has {num_instances[p]} instances"
                )
            if s.kind == "crash":
                up = s.t + s.duration
                out.append(
                    _Transition(s.t, next(order), p, s.instance, "crash", requeue=s.requeue, until=up)
                )
                warm = s.warmup_factor if s.warmup > 0.0 else 1.0
                out.append(_Transition(up, next(order), p, s.instance, "recover", factor=warm))
                if s.warmup > 0.0:
                    out.append(_Transition(up + s.warmup, next(order), p, s.instance, "slow_end"))
            elif s.kind == "oom":
                out.append(
                    _Transition(s.t, next(order), p, s.instance, "oom", requeue=s.requeue, frac=s.evict_frac)
                )
            else:  # slowdown
                out.append(_Transition(s.t, next(order), p, s.instance, "slow", factor=s.factor))
                out.append(_Transition(s.t + s.duration, next(order), p, s.instance, "slow_end"))
        out.sort(key=lambda tr: (tr.t, tr.order))
        return out


class FaultRuntime:
    """Per-run fault state shared by both DES backends.

    Owns the compiled transition schedule, the retry heap, per-pool
    circuit breakers, a sim-clock :class:`HealthMonitor` of instance
    up/down state, and the fault/retry counters surfaced on
    ``FleetResult`` and in the ``telemetry-v2`` health columns. The fleet
    drives it through :meth:`next_time`/:meth:`pop` (faults win ties
    against arrivals, engine iterations, and retries) and reports lost
    requests through :meth:`on_lost`.
    """

    def __init__(
        self,
        injector: FaultInjector,
        policy: Optional[RetryPolicy],
        pool_names: Sequence[str],
        pool_sims: Sequence,
    ) -> None:
        self.injector = injector
        self.policy = policy
        self.pool_names = list(pool_names)
        self.pool_sims = list(pool_sims)
        self.num_instances = [p.state.num_instances for p in self.pool_sims]
        self.transitions = injector.compile(self.pool_names, self.num_instances)
        self._ti = 0
        self._rheap: list[tuple[float, int, int, int, int]] = []
        self._rseq = itertools.count()
        self.attempts: dict[int, int] = {}
        # counters (FleetResult + telemetry deltas)
        self.retries = 0
        self.timeouts = 0
        self.shed = 0
        self.instance_failures = 0
        self.failures = [0] * len(self.pool_sims)  # lost in-flight, per pool
        # instance health: host id = global instance offset + local index
        self.monitor = HealthMonitor(timeout_s=math.inf, clock=lambda: self._now)
        self._now = 0.0
        self._offsets = [0] * len(self.pool_sims)
        off = 0
        for i, n in enumerate(self.num_instances):
            self._offsets[i] = off
            off += n
        self.total_instances = off
        for h in range(off):
            self.monitor.heartbeat(h, now=0.0)
        self.down_count = [0] * len(self.pool_sims)
        self._down_started: dict[int, float] = {}
        self._down_intervals: list[tuple[float, float]] = []
        # circuit breaker: windowed lost-request times per pool
        self._fail_times: list[deque[float]] = [deque() for _ in self.pool_sims]
        self._open_until = [-math.inf] * len(self.pool_sims)
        self.tracer = None
        self._arrival_of: Optional[Callable[[int], float]] = None

    # -- run wiring ----------------------------------------------------------
    def begin(self, arrival_of: Callable[[int], float]) -> None:
        self._arrival_of = arrival_of

    # -- event-queue interface ----------------------------------------------
    def pending(self) -> bool:
        return self._ti < len(self.transitions) or bool(self._rheap)

    def next_time(self) -> float:
        t = math.inf
        if self._ti < len(self.transitions):
            t = self.transitions[self._ti].t
        if self._rheap and self._rheap[0][0] < t:
            t = self._rheap[0][0]
        return t

    def pop(self):
        """Next due item: ``("fault", _Transition)`` or ``("retry", entry)``.

        Transitions win exact-time ties against retries so both backends
        agree on ordering.
        """
        t_tr = self.transitions[self._ti].t if self._ti < len(self.transitions) else math.inf
        if self._rheap and self._rheap[0][0] < t_tr:
            return "retry", heapq.heappop(self._rheap)
        tr = self.transitions[self._ti]
        self._ti += 1
        return "fault", tr

    # -- transition bookkeeping ---------------------------------------------
    def _host(self, pool_idx: int, instance: int) -> int:
        return self._offsets[pool_idx] + instance

    def on_instance_fault(self, tr: _Transition, n_lost: int, t: float) -> None:
        """A crash or OOM fired: health + counters + FAIL event."""
        self._now = t
        self.instance_failures += 1
        if tr.action == "crash":
            self.down_count[tr.pool_idx] += 1
            host = self._host(tr.pool_idx, tr.instance)
            self.monitor.mark_dead(host)
            self._down_started[host] = t
        if self.tracer is not None:
            self.tracer.emit(FAIL, t, tr.pool_idx, tr.instance, float(n_lost))

    def on_slow(self, tr: _Transition, t: float) -> None:
        self._now = t
        if self.tracer is not None:
            self.tracer.emit(FAIL, t, tr.pool_idx, tr.instance, tr.factor)

    def on_recover(self, tr: _Transition, t: float) -> None:
        self._now = t
        if tr.action == "recover":
            self.down_count[tr.pool_idx] -= 1
            host = self._host(tr.pool_idx, tr.instance)
            self.monitor.revive(host, now=t)
            start = self._down_started.pop(host, t)
            self._down_intervals.append((start, t))
        if self.tracer is not None:
            self.tracer.emit(RECOVER, t, tr.pool_idx, tr.instance)

    # -- lost-request disposition -------------------------------------------
    def on_lost(self, request_id: int, pool_idx: int, t: float) -> bool:
        """A request's in-flight state was destroyed on ``pool_idx``.

        Returns True if a retry was scheduled; False if the request is
        finally failed (shed or timed out) and the fleet must write its
        failure record.
        """
        self._now = t
        self.failures[pool_idx] += 1
        self._record_breaker(pool_idx, t)
        policy = self.policy
        if policy is None:
            self.shed += 1
            if self.tracer is not None:
                self.tracer.emit(SHED, t, ROUTER_TRACK, request_id)
            return False
        attempt = self.attempts.get(request_id, 0) + 1
        self.attempts[request_id] = attempt
        if attempt > policy.max_retries:
            self.shed += 1
            if self.tracer is not None:
                self.tracer.emit(SHED, t, ROUTER_TRACK, request_id, float(attempt - 1))
            return False
        t_retry = t + policy.backoff(request_id, attempt)
        if policy.timeout is not None:
            arrival = self._arrival_of(request_id) if self._arrival_of else 0.0
            if t_retry - arrival > policy.timeout:
                self.timeouts += 1
                if self.tracer is not None:
                    self.tracer.emit(TIMEOUT, t, ROUTER_TRACK, request_id, float(attempt))
                return False
        heapq.heappush(self._rheap, (t_retry, next(self._rseq), request_id, attempt, pool_idx))
        return True

    # -- circuit breaker -----------------------------------------------------
    def _record_breaker(self, pool_idx: int, t: float) -> None:
        dq = self._fail_times[pool_idx]
        dq.append(t)
        while dq and t - dq[0] > self.injector.breaker_window:
            dq.popleft()
        if len(dq) >= self.injector.breaker_threshold:
            self._open_until[pool_idx] = t + self.injector.breaker_cooldown

    def is_open(self, pool_idx: int, now: float) -> bool:
        return self._open_until[pool_idx] > now

    def blocked(self, now: float) -> Optional[frozenset]:
        """Pool indices to skip at dispatch: tripped breaker or all-down.

        ``None`` (the common case) keeps the router's fast path allocation-
        free.
        """
        b = None
        for k in range(len(self.pool_sims)):
            if self._open_until[k] > now or (
                0 < self.num_instances[k] == self.down_count[k]
            ):
                if b is None:
                    b = set()
                b.add(k)
        return frozenset(b) if b else None

    # -- end-of-run metrics ---------------------------------------------------
    def availability(self, t_end: float) -> float:
        """Up instance-seconds / total instance-seconds over [0, t_end]."""
        if t_end <= 0.0 or self.total_instances == 0:
            return 1.0
        down = 0.0
        for s, e in self._down_intervals:
            down += max(0.0, min(e, t_end) - min(s, t_end))
        for s in self._down_started.values():
            down += max(0.0, t_end - min(s, t_end))
        return 1.0 - down / (t_end * self.total_instances)
