"""Windowed time-series sampling for the fleet simulator.

:class:`FleetTelemetry` is the piece the fleet layer talks to: the fleet
calls :meth:`FleetTelemetry.sample` once per control window (the same
request-count windows the adaptive controller acts on — see
:mod:`repro_torch.obs` for the window semantics) and the sampler appends one row
to every column: per-pool queue depth, slot/KV occupancy,
preemption/rejection/truncation deltas, the live threshold vector, fleet
spill deltas, and — when the trace columns were attached via
:meth:`set_trace` — per-category calibration error and live EMA ratios.

Sampling is O(pools + categories) per window and touches no per-request
state, so it is *off* the simulation hot path by construction; the hot
path's only telemetry cost is the ``tracer is not None`` guards in the
engines, which a disabled run never takes.

Exports: :meth:`to_dict` / :meth:`to_json` (schema
``repro.obs/telemetry-v1``, or ``repro.obs/telemetry-v2`` when a fault
runtime is attached — v2 adds fleet ``retries``/``timeouts`` deltas plus
per-pool ``down.<pool>`` / ``failures.<pool>`` / ``breaker_open.<pool>``
health columns) and :meth:`to_csv` (one row per window, flat dotted
column names).
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.events import CALIB_SYNC, ROUTER_TRACK, EventTrace
from repro_torch.obs.registry import MetricsRegistry

#: Fixed bucket edges (tokens) for the estimated-budget histogram — powers
#: of two spanning the practical L_total range of the paper's topologies.
BUDGET_EDGES = tuple(float(1 << p) for p in range(8, 18))


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for :class:`FleetTelemetry` (all optional).

    ``window``
        Sampling window in dispatched requests. ``None`` → use the fleet's
        ``control_window`` (so samples land exactly on controller
        boundaries, which is what the equivalence suite locks).
    ``events``
        Also record the typed event ring (:class:`~repro_torch.obs.events.EventTrace`).
    ``event_capacity``
        Ring capacity (rounded up to a power of two); oldest events are
        overwritten past it.
    """

    window: Optional[int] = None
    events: bool = False
    event_capacity: int = 1 << 16


class FleetTelemetry:
    """Per-window observable series for one fleet run.

    Built by ``FleetSim`` when telemetry is requested; ``pools`` are the
    pool sims in budget order (the controller's frame), ``router`` is the
    fleet's :class:`~repro_torch.core.router.TokenBudgetRouter` (``None`` for the
    routerless single-pool baseline).
    """

    def __init__(
        self,
        config: TelemetryConfig,
        pool_names: Sequence[str],
        pools: Sequence,
        router=None,
        health=None,
    ) -> None:
        self.config = config
        self.pool_names = list(pool_names)
        self._pools = list(pools)
        self._router = router
        self._health = health
        self.events: Optional[EventTrace] = (
            EventTrace(config.event_capacity, pool_names=self.pool_names)
            if config.events
            else None
        )

        # -- registry: live gauges/counters, updated once per window ---------
        self.registry = MetricsRegistry()
        reg = self.registry
        self._g_queue = [reg.gauge(f"queue_depth.{p}") for p in self.pool_names]
        self._g_active = [reg.gauge(f"active.{p}") for p in self.pool_names]
        self._g_kv = [reg.gauge(f"kv_frac.{p}") for p in self.pool_names]
        self._c_pre = [reg.counter(f"preemptions.{p}") for p in self.pool_names]
        self._c_rej = [reg.counter(f"rejections.{p}") for p in self.pool_names]
        self._c_trunc = [reg.counter(f"truncations.{p}") for p in self.pool_names]
        self._c_spills = reg.counter("spills")
        self.budget_hist = reg.histogram("budget_est_tokens", BUDGET_EDGES)

        # -- windowed delta baselines -----------------------------------------
        p = len(self._pools)
        self._prev_pre = [0] * p
        self._prev_rej = [0] * p
        self._prev_trunc = [0] * p
        self._prev_spills = 0
        self._prev_calib = 0

        # -- trace columns for calibration-error sampling ---------------------
        self._byte_len: Optional[np.ndarray] = None
        self._category: Optional[np.ndarray] = None
        self._true_input: Optional[np.ndarray] = None
        self._mot: Optional[np.ndarray] = None

        # -- the series -------------------------------------------------------
        self.columns: dict[str, list] = {"t_req": [], "t_sim": [], "spills": []}
        if router is not None:
            for k in range(len(router.pools) - 1):
                self.columns[f"threshold.{k}"] = []
        for name in self.pool_names:
            for col in (
                "queue_depth",
                "active",
                "slot_frac",
                "kv_frac",
                "preemptions",
                "rejections",
                "truncations",
            ):
                self.columns[f"{col}.{name}"] = []
        self._num_categories = 0
        if router is not None:
            self._num_categories = router.calibrator.num_categories
            for k in range(self._num_categories):
                self.columns[f"calib_err.cat{k}"] = []
                self.columns[f"ema_ratio.cat{k}"] = []
        if health is not None:
            self.columns["retries"] = []
            self.columns["timeouts"] = []
            for name in self.pool_names:
                self.columns[f"down.{name}"] = []
                self.columns[f"failures.{name}"] = []
                self.columns[f"breaker_open.{name}"] = []
            self._prev_retries = 0
            self._prev_timeouts = 0
            self._prev_fail = [0] * len(self._pools)

    # -- trace attachment ------------------------------------------------------
    def set_trace(
        self,
        byte_len: np.ndarray,
        category: np.ndarray,
        true_input: np.ndarray,
        max_output_tokens: Optional[np.ndarray] = None,
    ) -> None:
        """Attach the arrival-ordered trace columns.

        Windows index these arrays by dispatch position, so the order must
        match the order requests are dispatched (both backends dispatch in
        arrival order). Enables the ``calib_err.*`` series and the budget
        histogram; without a trace those stay NaN/empty.
        """
        self._byte_len = np.asarray(byte_len)
        self._category = np.asarray(category)
        self._true_input = np.asarray(true_input)
        if max_output_tokens is not None:
            self._mot = np.asarray(max_output_tokens)

    # -- the per-window sample -------------------------------------------------
    def sample(self, t_req: int, now: float, lo: int, hi: int) -> None:
        """Append one row covering dispatch positions ``[lo, hi)``.

        ``t_req`` is the dispatched-request count at the window boundary
        (== ``hi``), ``now`` the sim time of the sample. Counter columns are
        windowed deltas; gauges are read live at the boundary.
        """
        cols = self.columns
        cols["t_req"].append(int(t_req))
        cols["t_sim"].append(float(now))

        router = self._router
        if router is not None:
            for k, b in enumerate(router.pools.thresholds):
                cols[f"threshold.{k}"].append(int(b))
            spills = router.spill_count
        else:
            spills = 0
        cols["spills"].append(spills - self._prev_spills)
        self._c_spills.add(spills - self._prev_spills)
        self._prev_spills = spills

        for j, (name, pool) in enumerate(zip(self.pool_names, self._pools)):
            st = pool.state
            slots = st.num_instances * st.config.n_seq
            kv = pool.kv_occupancy()
            cols[f"queue_depth.{name}"].append(int(st.queue_depth))
            cols[f"active.{name}"].append(int(st.active))
            cols[f"slot_frac.{name}"].append(st.active / max(1, slots))
            cols[f"kv_frac.{name}"].append(kv)
            self._g_queue[j].set(st.queue_depth)
            self._g_active[j].set(st.active)
            self._g_kv[j].set(kv)
            for col, prev, cur, ctr in (
                ("preemptions", self._prev_pre, pool.preemptions, self._c_pre),
                ("rejections", self._prev_rej, pool.rejections, self._c_rej),
                ("truncations", self._prev_trunc, pool.truncations, self._c_trunc),
            ):
                delta = cur - prev[j]
                cols[f"{col}.{name}"].append(delta)
                ctr[j].add(delta)
                prev[j] = cur

        health = self._health
        if health is not None:
            cols["retries"].append(health.retries - self._prev_retries)
            self._prev_retries = health.retries
            cols["timeouts"].append(health.timeouts - self._prev_timeouts)
            self._prev_timeouts = health.timeouts
            for j, name in enumerate(self.pool_names):
                cols[f"down.{name}"].append(int(health.down_count[j]))
                cols[f"failures.{name}"].append(
                    health.failures[j] - self._prev_fail[j]
                )
                self._prev_fail[j] = health.failures[j]
                cols[f"breaker_open.{name}"].append(
                    int(health.is_open(j, now))
                )

        if router is not None:
            self._sample_calibration(cols, now, lo, hi)

    def _sample_calibration(self, cols: dict, now: float, lo: int, hi: int) -> None:
        """Per-category ``|est − true| / true`` over the window slice, using
        the calibration state as read at the window boundary, plus the live
        EMA ratios; emits a ``calib_sync`` event when observations landed."""
        calib = self._router.calibrator
        have_trace = self._byte_len is not None and hi > lo
        if have_trace:
            hi = min(hi, len(self._byte_len))
            byte = self._byte_len[lo:hi].astype(np.float64)
            cat = self._category[lo:hi]
            true = self._true_input[lo:hi].astype(np.float64)
        for k in range(self._num_categories):
            ratio = calib.conservative_ratio(k)
            cols[f"ema_ratio.cat{k}"].append(float(calib.ratio[k]))
            err = math.nan
            if have_trace:
                m = cat == k
                if m.any():
                    est = np.ceil(byte[m] / ratio)
                    err = float(
                        np.mean(np.abs(est - true[m]) / np.maximum(true[m], 1.0))
                    )
            cols[f"calib_err.cat{k}"].append(err)
        if have_trace and self._mot is not None:
            ratios = np.array(
                [calib.conservative_ratio(k) for k in range(self._num_categories)]
            )
            est_total = np.ceil(byte / ratios[cat]) + self._mot[lo:hi]
            self.budget_hist.observe_many(est_total)
        total_obs = sum(calib.count)
        if self.events is not None and total_obs != self._prev_calib:
            self.events.emit(
                CALIB_SYNC, now, ROUTER_TRACK, -1, total_obs - self._prev_calib
            )
        self._prev_calib = total_obs

    # -- views / exports -------------------------------------------------------
    @property
    def num_samples(self) -> int:
        return len(self.columns["t_req"])

    def column(self, name: str) -> np.ndarray:
        return np.asarray(self.columns[name], dtype=np.float64)

    def to_dict(self) -> dict:
        version = 1 if self._health is None else 2
        return {
            "schema": f"repro.obs/telemetry-v{version}",
            "window": self.config.window,
            "pools": list(self.pool_names),
            "num_samples": self.num_samples,
            "columns": {
                name: [None if isinstance(v, float) and math.isnan(v) else v for v in vals]
                for name, vals in self.columns.items()
            },
            "registry": self.registry.snapshot(),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_csv(self) -> str:
        """Flat wide CSV: one row per window, dotted column names."""
        names = list(self.columns)
        buf = io.StringIO()
        buf.write(",".join(names) + "\n")
        for row in zip(*(self.columns[n] for n in names)):
            buf.write(
                ",".join(
                    ""
                    if isinstance(v, float) and math.isnan(v)
                    else f"{v:.6g}"
                    if isinstance(v, float)
                    else str(v)
                    for v in row
                )
                + "\n"
            )
        return buf.getvalue()
