"""Fleet observability: windowed time series, metrics, and event tracing.

The paper's claims are about *observable* fleet dynamics — the error
composite driving §8 adaptive control, the KV-pressure incidents behind
§4.3 reliability, the α/ρ occupancies of Eq. 7. This package turns both DES
backends into sources of those observables:

* :class:`~repro_torch.obs.registry.MetricsRegistry` — O(1), allocation-free
  counters / gauges / fixed-bucket histograms over one preallocated slab;
* :class:`~repro_torch.obs.timeseries.FleetTelemetry` — per-window time series
  sampled on control-window boundaries, surfaced as
  ``FleetResult.telemetry`` with ``to_json()`` / ``to_csv()``;
* :class:`~repro_torch.obs.events.EventTrace` — a bounded ring buffer of typed
  events exportable as JSONL and Chrome trace-event JSON (Perfetto-loadable,
  one pool per track);
* :mod:`~repro_torch.obs.validate` — schema validators shared by the
  telemetry smoke (``benchmarks/port_telemetry_smoke.py``) and the tests.

Enable via ``FleetSim(..., telemetry=TelemetryConfig(events=True))`` (or
``telemetry=True`` for defaults). With telemetry off (the default) the
simulation takes zero extra work: every emission site is behind a
``tracer is not None`` guard and no registry exists.

Window semantics
----------------
Windows are counted in **dispatched requests**, not sim time: a sample
covers dispatch positions ``[lo, hi)`` of the arrival-ordered trace and is
taken the moment request ``hi`` has been dispatched. When an
``AdaptiveController`` is installed the sampling window *is* the control
window — each row captures exactly the per-pool deltas the controller acted
on, immediately **after** its boundary move (so ``threshold.*`` shows the
post-move vector, matching what the next window's requests will see). The
vectorized backend may overshoot a boundary by at most one coalesced
round, which is why routed-fleet series are tolerance-matched rather than
bit-equal across backends (see ``tests/test_vector_engine.py``). One final
telemetry-only sample (no controller step) is appended after the drain so
the series always covers the full run.

Telemetry JSON schema — ``repro.obs/telemetry-v1`` / ``-v2``
------------------------------------------------------------
``FleetTelemetry.to_json()`` emits one object (schema id is ``-v2`` when
the fleet ran with a :class:`~repro_torch.sim.faults.FaultInjector` attached,
``-v1`` otherwise; v2 is a strict superset of v1)::

    schema       "repro.obs/telemetry-v1" | "repro.obs/telemetry-v2"
    window       sampling window in dispatched requests (null → control window)
    pools        pool names in budget order (threshold / controller frame)
    num_samples  number of rows; every column has exactly this length
    columns      flat dict of per-window series, dotted names:
      t_req              int   dispatched requests at the window boundary
      t_sim              float sim time (s) of the sample
      spills             int   router spillovers in the window (delta)
      threshold.<k>      int   boundary B_k AFTER any controller move
      queue_depth.<pool> int   live queued requests at the boundary
      active.<pool>      int   live occupied decode slots
      slot_frac.<pool>   float active / (num_instances * n_seq)
      kv_frac.<pool>     float 1 − blocks_free / total_blocks, pool-wide
      preemptions.<pool> int   preemptions in the window (delta)
      rejections.<pool>  int   rejections in the window (delta)
      truncations.<pool> int   truncations in the window (delta)
      calib_err.cat<k>   float mean |est−true|/max(true,1) over the window's
                               dispatches of category k (null if none),
                               with est = ceil(bytes/ĉ_k^route) at the boundary
      ema_ratio.cat<k>   float live EMA bytes/token ratio ĉ_k
      -- telemetry-v2 only (fault injection attached) --
      retries            int   retry resubmissions in the window (delta)
      timeouts           int   deadline-exceeded drops in the window (delta)
      down.<pool>        int   instances currently down (gauge at boundary)
      failures.<pool>    int   in-flight requests lost in the window (delta)
      breaker_open.<pool> int  1 if the pool's circuit breaker is open at
                               the boundary, else 0
    registry     MetricsRegistry.snapshot(): final gauge/counter values and
                 the estimated-budget histogram (edges in tokens)

``to_csv()`` flattens the same columns, one row per window (NaN → empty).

Event schema — ``repro.obs/events-v1``
--------------------------------------
``EventTrace.to_jsonl()``: first line is a header (schema id, pool names,
emitted/dropped counts), then one object per event::

    kind        arrival | dispatch | admit | preempt | truncate | reject |
                spill | threshold_move | calib_sync | fail | recover |
                retry | timeout | shed
    t           sim time (s)
    pool        pool name, or "router" for fleet-level events
    request_id  subject request (-1 for fleet-level events)
    value       kind-specific payload: estimated L_total (dispatch),
                new B_k (threshold_move, with request_id = boundary index),
                EMA observations folded (calib_sync), lost in-flight count
                (crash/OOM ``fail``, request_id = instance index) or slow
                factor (slowdown ``fail``), retry attempt number (``retry``,
                pool = the re-route target), else 0. ``timeout`` and
                ``shed`` are router-track terminal drops (retry budget or
                deadline exhausted).

``to_chrome_trace()`` renders the same events as Chrome trace-event JSON —
instant events (``ph: "i"``, ``ts`` in µs) on one named thread per pool
plus a ``router`` thread — loadable directly in Perfetto.
"""

from repro_torch.obs.events import (
    ADMIT,
    ARRIVAL,
    CALIB_SYNC,
    DISPATCH,
    EVENT_NAMES,
    FAIL,
    PREEMPT,
    RECOVER,
    REJECT,
    RETRY,
    ROUTER_TRACK,
    SHED,
    SPILL,
    THRESHOLD_MOVE,
    TIMEOUT,
    TRUNCATE,
    EventTrace,
)
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.timeseries import FleetTelemetry, TelemetryConfig
from repro_torch.obs.validate import (
    validate_chrome_trace,
    validate_events_jsonl,
    validate_telemetry,
)

__all__ = [
    "ARRIVAL",
    "DISPATCH",
    "ADMIT",
    "PREEMPT",
    "TRUNCATE",
    "REJECT",
    "SPILL",
    "THRESHOLD_MOVE",
    "CALIB_SYNC",
    "FAIL",
    "RECOVER",
    "RETRY",
    "TIMEOUT",
    "SHED",
    "EVENT_NAMES",
    "ROUTER_TRACK",
    "EventTrace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "FleetTelemetry",
    "TelemetryConfig",
    "validate_telemetry",
    "validate_events_jsonl",
    "validate_chrome_trace",
]
