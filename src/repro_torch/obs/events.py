"""Bounded structured event tracing for the fleet DES.

:class:`EventTrace` is a fixed-capacity ring buffer of typed events stored
columnar (int8 kind / float64 time / int16 pool / int64 request id / float64
value) — emitting an event is five array stores and one integer increment,
no allocation, so tracing can stay on during large vectorized runs. When
the ring wraps, the oldest events are overwritten and counted in
``dropped`` (observability must never grow without bound).

Event kinds (see :mod:`repro_torch.obs` for field semantics):

``arrival``         a request reached the fleet (router track)
``dispatch``        the router chose a pool (value = estimated L_total)
``admit``           an instance moved the request queue → active slots
``preempt``         vLLM-style preemption-by-recompute of the request
``truncate``        the request hit C_max mid-generation
``reject``          the request could never fit its pool (hard reject)
``spill``           load-aware spillover redirected the request
``threshold_move``  the adaptive controller moved boundary ``request_id``
                    (value = new B_k; router track)
``calib_sync``      a calibration feedback sync (value = observations
                    folded into the EMA; router track)
``fail``            a fault fired on instance ``request_id`` of the pool
                    (value = in-flight sequences lost for crash/OOM, or
                    the slowdown factor for straggler onset)
``recover``         instance ``request_id`` of the pool returned to
                    service (crash recovery, warm-up end, or slowdown end)
``retry``           a lost request was re-dispatched (value = attempt
                    number; pool = the pool chosen on re-route)
``timeout``         a request exceeded its deadline and was dropped
                    (router track)
``shed``            a request exhausted its retry budget and was dropped
                    (router track)

Exports: ``to_jsonl()`` (one JSON object per line) and
``to_chrome_trace()`` — the Chrome trace-event JSON format, with one
thread (track) per pool plus a ``router`` track, so a run opens directly
in Perfetto / ``chrome://tracing``.
"""

from __future__ import annotations

import json

import numpy as np

#: Typed event kinds (int8 codes stored in the ring). Append-only: codes
#: 0–8 predate fault injection and must stay stable for old traces.
(
    ARRIVAL,
    DISPATCH,
    ADMIT,
    PREEMPT,
    TRUNCATE,
    REJECT,
    SPILL,
    THRESHOLD_MOVE,
    CALIB_SYNC,
    FAIL,
    RECOVER,
    RETRY,
    TIMEOUT,
    SHED,
) = range(14)

EVENT_NAMES = (
    "arrival",
    "dispatch",
    "admit",
    "preempt",
    "truncate",
    "reject",
    "spill",
    "threshold_move",
    "calib_sync",
    "fail",
    "recover",
    "retry",
    "timeout",
    "shed",
)

#: Pseudo-pool id for fleet/router-level events (arrival, threshold moves,
#: calibration syncs); rendered as its own track in the Chrome trace.
ROUTER_TRACK = -1


class EventTrace:
    """Fixed-capacity ring buffer of typed simulator events."""

    def __init__(self, capacity: int = 1 << 16, pool_names=()) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        # Round up to a power of two so the ring index is a mask, not a mod.
        cap = 1 << (int(capacity) - 1).bit_length()
        self.capacity = cap
        self._mask = cap - 1
        self._n = 0
        self.pool_names = [str(p) for p in pool_names]
        self.kind = np.zeros(cap, dtype=np.int8)
        self.t = np.zeros(cap, dtype=np.float64)
        self.pool = np.zeros(cap, dtype=np.int16)
        self.request_id = np.zeros(cap, dtype=np.int64)
        self.value = np.zeros(cap, dtype=np.float64)

    # -- hot path ------------------------------------------------------------
    def emit(
        self,
        kind: int,
        t: float,
        pool: int,
        request_id: int,
        value: float = 0.0,
    ) -> None:
        i = self._n & self._mask
        self.kind[i] = kind
        self.t[i] = t
        self.pool[i] = pool
        self.request_id[i] = request_id
        self.value[i] = value
        self._n += 1

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def emitted(self) -> int:
        """Total events ever emitted (retained + dropped)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around (oldest first)."""
        return max(0, self._n - self.capacity)

    def _order(self) -> np.ndarray:
        """Ring indices of the retained events, oldest → newest."""
        n = len(self)
        start = self._n - n
        return (start + np.arange(n)) & self._mask

    def track_name(self, pool: int) -> str:
        if 0 <= pool < len(self.pool_names):
            return self.pool_names[pool]
        return "router"

    def events(self) -> list[dict]:
        """Retained events as dicts, chronological (emission) order."""
        idx = self._order()
        return [
            {
                "kind": EVENT_NAMES[int(self.kind[i])],
                "t": float(self.t[i]),
                "pool": self.track_name(int(self.pool[i])),
                "request_id": int(self.request_id[i]),
                "value": float(self.value[i]),
            }
            for i in idx
        ]

    # -- exports -------------------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line; first line is a header record."""
        header = {
            "schema": "repro.obs/events-v1",
            "pools": list(self.pool_names),
            "emitted": self.emitted,
            "dropped": self.dropped,
        }
        lines = [json.dumps(header)]
        lines.extend(json.dumps(e) for e in self.events())
        return "\n".join(lines) + "\n"

    def to_chrome_trace(self) -> str:
        """Chrome trace-event JSON (Perfetto-loadable), one pool per track.

        Times are exported in microseconds (``ts`` is µs in the trace-event
        spec); every event is an instant ('i') on its pool's thread, with
        ``request_id``/``value`` preserved under ``args``.
        """
        tracks = list(self.pool_names) + ["router"]
        router_tid = len(self.pool_names)
        trace_events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 0,
                "tid": 0,
                "args": {"name": "fleet-sim"},
            }
        ]
        for tid, name in enumerate(tracks):
            trace_events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        for i in self._order():
            pool = int(self.pool[i])
            tid = pool if 0 <= pool < router_tid else router_tid
            trace_events.append(
                {
                    "name": EVENT_NAMES[int(self.kind[i])],
                    "ph": "i",
                    "s": "t",
                    "ts": float(self.t[i]) * 1e6,
                    "pid": 0,
                    "tid": tid,
                    "args": {
                        "request_id": int(self.request_id[i]),
                        "value": float(self.value[i]),
                    },
                }
            )
        return json.dumps({"traceEvents": trace_events, "displayTimeUnit": "ms"})
