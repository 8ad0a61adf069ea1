"""Schema validators for the telemetry exports.

Each function parses an exported artifact, raises ``ValueError`` with a
pointed message on the first violation, and returns the parsed object on
success — so the telemetry smoke (``benchmarks/port_telemetry_smoke.py``) and
the unit tests share one definition of "well-formed".
:func:`check_window_deltas` reconciles a run's windowed deltas with its
end-of-run counters.
"""

from __future__ import annotations

import json

from repro_torch.obs.events import EVENT_NAMES

TELEMETRY_SCHEMA = "repro.obs/telemetry-v1"
#: v2 = v1 plus the fault/health columns (fleet ``retries``/``timeouts``
#: and per-pool ``down``/``failures``/``breaker_open``); emitted whenever
#: the fleet ran with a :class:`~repro_torch.sim.faults.FaultInjector` attached.
TELEMETRY_SCHEMA_V2 = "repro.obs/telemetry-v2"
TELEMETRY_SCHEMAS = (TELEMETRY_SCHEMA, TELEMETRY_SCHEMA_V2)
EVENTS_SCHEMA = "repro.obs/events-v1"

#: Fleet-level columns every telemetry export carries.
REQUIRED_COLUMNS = ("t_req", "t_sim", "spills")
#: Per-pool column families (``<family>.<pool>``).
POOL_COLUMNS = (
    "queue_depth",
    "active",
    "slot_frac",
    "kv_frac",
    "preemptions",
    "rejections",
    "truncations",
)
#: Extra fleet-level columns required by telemetry-v2.
REQUIRED_COLUMNS_V2 = ("retries", "timeouts")
#: Extra per-pool column families required by telemetry-v2.
POOL_COLUMNS_V2 = ("down", "failures", "breaker_open")


def validate_telemetry(doc) -> dict:
    """Validate a ``FleetTelemetry.to_dict()`` / ``to_json()`` artifact."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    if doc.get("schema") not in TELEMETRY_SCHEMAS:
        raise ValueError(f"bad telemetry schema id: {doc.get('schema')!r}")
    v2 = doc["schema"] == TELEMETRY_SCHEMA_V2
    pools = doc.get("pools")
    if not isinstance(pools, list) or not pools:
        raise ValueError(f"telemetry 'pools' must be a non-empty list: {pools!r}")
    cols = doc.get("columns")
    if not isinstance(cols, dict):
        raise ValueError("telemetry 'columns' must be a dict of lists")
    n = doc.get("num_samples")
    required = REQUIRED_COLUMNS + (REQUIRED_COLUMNS_V2 if v2 else ())
    pool_fams = POOL_COLUMNS + (POOL_COLUMNS_V2 if v2 else ())
    for name in required:
        if name not in cols:
            raise ValueError(f"missing telemetry column {name!r}")
    for pool in pools:
        for fam in pool_fams:
            if f"{fam}.{pool}" not in cols:
                raise ValueError(f"missing per-pool column {fam}.{pool!r}")
    for name, vals in cols.items():
        if not isinstance(vals, list) or len(vals) != n:
            raise ValueError(
                f"column {name!r} has {len(vals) if isinstance(vals, list) else '?'}"
                f" samples, expected num_samples={n}"
            )
    if not all(
        b >= a for a, b in zip(cols["t_req"], cols["t_req"][1:])
    ):
        raise ValueError("t_req must be non-decreasing")
    return doc


def validate_events_jsonl(text: str) -> list[dict]:
    """Validate an ``EventTrace.to_jsonl()`` export; returns the events."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty JSONL export")
    header = json.loads(lines[0])
    if header.get("schema") != EVENTS_SCHEMA:
        raise ValueError(f"bad events schema id: {header.get('schema')!r}")
    tracks = set(header.get("pools", ())) | {"router"}
    events = []
    for i, ln in enumerate(lines[1:], start=2):
        e = json.loads(ln)
        for field in ("kind", "t", "pool", "request_id", "value"):
            if field not in e:
                raise ValueError(f"line {i}: missing field {field!r}")
        if e["kind"] not in EVENT_NAMES:
            raise ValueError(f"line {i}: unknown event kind {e['kind']!r}")
        if e["pool"] not in tracks:
            raise ValueError(f"line {i}: unknown pool {e['pool']!r}")
        if e["t"] < 0:
            raise ValueError(f"line {i}: negative timestamp {e['t']}")
        events.append(e)
    return events


def validate_chrome_trace(text: str) -> dict:
    """Validate an ``EventTrace.to_chrome_trace()`` export.

    Checks the trace-event envelope Perfetto requires: a ``traceEvents``
    list, ``thread_name`` metadata for every referenced track, and
    well-formed instant events (``ph: "i"`` with µs ``ts``).
    """
    doc = json.loads(text)
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents must be a non-empty list")
    named_tids = set()
    for e in evs:
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") == "thread_name":
                named_tids.add(e.get("tid"))
            continue
        if ph != "i":
            raise ValueError(f"unexpected phase {ph!r} (only M/i are emitted)")
        if e.get("name") not in EVENT_NAMES:
            raise ValueError(f"unknown instant name {e.get('name')!r}")
        if not isinstance(e.get("ts"), (int, float)) or e["ts"] < 0:
            raise ValueError(f"bad ts on instant: {e.get('ts')!r}")
        if e.get("pid") != 0 or e.get("tid") not in named_tids:
            raise ValueError(
                f"instant on unnamed track pid={e.get('pid')} tid={e.get('tid')}"
            )
    return doc


def check_window_deltas(tel, res, *, spills: bool = True) -> None:
    """The windowed deltas of a run's ``FleetTelemetry`` sum to its
    ``FleetResult``'s end-of-run counters (preemptions, rejections,
    truncations and, with ``spills``, router spillovers); raises
    ``ValueError`` on the first family that does not."""
    for fam, total in (
        ("preemptions", res.preemptions),
        ("rejections", res.rejections),
        ("truncations", res.truncations),
    ):
        sampled = sum(sum(tel.columns[f"{fam}.{p}"]) for p in tel.pool_names)
        if sampled != total:
            raise ValueError(f"telemetry {fam} deltas sum to {sampled}, run counter is {total}")
    if spills:
        n_spills = sum(tel.columns["spills"])
        if n_spills != res.summary.spills:
            raise ValueError(
                f"telemetry spills sum to {n_spills}, run counter is {res.summary.spills}"
            )
