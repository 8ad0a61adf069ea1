"""O(1), allocation-free metrics primitives for the fleet telemetry layer.

A :class:`MetricsRegistry` owns one preallocated float64 slab; every counter
and gauge is an index into it, so the hot-path mutation is a single
``slab[i] += v`` / ``slab[i] = v`` with no per-observation allocation.
Histograms use *fixed* bucket edges declared at registration time — one
``bisect`` plus one integer increment per scalar observation, one
``searchsorted`` + ``bincount`` fold for bulk observations.

Registration (``counter()``/``gauge()``/``histogram()``) is the only place
that allocates (the slab doubles when full); it happens at telemetry setup,
never inside the simulation loop. The registry is deliberately ignorant of
the simulator — the fleet telemetry layer (:mod:`repro_torch.obs.timeseries`)
decides what to register and when to write.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Sequence

import numpy as np


class Counter:
    """Monotone accumulator: one slab slot, ``add()`` is ``slab[i] += v``."""

    __slots__ = ("_reg", "_i", "name")

    def __init__(self, reg: "MetricsRegistry", i: int, name: str) -> None:
        self._reg = reg
        self._i = i
        self.name = name

    def add(self, v: float = 1.0) -> None:
        self._reg._slab[self._i] += v

    inc = add

    @property
    def value(self) -> float:
        return float(self._reg._slab[self._i])


class Gauge:
    """Last-write-wins sample: one slab slot, ``set()`` is ``slab[i] = v``."""

    __slots__ = ("_reg", "_i", "name")

    def __init__(self, reg: "MetricsRegistry", i: int, name: str) -> None:
        self._reg = reg
        self._i = i
        self.name = name

    def set(self, v: float) -> None:
        self._reg._slab[self._i] = v

    @property
    def value(self) -> float:
        return float(self._reg._slab[self._i])


class Histogram:
    """Fixed-bucket histogram: ``len(edges)+1`` counts, edges ascending.

    Bucket ``j`` counts observations in ``(edges[j-1], edges[j]]``; bucket
    ``len(edges)`` is the overflow. Edges are frozen at registration — no
    rebinning, no allocation on ``observe``.
    """

    __slots__ = ("name", "edges", "counts", "_edges_list")

    def __init__(self, name: str, edges: Sequence[float]) -> None:
        e = [float(x) for x in edges]
        if not e or any(b <= a for a, b in zip(e, e[1:])):
            raise ValueError(f"histogram edges must be strictly increasing: {e}")
        self.name = name
        self.edges = np.asarray(e, dtype=np.float64)
        self._edges_list = e  # plain list: bisect beats np.searchsorted 1-at-a-time
        self.counts = np.zeros(len(e) + 1, dtype=np.int64)

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self._edges_list, v)] += 1

    def observe_many(self, values) -> None:
        idx = np.searchsorted(self.edges, np.asarray(values), side="right")
        self.counts += np.bincount(idx, minlength=len(self.counts))

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def snapshot(self) -> dict:
        return {
            "edges": [float(x) for x in self.edges],
            "counts": [int(c) for c in self.counts],
        }


class MetricsRegistry:
    """Named counters/gauges/histograms over one preallocated value slab."""

    def __init__(self, capacity: int = 64) -> None:
        self._slab = np.zeros(max(1, capacity), dtype=np.float64)
        self._index: dict[str, int] = {}
        self._kinds: dict[str, str] = {}
        self._histograms: dict[str, Histogram] = {}

    def _alloc(self, name: str, kind: str) -> int:
        if name in self._kinds:
            raise ValueError(f"metric {name!r} already registered")
        i = len(self._index)
        if i >= len(self._slab):
            self._slab = np.concatenate([self._slab, np.zeros_like(self._slab)])
        self._index[name] = i
        self._kinds[name] = kind
        return i

    def counter(self, name: str) -> Counter:
        return Counter(self, self._alloc(name, "counter"), name)

    def gauge(self, name: str) -> Gauge:
        return Gauge(self, self._alloc(name, "gauge"), name)

    def histogram(self, name: str, edges: Sequence[float]) -> Histogram:
        if name in self._kinds:
            raise ValueError(f"metric {name!r} already registered")
        self._kinds[name] = "histogram"
        h = Histogram(name, edges)
        self._histograms[name] = h
        return h

    def value(self, name: str) -> float:
        return float(self._slab[self._index[name]])

    def values(self) -> dict[str, float]:
        return {n: float(self._slab[i]) for n, i in self._index.items()}

    def snapshot(self) -> dict:
        """JSON-ready view: scalar values plus histogram edge/count pairs."""
        return {
            "values": self.values(),
            "kinds": dict(self._kinds),
            "histograms": {n: h.snapshot() for n, h in self._histograms.items()},
        }
