"""Fault tolerance: failure detection.

Holds :class:`HealthMonitor`, copied from ``repro.distributed.fault``; the
fleet simulator's fault injection (:mod:`repro_torch.sim.faults`) drives it
on sim time. The reference's ``elastic_mesh``, ``largest_mesh_shape``,
``StepTimer`` and ``SimulatedFailure`` belong to the distributed slice of
the port and are not here yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional



@dataclasses.dataclass
class HealthMonitor:
    """Heartbeat bookkeeping for the launcher's retry loop.

    ``clock`` supplies "now" whenever a call omits an explicit timestamp —
    it defaults to wall time (:func:`time.monotonic`) but is injectable so
    the fleet simulator can drive the monitor on *sim* time and replay a
    run deterministically.

    ``mark_dead`` is authoritative even for hosts that never heartbeated:
    the host becomes *known* (so ``alive_hosts``/``dead_hosts`` partition
    the same host set) and stays excluded until :meth:`revive`.
    """

    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self) -> None:
        self.last_seen: dict[int, float] = {}
        self.dead: set[int] = set()

    def heartbeat(self, host_id: int, now: Optional[float] = None) -> None:
        self.last_seen[host_id] = self.clock() if now is None else now

    def mark_dead(self, host_id: int) -> None:
        self.dead.add(host_id)
        # A host that never heartbeated must still show up as dead-known,
        # not vanish from both views.
        self.last_seen.setdefault(host_id, -math.inf)

    def revive(self, host_id: int, now: Optional[float] = None) -> None:
        """Clear the dead mark and record a fresh heartbeat."""
        self.dead.discard(host_id)
        self.heartbeat(host_id, now=now)

    def alive_hosts(self, now: Optional[float] = None) -> list[int]:
        t = self.clock() if now is None else now
        return [
            h
            for h, seen in self.last_seen.items()
            if h not in self.dead and t - seen <= self.timeout_s
        ]

    def dead_hosts(self) -> list[int]:
        return sorted(self.dead)

