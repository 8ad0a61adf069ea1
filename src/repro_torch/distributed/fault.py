"""Fault tolerance: failure detection, the straggler policy, elastic
re-meshing (counterpart of ``repro.distributed.fault``).

:class:`HealthMonitor` (the fleet simulator's fault injection,
:mod:`repro_torch.sim.faults`, drives it on sim time), :class:`StepTimer`
and :class:`SimulatedFailure` (the training launcher's straggler flag and
restart drill), :func:`largest_mesh_shape` and :func:`elastic_mesh`: on a
failure the launcher rebuilds the largest ``(data, model)`` mesh over the
surviving ranks and restores the latest checkpoint onto it (the format is
layout-free; :meth:`repro_torch.checkpoint.Checkpointer.restore` places
each leaf on the new mesh).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


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



def largest_mesh_shape(
    n_devices: int, *, model_parallel: int, max_data: Optional[int] = None
) -> tuple[int, int]:
    """Largest (data, model) grid from surviving devices.

    Model parallelism is fixed by the model's memory footprint; elasticity
    happens on the data axis (whole TP groups are added/removed).
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"need at least one TP group ({model_parallel}), got {n_devices}"
        )
    data = n_devices // model_parallel
    if max_data is not None:
        data = min(data, max_data)
    return data, model_parallel


def elastic_mesh(
    ranks: Optional[Sequence[int]] = None,
    *,
    model_parallel: int = 1,
    axis_names: tuple[str, str] = ("data", "model"),
    device_type: str = "cuda",
) -> DeviceMesh:
    """The largest ``(data, model)`` mesh over ``ranks`` (the surviving
    ranks; every rank of the process group by default), as new groups over
    them. Every rank of the process group calls it; a rank left out holds
    no coordinate on the mesh."""
    ranks = sorted(range(dist.get_world_size()) if ranks is None else ranks)
    data, model = largest_mesh_shape(len(ranks), model_parallel=model_parallel)
    grid = torch.tensor(ranks[: data * model], dtype=torch.int64).view(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=axis_names)


@dataclasses.dataclass
class StepTimer:
    """Detects straggler steps: > multiplier × rolling-median step time."""

    window: int = 32
    multiplier: float = 2.0

    def __post_init__(self) -> None:
        self.history: list[float] = []
        self.straggler_steps: list[int] = []
        self._step = 0

    def record(self, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self._step += 1
        hist = self.history[-self.window :]
        is_straggler = False
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if duration_s > self.multiplier * med:
                is_straggler = True
                self.straggler_steps.append(self._step)
        self.history.append(duration_s)
        return is_straggler

    @property
    def straggler_rate(self) -> float:
        return len(self.straggler_steps) / max(1, self._step)


class SimulatedFailure(RuntimeError):
    """Raised by tests/examples to exercise the restart path."""
