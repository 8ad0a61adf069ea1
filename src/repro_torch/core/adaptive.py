"""Error-driven threshold discovery (paper §7 Future Work — implemented).

The paper proposes turning the routing boundaries into self-tuning control
variables driven by the engines' own failure/pressure signals. Both
controllers here apply AIMD (additive-increase / multiplicative-decrease),
the classic stable feedback law, per boundary ``B_k`` between pool ``k``
and pool ``k+1``:

* **error pressure** (pool-k preemptions, truncations, rejections, or hard
  queue overload) → multiplicative *decrease*: mis-routed heavy requests
  are being forced into a too-small pool, shift the boundary down;
* **quiet windows with upstream slack** (pool ``k+1`` near-idle and pool
  ``k`` unpressured) → additive *increase*: capture more traffic in the
  cheaper pool (the savings gradient in Fig. 6 is monotone for heavy-tailed
  traffic).

A boundary never crosses the hard bound ``B_k ≤ C_max,k`` and the strict
ordering ``B_1 < … < B_{P-1}`` is preserved on every step, so one bad
window cannot flap the fleet or wedge the router.

:class:`AdaptiveController` is the first-class N-boundary form operating on
any :class:`~repro_torch.core.pools.PoolSet` — plug it into the fleet simulator
via ``FleetSim(controller=..., control_window=...)`` and both backends will
feed it windowed per-pool error/queue deltas. :class:`AdaptiveThreshold` is
the original two-pool scalar form, kept as a compatibility layer for code
that manages ``b_short`` by hand.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.pools import PoolSet

#: AIMD defaults shared by both controller forms (§8: alert when the 5-min
#: preemption rate exceeds 1%; pressure in queued-requests-per-instance).
DEFAULT_INCREASE_STEP = 512
DEFAULT_DECREASE_FACTOR = 0.75
DEFAULT_ERROR_RATE_HI = 0.01
DEFAULT_OVERLOAD_RATIO_HI = 2.0
#: Pressure floors: below ``_PRESSURE_IDLE`` a pool counts as slack, above
#: ``_PRESSURE_BUSY`` it is materially loaded.
_PRESSURE_IDLE = 0.25
_PRESSURE_BUSY = 1.0


def _aimd_move(
    *,
    err_rate: float,
    pressure_lo: float,
    pressure_hi: float,
    error_rate_hi: float,
    overload_ratio_hi: float,
) -> str:
    """One AIMD decision for a boundary between a low (cheap) pool and its
    high-capacity neighbour. Returns ``"decrease" | "increase" | "hold"``.

    ``errors = preemptions + rejections + truncations`` in the window —
    every way the low pool can fail a request it should not have been sent.
    """
    if err_rate > error_rate_hi or (
        pressure_lo > overload_ratio_hi * max(pressure_hi, _PRESSURE_IDLE)
        and pressure_lo > _PRESSURE_BUSY
    ):
        return "decrease"
    if pressure_hi < _PRESSURE_IDLE and pressure_lo < _PRESSURE_BUSY:
        return "increase"
    return "hold"


@dataclasses.dataclass(frozen=True)
class BoundaryMove:
    """One recorded controller action (the trajectory unit).

    Besides the move itself, the record carries the windowed signals that
    caused it — the same per-pool observables the telemetry layer samples —
    so a trajectory is self-explaining without replaying the run.
    """

    t: int  # requests dispatched when the move fired
    boundary: int  # k: index into the threshold vector
    value: int  # B_k after the move
    reason: str  # "decrease" | "increase" | "clamp"
    #: Windowed error rate of the low pool (errors / window_requests).
    err_rate: float = 0.0
    #: Queue pressure (queued per instance) of the pool below the boundary.
    pressure_lo: float = 0.0
    #: Queue pressure of the pool above the boundary.
    pressure_hi: float = 0.0


class AdaptiveController:
    """N-boundary AIMD threshold control over a budget-ordered PoolSet.

    Each monitoring window the fleet reports, per pool (budget order):
    windowed error counts (preemptions + rejections + truncations), live
    queue depths, and instance counts. Every boundary ``B_k`` then takes
    one AIMD step from the pressure of the pool pair it separates, and the
    whole threshold vector is applied atomically through
    :meth:`~repro_torch.core.pools.PoolSet.set_thresholds` — clamped to
    ``[b_min, C_max,k]`` and kept strictly increasing, so the PoolSet (and
    the router's aliased hot-path view) never sees an invalid ordering.
    """

    def __init__(
        self,
        pool_set: Optional[PoolSet] = None,
        *,
        b_min: int = 512,
        increase_step: int = DEFAULT_INCREASE_STEP,
        decrease_factor: float = DEFAULT_DECREASE_FACTOR,
        error_rate_hi: float = DEFAULT_ERROR_RATE_HI,
        overload_ratio_hi: float = DEFAULT_OVERLOAD_RATIO_HI,
    ) -> None:
        if not 0.0 < decrease_factor < 1.0:
            raise ValueError(f"decrease_factor must be in (0,1): {decrease_factor}")
        self.b_min = int(b_min)
        self.increase_step = int(increase_step)
        self.decrease_factor = float(decrease_factor)
        self.error_rate_hi = float(error_rate_hi)
        self.overload_ratio_hi = float(overload_ratio_hi)
        self.pool_set: Optional[PoolSet] = None
        self.history: list[BoundaryMove] = []
        if pool_set is not None:
            self.bind(pool_set)

    def bind(self, pool_set: PoolSet) -> None:
        """Attach to the PoolSet whose thresholds this controller moves."""
        if len(pool_set) < 2:
            raise ValueError("adaptive control needs at least two pools")
        self.pool_set = pool_set

    @property
    def thresholds(self) -> list[int]:
        """Current boundary vector (live view of the bound PoolSet)."""
        if self.pool_set is None:
            raise RuntimeError("controller is not bound to a PoolSet")
        return [int(b) for b in self.pool_set.thresholds]

    def update(
        self,
        *,
        window_requests: int,
        errors: Sequence[int],
        queues: Sequence[int],
        instances: Sequence[int],
        t: int = 0,
    ) -> list[int]:
        """One control step per monitoring window; returns the new vector.

        ``errors``/``queues``/``instances`` are per-pool in budget order
        (length P). ``errors[k]`` is the *windowed* delta of
        preemptions + rejections + truncations in pool ``k``; queues and
        instances are read live at the window boundary.
        """
        pools = self.pool_set
        if pools is None:
            raise RuntimeError("controller is not bound to a PoolSet")
        p = len(pools)
        if not (len(errors) == len(queues) == len(instances) == p):
            raise ValueError(
                f"need per-pool signals of length {p}: got "
                f"{len(errors)}/{len(queues)}/{len(instances)}"
            )
        old = [int(b) for b in pools.thresholds]
        if window_requests <= 0:
            return old

        pressure = [
            queues[k] / max(1, instances[k]) for k in range(p)
        ]
        proposal = list(old)
        reasons = ["hold"] * (p - 1)
        for k in range(p - 1):
            move = _aimd_move(
                err_rate=errors[k] / window_requests,
                pressure_lo=pressure[k],
                pressure_hi=pressure[k + 1],
                error_rate_hi=self.error_rate_hi,
                overload_ratio_hi=self.overload_ratio_hi,
            )
            if move == "decrease":
                proposal[k] = int(old[k] * self.decrease_factor)
            elif move == "increase":
                proposal[k] = old[k] + self.increase_step
            reasons[k] = move

        new = self._clamp(proposal, old)
        if new != old:
            pools.set_thresholds(new)
            for k in range(p - 1):
                if new[k] != old[k]:
                    reason = reasons[k] if reasons[k] != "hold" else "clamp"
                    self.history.append(
                        BoundaryMove(
                            t=t,
                            boundary=k,
                            value=new[k],
                            reason=reason,
                            err_rate=errors[k] / window_requests,
                            pressure_lo=pressure[k],
                            pressure_hi=pressure[k + 1],
                        )
                    )
        return new

    def _clamp(self, proposal: list[int], old: list[int]) -> list[int]:
        """Feasibility projection: ``b_min ≤ B_k ≤ C_max,k`` with strict
        ordering, by a single forward pass with a running lower bound —
        valid by construction. Falls back to ``old`` (the last valid
        vector) in the degenerate case where no strictly increasing vector
        fits under the capacity caps."""
        pools = self.pool_set
        assert pools is not None
        lo = self.b_min
        new: list[int] = []
        for k, b in enumerate(proposal):
            cap = pools.configs[k].c_max  # B_k ≤ C_max,k (hard bound)
            if lo > cap:
                return list(old)
            new.append(min(max(b, lo), cap))
            lo = new[k] + 1
        return new


@dataclasses.dataclass
class AdaptiveThreshold:
    """Two-pool scalar AIMD controller (compatibility form).

    Owns its ``b_short`` copy rather than a PoolSet; callers are expected
    to push the returned boundary into their router by hand. New code
    should use :class:`AdaptiveController` with the ``FleetSim``
    ``controller=`` hook instead.
    """

    b_short: int
    b_min: int = 1024
    b_max: int = 8192  # short pool C_max
    increase_step: int = DEFAULT_INCREASE_STEP
    decrease_factor: float = DEFAULT_DECREASE_FACTOR
    error_rate_hi: float = DEFAULT_ERROR_RATE_HI
    overload_ratio_hi: float = DEFAULT_OVERLOAD_RATIO_HI

    def __post_init__(self) -> None:
        self.b_short = min(max(self.b_short, self.b_min), self.b_max)
        self.history: list[tuple[int, str]] = []

    def update(
        self,
        *,
        window_requests: int,
        short_errors: int,
        short_queue: int,
        short_instances: int,
        long_queue: int,
        long_instances: int,
    ) -> int:
        """One control step per monitoring window. Returns the new B_short.

        Pressure = queued requests per instance (the same quantity the
        spillover clause reads); errors = preemptions+rejections+truncations
        in the window.
        """
        if window_requests <= 0:
            return self.b_short
        move = _aimd_move(
            err_rate=short_errors / window_requests,
            pressure_lo=short_queue / max(1, short_instances),
            pressure_hi=long_queue / max(1, long_instances),
            error_rate_hi=self.error_rate_hi,
            overload_ratio_hi=self.overload_ratio_hi,
        )
        if move == "decrease":
            new_b = int(self.b_short * self.decrease_factor)
        elif move == "increase":
            new_b = self.b_short + self.increase_step
        else:
            new_b = self.b_short
        new_b = min(max(new_b, self.b_min), self.b_max)
        if new_b != self.b_short:
            self.history.append((new_b, move))
        self.b_short = new_b
        return new_b
