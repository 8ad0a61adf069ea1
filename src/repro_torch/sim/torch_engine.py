"""Device fleet backend (``backend="torch"``) and batched sensitivity grids:
the port of the reference's compiled tier, ``repro.sim.jax_engine``.

The reference compiles the whole event loop into one ``lax.while_loop`` and
``jax.vmap``\\ s it over grid lanes for :func:`run_fleet_grid`. This module
keeps that loop's semantics and structure and runs it as eager PyTorch on
one device, with the lanes as a leading axis ``G`` of every carried tensor
(``G = 1`` for a single fleet run):

* stacked ``(G, P, I, S)`` slot tensors for every lane and pool at once
  (pools padded to the widest instance and slot counts, lanes to the widest
  instance count of each pool; padding is inert: padded slots are never
  occupied, padded and dead instances never wake), with per-pool
  ``c_max``, ``n_seq`` and block budgets as ``(P,)`` tensors and per-lane
  thresholds, instance counts and controller gains as ``(G, ...)`` tensors;
* the outer epoch loop and the arrival drain (dispatch while the next
  arrival is no later than every instance wake; lanes share the trace but
  drain at their own wakes, each wave dispatching one arrival in every lane
  that has one due). A single run then sweeps rounds back-to-back until the
  next arrival (``iters <= n+1``); a grid runs exactly one masked round per
  outer iteration for all lanes, each to its own next arrival, as the
  reference's grid mode does (a nested sweep in lockstep runs every epoch to
  the slowest lane's round count, 5.6x more rounds at G = 16 in the
  reference's measurement). A lane whose trace is dispatched and whose
  wakes are all infinite is done: its counters stop and its state no
  longer moves (its masked rounds are no-ops);
* ``pool_round``: head-of-line FIFO admission with KV-block reservation as
  a fixpoint (one admission wave per iteration) that drains a per-instance
  victim stash before the FIFO; the fused decode-advance round
  (:func:`repro_torch.kernels.sim_decode.decode_advance`, the ``sim_decode``
  CUDA kernel on the GPU, one launch for every lane); the completion scatter
  into packed ``(G, n, ...)`` record tensors written in place; and the
  order-free batch preemption rule as a sort-free pass over the ``(S, S)``
  slot square (pairwise ranks and masked prefix sums), gated so the pass
  runs only when some instance of some lane is over its block budget (the
  skipped pass is a no-op);
* request-indexed FIFO linked lists (``qnext`` plus per-instance head and
  tail);
* the in-loop AIMD controller, mirrored in float32 with the constants and
  feasibility projection of :class:`repro_torch.core.adaptive
  .AdaptiveController`, on the same dispatched-request windows, firing per
  lane;
* per-request budgets precomputed on the host
  (:func:`precompute_budget_trajectory`, a sequential float32 EMA fold in
  arrival order on CPU tensors, as the reference folds on its host) and
  shared by every lane, so the loop itself only does a ``searchsorted`` per
  dispatch.

Numerics follow the reference's compiled tier exactly: event times
(``now``, ``ft``, ``end``, wakes, records) are float64 and counters int32,
every tensor has an explicit dtype and device, and the products that XLA
contracts into fused multiply-adds are fused here too (see
:mod:`repro_torch.core.fma`). So the records are bit-identical to the
reference's ``jax`` tier and to each lane of its ``run_fleet_grid`` in
every class, and to the host tiers in the exact classes (routerless single
pool, ``coalesce_dt=0``, dyadic timing).

Loop control: the while conditions (next arrival against each lane's
earliest wake, the admission fixpoint, the eviction gate) read device
values on the host, one read for all lanes each: one per drain wave, per
admission wave and per round. :func:`last_run_stats` counts them as
``host_syncs``. The arrival cursors and window counters evolve by counting
alone, so the host and the device each keep their own copy and no host
value is copied to the device inside the loop. The per-request records, the
slot state and the time limits stay on the device.

Telemetry: with windowed telemetry on, each window boundary also writes
one row of per-window snapshot tensors on the device (post-controller
thresholds, queue depths, active slots, free blocks, the cumulative
preemption / rejection / truncation counters, the dispatched arrival's
time), as the reference's compiled tier does. The host keeps the window
index by counting, so the snapshots add no host read; they are read once
after the loop and replayed into the host
:class:`~repro_torch.obs.timeseries.FleetTelemetry`
(:func:`_replay_telemetry`). With telemetry off nothing is allocated or
written.

Left out, against the reference: the AOT executable cache and its probes
(XLA-specific). ``FleetSim`` raises for event tracing and fault injection
on this backend, as the reference's compiled tier does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.adaptive import (
    BoundaryMove,
    DEFAULT_DECREASE_FACTOR,
    DEFAULT_ERROR_RATE_HI,
    DEFAULT_INCREASE_STEP,
    DEFAULT_OVERLOAD_RATIO_HI,
)
from repro_torch.core.calibration import (
    CalibState,
    EmaCalibrator,
    estimate_budget,
    update_stream,
)
from repro_torch.core.pools import TOTAL_KV_BLOCKS, PoolConfig
from repro_torch.core.router import pool_ids
from repro_torch.device import resolve_device
from repro_torch.kernels.sim_decode import (
    _BIG_I,
    blocks_for,
    decode_advance,
)
from repro_torch.sim.engine import _blocks_for
from repro_torch.sim.timing import TimingModel
from repro_torch.traces.generator import TraceColumns

I32 = torch.int32
F32 = torch.float32
F64 = torch.float64

#: Per-request record tensors (name, dtype, width), each ``(G, n, …)`` and
#: indexed by lane and request id. ``recf`` packs [first_token, finish];
#: ``reci`` packs [out_tokens, preemptions, truncated(0/1)]; ``rejt``
#: stages the admission-reject time (+inf = not rejected).
_REC_DTYPES = (
    ("recf", F64, 2),
    ("reci", I32, 3),
    ("pool", I32, 1),
    ("rejt", F64, 1),
)

#: Counters from the most recent run (see :func:`last_run_stats`).
_LAST_RUN: dict = {}


@dataclasses.dataclass(frozen=True)
class _PoolSpec:
    """Shape and capacity facts for one pool."""

    name: str
    c_max: int
    n_seq: int
    total_blocks: int
    max_inst: int


@dataclasses.dataclass(frozen=True)
class _SimSpec:
    pools: tuple[_PoolSpec, ...]
    w: float  # roofline W (seconds)
    h: float  # roofline H (seconds)
    prefill_chunk: int
    win_size: int  # monitoring window in dispatched requests; 0 = off


def last_run_stats() -> dict:
    """Loop counters of the most recent run in this process: ``iters``
    (outer epochs; at most ``n + 1`` for a single run), ``rounds`` (rounds
    run), ``host_syncs`` (device reads by the loop's conditions, each
    covering every lane), ``n``, ``mode`` (``"fleet"`` or ``"grid"``) and
    ``device``. A grid adds ``g`` and reports ``iters`` / ``rounds`` as the
    maxima over lanes, beside their sums ``iters_total`` /
    ``rounds_total``, as the reference does."""
    return dict(_LAST_RUN)


def _fresh_records(n: int, g: int, device: torch.device) -> dict:
    """Record tensors for one run of ``g`` lanes; ``rejt`` is +inf-filled."""
    rec = {}
    for name, dt, w in _REC_DTYPES:
        shape = (g, n) if w == 1 else (g, n, w)
        fill = math.inf if name == "rejt" else 0
        rec[name] = torch.full(shape, fill, dtype=dt, device=device)
    return rec


def _init_windows(g: int, P: int, nb: int, win_cap: int, device: torch.device) -> dict:
    """Per-window telemetry snapshots of ``g`` lanes, ``win_cap`` rows each:
    the dispatched count and time at the boundary, the thresholds (``nb``
    columns) and the per-pool gauges and cumulative counters."""

    def zeros(shape, dtype):
        return torch.zeros((g, win_cap) + shape, dtype=dtype, device=device)

    return {
        "t_req": zeros((), I32),
        "now": zeros((), F64),
        "th": zeros((nb,), I32),
        **{k: zeros((P,), I32) for k in ("queue", "active", "freeb", "pre", "rej", "trunc")},
    }


def _init_pools(spec: _SimSpec, n: int, g: int, device: torch.device) -> dict:
    """Stacked ``(G, P, I, S)`` pool state (padded to the widest pool)."""
    P = len(spec.pools)
    I = max(ps.max_inst for ps in spec.pools)
    S = max(ps.n_seq for ps in spec.pools)
    ivalid = torch.arange(I, device=device)[None, :] < torch.tensor(
        [ps.max_inst for ps in spec.pools], dtype=I32, device=device
    )[:, None]
    tblocks = torch.tensor(
        [ps.total_blocks for ps in spec.pools], dtype=I32, device=device
    )

    def full(shape, value, dtype):
        return torch.full((g,) + shape, value, dtype=dtype, device=device)

    return {
        "occ": full((P, I, S), False, torch.bool),
        "rid": full((P, I, S), -1, I32),
        "enq": full((P, I, S), 0.0, F64),
        "inp": full((P, I, S), 0, I32),
        "outp": full((P, I, S), 0, I32),
        "pre": full((P, I, S), 0, I32),
        "rem": full((P, I, S), 0, I32),
        "gen": full((P, I, S), 0, I32),
        "blk": full((P, I, S), 0, I32),
        "ft": full((P, I, S), math.nan, F64),
        "tr": full((P, I, S), False, torch.bool),
        "pc": full((P, I, S), 0, I32),
        "sq": full((P, I, S), 0, I32),
        "free": torch.where(ivalid, tblocks[:, None], 0).to(I32).expand(g, P, I).clone(),
        "wake": full((P, I), math.inf, F64),
        "nact": full((P, I), 0, I32),
        "qlen": full((P, I), 0, I32),
        "load": full((P, I), 0, I32),
        "qh": full((P, I), -1, I32),
        "qt": full((P, I), -1, I32),
        "qnext": full((P, n + 1), -1, I32),
        "vrid": full((P, I, S), 0, I32),
        "vinp": full((P, I, S), 0, I32),
        "vpc": full((P, I, S), 0, I32),
        "vcnt": full((P, I), 0, I32),
        "sqc": full((P,), 0, I32),
        "npre": full((P,), 0, I32),
        "nrej": full((P,), 0, I32),
        "ntr": full((P,), 0, I32),
    }


class _FleetLoop:
    """One run of ``G`` lanes: the reference's ``core`` (vmapped over the
    lanes in grid mode) as an object.

    ``lanes`` holds the per-lane parameters: ``th`` ``(G, P-1)``, ``ninst``
    ``(G, P)`` and ``ctrl``, a dict of ``(G,)`` controller gains. With
    ``grid`` false the run sweeps rounds until the next arrival (``G`` must
    be 1); with ``grid`` true it runs one round per outer iteration.

    The arrival cursors ``a``, the monitoring-window counters and the loop
    counters are host integer arrays: they evolve by counting alone. ``a``
    and the window counters have device twins that the same masks advance,
    so the loop never copies a host value to the device. Everything else
    lives on ``device``. With ``telemetry`` the window boundaries also fill
    the snapshot tensors of :func:`_init_windows`, at row indices the host
    counts (``wi``).
    """

    def __init__(self, spec: _SimSpec, trace: dict, lanes: dict, device: torch.device,
                 *, grid: bool, telemetry: bool = False):
        dev = self.dev = device
        self.spec = spec
        self.grid = grid
        P = self.P = len(spec.pools)
        I = self.I = max(ps.max_inst for ps in spec.pools)
        S = self.S = max(ps.n_seq for ps in spec.pools)
        n = self.n = len(trace["arr"])
        G = self.G = len(lanes["ninst"])
        if not grid and G != 1:
            raise ValueError("a single fleet run has one lane")
        self.win = spec.win_size
        self.cmax_v = torch.tensor([ps.c_max for ps in spec.pools], dtype=I32, device=dev)
        self.nseq_v = torch.tensor([ps.n_seq for ps in spec.pools], dtype=I32, device=dev)
        self.tblk_v = torch.tensor([ps.total_blocks for ps in spec.pools], dtype=I32, device=dev)
        self.pg = torch.arange(P, device=dev)
        self.gl = torch.arange(G, device=dev)
        self.ar_s = torch.arange(S, device=dev)
        self.eye = torch.eye(S, dtype=torch.bool, device=dev)
        # trace columns (arrival order), shared by the lanes;
        # arr_p[n] = +inf is next_arr_at(n)
        self.arr_host = np.append(np.asarray(trace["arr"], np.float64), math.inf)
        self.arr = torch.as_tensor(self.arr_host[:n], dtype=F64).to(dev)
        self.arr_p = torch.as_tensor(self.arr_host, dtype=F64).to(dev)
        self.inp = torch.as_tensor(trace["inp"], dtype=I32).to(dev)
        self.outp = torch.as_tensor(trace["outp"], dtype=I32).to(dev)
        self.bud = torch.as_tensor(trace["budget"], dtype=I32).to(dev)
        # lane parameters
        self.th = torch.as_tensor(np.asarray(lanes["th"]).reshape(G, P - 1), dtype=I32).to(dev)
        self.ninst = torch.as_tensor(np.asarray(lanes["ninst"]), dtype=I32).to(dev)
        self.alive = torch.arange(I, device=dev) < self.ninst[:, :, None]
        (self.ctrl_on, self.b_min, self.step, self.factor, self.err_hi,
         self.over_hi) = _ctrl_lanes(lanes["ctrl"], G, dev)
        # carried state
        self.st = _init_pools(spec, n, G, dev)
        self.rec = _fresh_records(n, G, dev)
        self.a = np.zeros(G, np.int64)
        self.a_dev = torch.zeros(G, dtype=torch.int64, device=dev)
        self.iters = np.zeros(G, np.int64)
        self.rounds = np.zeros(G, np.int64)
        self.host_syncs = 0
        self.win_seen = np.zeros(G, np.int64)
        self.win_prev = np.zeros(G, np.int64)
        self.win_seen_dev = torch.zeros(G, dtype=torch.int64, device=dev)
        self.win_prev_dev = torch.zeros(G, dtype=torch.int64, device=dev)
        self.prev_err = torch.zeros((G, P), dtype=I32, device=dev)
        self.moves = torch.zeros((G,), dtype=I32, device=dev)
        # (window fire mask, dispatched count, thresholds) at each boundary
        self.win_log: list[tuple[np.ndarray, np.ndarray, torch.Tensor]] = []
        self.wins = None
        self.wi = np.zeros(G, np.int64)  # snapshot rows written, per lane
        if telemetry and self.win > 0:
            self.wins = _init_windows(G, P, max(P - 1, 1), n // self.win + 2, dev)
        self._wake_min = np.full(G, math.inf)  # last values read from the device
        self._wake_min_dev = torch.full((G,), math.inf, dtype=F64, device=dev)
        self._wake_fresh = True  # no wake has changed since that read

    # -- host reads ----------------------------------------------------------
    def _read(self, t: torch.Tensor) -> np.ndarray:
        """One device tensor on the host: one sync."""
        self.host_syncs += 1
        return t.cpu().numpy()

    def _read_all(self, *ts: torch.Tensor) -> list[int]:
        """Several device scalars (flags and counts) in one host read."""
        self.host_syncs += 1
        return torch.stack([t.to(torch.int64) for t in ts]).tolist()

    @staticmethod
    def _rows(mask: torch.Tensor, count: int) -> torch.Tensor:
        """Flat indices of the ``count`` true entries of ``mask``; the count
        was read on the host already, so this needs no device sync."""
        return torch.nonzero_static(mask.flatten(), size=count)[:, 0]

    def wake_min(self) -> np.ndarray:
        """Each lane's earliest wake, read once for all lanes when a wake
        has changed since the last read."""
        if not self._wake_fresh:
            self._wake_min_dev = self.st["wake"].view(self.G, -1).amin(dim=1)
            self._wake_min = self._read(self._wake_min_dev)
            self._wake_fresh = True
        return self._wake_min

    def live(self) -> np.ndarray:
        """Lanes with arrivals left or a finite wake (the reference's loop
        condition, per lane); reads the wakes only when some lane has
        dispatched its whole trace."""
        live = self.a < self.n
        if not live.all():
            live = live | np.isfinite(self.wake_min())
        return live

    # -- monitoring window + in-loop AIMD controller ---------------------------
    def window_step(self, fire: np.ndarray, now: torch.Tensor) -> None:
        """One window boundary in the lanes of ``fire`` (only called when
        some lane's fires): the AIMD rule of ``AdaptiveController`` per
        boundary in float32, the feasibility projection, then the threshold
        snapshot for the controller history and, with telemetry, one
        snapshot row a firing lane taken at ``now`` (the dispatched
        arrival's time). The device computes the same fire mask from its
        own window counters."""
        st, P = self.st, self.P
        wr_dev = self.win_seen_dev - self.win_prev_dev
        fire_dev = wr_dev >= self.win
        cur = st["npre"] + st["nrej"] + st["ntr"]
        if P > 1:
            delta = cur - self.prev_err
            queues = st["qlen"].sum(dim=-1, dtype=I32)
            pressure = queues.to(F32) / torch.clamp(self.ninst, min=1).to(F32)
            old = self.th
            wrf = torch.clamp(wr_dev, min=1).to(F32)
            props = []
            for k in range(P - 1):
                err_rate = delta[:, k].to(F32) / wrf
                p_lo, p_hi = pressure[:, k], pressure[:, k + 1]
                dec = (err_rate > self.err_hi) | (
                    (p_lo > self.over_hi * torch.clamp(p_hi, min=0.25)) & (p_lo > 1.0)
                )
                inc = (~dec) & (p_hi < 0.25) & (p_lo < 1.0)
                down = (old[:, k].to(F32) * self.factor).to(I32)
                props.append(
                    torch.where(dec, down, torch.where(inc, old[:, k] + self.step, old[:, k]))
                )
            # feasibility projection: forward pass with a running lower
            # bound; the degenerate case keeps the old vector
            lo = self.b_min
            feasible = torch.ones((self.G,), dtype=torch.bool, device=self.dev)
            newv = []
            for k in range(P - 1):
                cap = self.spec.pools[k].c_max
                feasible = feasible & (lo <= cap)
                nk = torch.clamp(torch.maximum(props[k], lo), max=cap)
                newv.append(nk)
                lo = nk + 1
            newv = torch.where(feasible[:, None], torch.stack(newv, dim=1), old).to(I32)
            apply = fire_dev & self.ctrl_on & (wr_dev > 0)
            self.moves = self.moves + (apply & (newv != old).any(dim=1)).to(I32)
            self.th = torch.where(apply[:, None], newv, old)
        self.win_log.append((fire.copy(), self.win_seen.copy(), self.th))
        if self.wins is not None:
            self.snapshot(fire, now)
        self.prev_err = torch.where(fire_dev[:, None], cur, self.prev_err)
        self.win_prev = np.where(fire, self.win_seen, self.win_prev)
        self.win_prev_dev = torch.where(fire_dev, self.win_seen_dev, self.win_prev_dev)

    def snapshot(self, fire: np.ndarray, now: torch.Tensor) -> None:
        """One telemetry row in each lane of ``fire``, after the controller
        has moved the thresholds: the row index is the host's window count,
        so the values are written with no host read."""
        st = self.st
        vals = {
            "t_req": self.win_seen_dev.to(I32),
            "now": now,
            "queue": st["qlen"].sum(dim=-1, dtype=I32),
            "active": st["nact"].sum(dim=-1, dtype=I32),
            "freeb": st["free"].sum(dim=-1, dtype=I32),
            "pre": st["npre"],
            "rej": st["nrej"],
            "trunc": st["ntr"],
        }
        if self.P > 1:  # one pool has no boundary: its column stays 0
            vals["th"] = self.th
        for g in np.flatnonzero(fire):
            for key, val in vals.items():
                self.wins[key][g, self.wi[g]] = val[g]
        self.wi += fire

    # -- arrival drain -----------------------------------------------------------
    def dispatch(self, m: np.ndarray) -> None:
        """One drain wave: in each lane of ``m``, route its next arrival
        (threshold search on its precomputed budget), pick the least-loaded
        live instance of every pool, and enqueue it on the chosen pool's
        instance (submit-time rejects only count). The device rebuilds
        ``m`` from the wakes it was read from."""
        st, n, G = self.st, self.n, self.G
        a = self.a_dev
        m_dev = (a < n) & (self.arr_p[a] <= self._wake_min_dev)
        ac = torch.clamp(a, max=n - 1)
        t = self.arr[ac]
        if self.P > 1:
            pidx = pool_ids(self.th, self.bud[ac][:, None])[:, 0]
        else:
            pidx = torch.zeros((G,), dtype=I32, device=self.dev)
        prow = self.gl * n + ac
        pool_flat = self.rec["pool"].view(-1)
        pool_flat[prow] = torch.where(m_dev, pidx, pool_flat[prow])
        sel = (pidx[:, None] == self.pg) & m_dev[:, None]
        i = torch.argmin(torch.where(self.alive, st["load"], _BIG_I), dim=2)
        rej = self.inp[ac][:, None] >= self.cmax_v
        ok = sel & ~rej
        gi, pi = self.gl[:, None], self.pg[None, :]
        qh_i = st["qh"][gi, pi, i]
        qt_i = st["qt"][gi, pi, i]
        wake_i = st["wake"][gi, pi, i]
        was_empty = qh_i < 0
        a_i = ac.to(I32)[:, None]
        st["qnext"][gi, pi, torch.where(ok, ac[:, None], n)] = -1
        st["qnext"][gi, pi, torch.where(ok & ~was_empty, qt_i, n).long()] = a_i.expand(-1, self.P)
        st["qh"][gi, pi, i] = torch.where(ok & was_empty, a_i, qh_i)
        st["qt"][gi, pi, i] = torch.where(ok, a_i, qt_i)
        st["qlen"][gi, pi, i] += ok.to(I32)
        st["load"][gi, pi, i] += ok.to(I32)
        st["wake"][gi, pi, i] = torch.where(ok & torch.isinf(wake_i), t[:, None], wake_i)
        st["nrej"] += (sel & rej).to(I32)
        self._wake_fresh = False
        self.a += m
        self.a_dev = a + m_dev
        self.win_seen += m
        self.win_seen_dev = self.win_seen_dev + m_dev
        if self.win > 0:
            fire = self.win_seen - self.win_prev >= self.win
            if fire.any():
                self.window_step(fire, t)

    def drain(self) -> None:
        # Arrival-first tie-break: dispatch while t_arr <= every wake of the
        # lane; one read of the wakes per wave.
        n = self.n
        while (self.a < n).any():
            m = (self.a < n) & (self.arr_host[self.a] <= self.wake_min())
            if not m.any():
                return
            self.dispatch(m)

    # -- one masked round over the stacked lanes and pools -----------------------
    def admit(self, due: torch.Tensor) -> None:
        """Admission fixpoint: one wave admits or rejects at most one head
        (victim stash first, then the FIFO) per due instance, in every lane,
        until no instance can make progress. Each instance fills at most one
        slot per wave, written in place through its slot index."""
        st, rec, n = self.st, self.rec, self.n
        PI = self.P * self.I
        while True:
            stash = st["vcnt"] > 0
            hrid = torch.where(stash, st["vrid"][..., 0], st["qh"])
            has = due & (stash | (st["qh"] >= 0))
            hc = torch.clamp(hrid, 0, n - 1).long()
            hinp = torch.where(stash, st["vinp"][..., 0], self.inp[hc])
            hpc = torch.where(stash, st["vpc"][..., 0], 0)
            need = blocks_for(hinp)
            can = st["nact"] < self.nseq_v[:, None]
            rejm = has & can & (need > self.tblk_v[:, None])
            admm = has & can & ~rejm & (need <= st["free"])
            prog = rejm | admm
            pop_st = prog & stash
            n_adm, n_rej, any_pop_st = self._read_all(
                admm.sum(), rejm.sum(), pop_st.any()
            )
            if not (n_adm or n_rej):
                return
            # pop the head (victim stash first — head-of-line order)
            if any_pop_st:
                for key in ("vrid", "vinp", "vpc"):
                    st[key] = torch.where(
                        pop_st[..., None], torch.roll(st[key], -1, dims=-1), st[key]
                    )
            pop_f = prog & ~stash
            nxt = torch.gather(st["qnext"], 2, torch.clamp(st["qh"], 0, n).long())
            st["qt"] = torch.where(pop_f & (nxt < 0), -1, st["qt"]).to(I32)
            st["qh"] = torch.where(pop_f, nxt, st["qh"])
            if n_rej:
                # stage the reject time (the host's first = finish = now)
                rows = self._rows(rejm, n_rej)
                rec["rejt"].view(-1).index_copy_(
                    0, (rows // PI) * n + hc.flatten()[rows], st["wake"].flatten()[rows]
                )
            base = st["sqc"]
            admi = admm.to(I32)
            if n_adm:
                # admit into the first free slot of each admitting instance
                rows = self._rows(admm, n_adm)
                slot = torch.argmin(st["occ"].to(I32), dim=-1).flatten()[rows]
                flat = rows * self.S + slot
                rank = torch.cumsum(admi, dim=-1, dtype=I32) - admi
                out_h = self.outp[hc]
                for key, val in (
                    ("rid", hrid), ("enq", self.arr[hc]), ("inp", hinp),
                    ("outp", out_h), ("pre", hinp), ("rem", out_h),
                    ("blk", need), ("pc", hpc), ("sq", base[..., None] + rank),
                ):
                    st[key].view(-1).index_copy_(0, flat, val.flatten()[rows])
                for key, val in (
                    ("occ", True), ("gen", 0), ("ft", math.nan), ("tr", False)
                ):
                    st[key].view(-1).index_fill_(0, flat, val)
            st["vcnt"] = st["vcnt"] - pop_st.to(I32)
            st["qlen"] = st["qlen"] - prog.to(I32)
            st["load"] = st["load"] - rejm.to(I32)
            st["nrej"] = st["nrej"] + rejm.sum(dim=-1, dtype=I32)
            st["sqc"] = base + admm.sum(dim=-1, dtype=I32)
            st["free"] = st["free"] - torch.where(admm, need, 0)
            st["nact"] = st["nact"] + admi

    def evict_pass(self, surv, grow, demand, free1, blk0, inp2, gen_a):
        """Sort-free eviction: the youngest-first (enqueue time descending,
        admission seq tie-break) minimal prefix of decoding survivors whose
        freed blocks cover the growth deficit, from pairwise ranks and
        masked prefix sums over the (S, S) slot square; victims go to the
        stash in admission order, ahead of the previous stash."""
        st, S = self.st, self.S
        keyq = torch.where(surv, -st["enq"], math.inf)
        sq = st["sq"]
        k_a, k_b = keyq[..., :, None], keyq[..., None, :]
        sq_lt = sq[..., None, :] < sq[..., :, None]  # [a, b]: b before a
        prec = (k_b < k_a) | ((k_b == k_a) & sq_lt)
        rank = prec.sum(dim=-1, dtype=I32)
        le = prec | self.eye
        blkv = torch.where(surv, blk0, 0)
        cum_blk = torch.where(le, blkv[..., None, :], 0).sum(dim=-1, dtype=I32)
        cum_grow = torch.where(le, grow[..., None, :], 0).sum(dim=-1, dtype=I32)
        okj = demand[..., None] - cum_grow <= free1[..., None] + cum_blk
        first_ok = torch.where(okj, rank, S).amin(dim=-1)
        jsel = torch.where(
            demand <= free1, 0, torch.where(first_ok < S, first_ok + 1, 1)
        )
        ev = (rank < jsel[..., None]) & surv
        nev = ev.sum(dim=-1, dtype=I32)
        vrank = (ev[..., None, :] & sq_lt).sum(dim=-1, dtype=I32)
        rr = self.ar_s
        in_new = rr < nev[..., None]
        # vm[j, a]: stash slot j takes the victim in slot a (victim rank j);
        # om[j, a]: stash slot j takes previous-stash slot a = j - n_victims
        vm = ev[..., None, :] & (vrank[..., None, :] == rr[:, None]) & in_new[..., :, None]
        om = (rr == rr[:, None] - nev[..., None, None]) & ~in_new[..., :, None]

        def stash(old3, vals):
            return torch.where(vm, vals[..., None, :], 0).sum(
                dim=-1, dtype=I32
            ) + torch.where(om, old3[..., None, :], 0).sum(dim=-1, dtype=I32)

        vr = stash(st["vrid"], st["rid"])
        vi = stash(st["vinp"], inp2 + gen_a)
        vp = stash(st["vpc"], st["pc"] + 1)
        return ev, nev, vr, vi, vp

    def pool_round(self, t_limit: torch.Tensor) -> None:
        """One masked round of every lane, each to its own ``t_limit``."""
        st, rec, n = self.st, self.rec, self.n
        G, P, I, S = self.G, self.P, self.I, self.S
        due = st["wake"] < t_limit[:, None, None]
        self.admit(due)

        nact = st["nact"]
        busy = due & (nact > 0)
        idle = due & ~busy
        wake_idle = torch.where(
            idle,
            torch.where(st["qlen"] > 0, st["wake"] + 1e-9, math.inf),
            st["wake"],
        )
        now = torch.where(busy, st["wake"], 0.0)
        bb = busy[..., None]
        occ = st["occ"]
        inp2, gen0, rem0, blk0 = st["inp"], st["gen"], st["rem"], st["blk"]

        adv = decode_advance(
            t_limit, busy, now, nact, st["free"], occ, st["pre"], st["sq"],
            inp2, gen0, rem0, blk0, st["ft"], st["tr"], self.cmax_v,
            w=self.spec.w, h=self.spec.h, chunk=self.spec.prefill_chunk,
        )
        dec, end = adv["dec"], adv["end"]
        gen_a, rem_a, ft_a, tr_a, comp = (
            adv["gen"], adv["rem"], adv["ft"], adv["tr"], adv["comp"]
        )
        ntr = st["ntr"] + adv["trunc_new"].sum(dim=(-2, -1), dtype=I32)

        ncomp = comp.sum(dim=-1, dtype=I32)
        free1 = st["free"] + torch.where(comp, blk0, 0).sum(dim=-1, dtype=I32)
        surv = dec & (rem_a > 0) & bb
        need_s = torch.where(surv, blocks_for(inp2 + gen_a), blk0)
        grow = torch.where(surv, need_s - blk0, 0)
        demand = grow.sum(dim=-1, dtype=I32)
        over, n_comp = self._read_all((demand > free1).any(), ncomp.sum())

        # completion scatter into the record tensors, in place (request ids
        # are unique within a lane, so every row is written at most once)
        if n_comp:
            rows = self._rows(comp, n_comp)
            ids = (rows // (P * I * S)) * n + st["rid"].flatten()[rows].long()
            rec["recf"].view(-1, 2).index_copy_(0, ids, torch.stack(
                [ft_a.flatten()[rows], end.flatten()[rows // S]], dim=-1
            ))
            rec["reci"].view(-1, 3).index_copy_(0, ids, torch.stack(
                [gen_a.flatten()[rows], st["pc"].flatten()[rows],
                 tr_a.flatten()[rows].to(I32)], dim=-1
            ))

        if over:
            evict, nevict, vrid, vinp, vpc = self.evict_pass(
                surv, grow, demand, free1, blk0, inp2, gen_a
            )
        else:
            # demand <= free everywhere: nothing evicts, the stash stays
            evict = torch.zeros((G, P, I, S), dtype=torch.bool, device=self.dev)
            nevict = torch.zeros((G, P, I), dtype=I32, device=self.dev)
            vrid, vinp, vpc = st["vrid"], st["vinp"], st["vpc"]
        npre = st["npre"] + evict.sum(dim=(-2, -1), dtype=I32)
        free1 = free1 + torch.where(evict, blk0, 0).sum(dim=-1, dtype=I32)
        keep = surv & ~evict
        free1 = free1 - torch.where(keep, grow, 0).sum(dim=-1, dtype=I32)
        cleared = comp | evict
        nact_a = nact - ncomp - nevict
        qlen_a = st["qlen"] + nevict
        alive_r = (nact_a > 0) | (qlen_a > 0)

        st["occ"] = torch.where(bb, occ & ~cleared, occ)
        st["pre"] = adv["pre"]
        st["rem"] = torch.where(bb, rem_a, rem0)
        st["gen"] = torch.where(bb, gen_a, gen0)
        st["blk"] = torch.where(
            bb, torch.where(cleared, 0, torch.where(keep, need_s, blk0)), blk0
        )
        st["ft"] = torch.where(bb, ft_a, st["ft"])
        st["tr"] = torch.where(bb, tr_a, st["tr"])
        st["vrid"] = torch.where(bb, vrid, st["vrid"])
        st["vinp"] = torch.where(bb, vinp, st["vinp"])
        st["vpc"] = torch.where(bb, vpc, st["vpc"])
        st["vcnt"] = torch.where(busy, st["vcnt"] + nevict, st["vcnt"])
        st["free"] = torch.where(busy, free1, st["free"])
        st["nact"] = torch.where(busy, nact_a, nact)
        st["qlen"] = torch.where(busy, qlen_a, st["qlen"])
        st["load"] = torch.where(busy, st["load"] - ncomp, st["load"])
        st["wake"] = torch.where(
            busy, torch.where(alive_r, end, math.inf), wake_idle
        )
        st["npre"] = npre
        st["ntr"] = ntr
        self._wake_fresh = False

    # -- outer epoch loop ----------------------------------------------------------
    def run(self) -> None:
        """The device loop: epochs until every lane has dispatched its trace
        and drained; :meth:`fold_records` then reads the results."""
        while (live := self.live()).any():
            self.drain()
            t_limit = self.arr_p[self.a_dev]  # each lane's next arrival
            if self.grid:
                # exactly one masked round per outer iteration for all lanes
                self.pool_round(t_limit)
                self.rounds += live
            else:
                # coalesced sweep: rounds back-to-back until the next arrival
                t_lim = self.arr_host[self.a[0]]
                while self.wake_min()[0] < t_lim:
                    self.pool_round(t_limit)
                    self.rounds += 1
            self.iters += live

    def fold_records(self) -> dict:
        """Post-loop: admission rejects (finite staged time) and submit
        rejects (prompt >= the recorded pool's C_max) get first = finish =
        the reject time. Returns the ``(G, n, ...)`` record tensors on the
        device and the counters on the host (read after the loop, so not
        counted in ``host_syncs``)."""
        rec, st = self.rec, self.st
        rejt, pool = rec["rejt"], rec["pool"]
        arej = torch.isfinite(rejt)
        rejm = arej | (self.inp >= self.cmax_v[pool.long()])
        recf = torch.where(
            rejm[..., None], torch.where(arej, rejt, self.arr)[..., None], rec["recf"]
        )
        return {
            "recf": recf,
            "reci": rec["reci"],
            "pool": pool,
            "rejt": rejt,
            "rej": rejm,
            "preempt": st["npre"].cpu().numpy(),
            "reject": st["nrej"].cpu().numpy(),
            "truncate": st["ntr"].cpu().numpy(),
            "th": self.th.cpu().numpy(),
            "moves": self.moves.cpu().numpy(),
            "nwin": self.wi.copy(),
            "win": None if self.wins is None else {
                k: v.cpu().numpy() for k, v in self.wins.items()
            },
        }

    def history(self, lane: int) -> list[tuple[int, np.ndarray]]:
        """One lane's ``(dispatched count, thresholds)`` at each of its
        window boundaries."""
        return [
            (int(seen[lane]), th[lane].cpu().numpy())
            for fire, seen, th in self.win_log
            if fire[lane]
        ]


# ---------------------------------------------------------------------------
# Host-side routing precompute
# ---------------------------------------------------------------------------


def precompute_budget_trajectory(
    cols: TraceColumns,
    calibrator: EmaCalibrator,
    *,
    epoch_cap: int,
) -> tuple[np.ndarray, CalibState]:
    """Per-request estimated budgets with epoch-lagged EMA feedback; the
    counterpart of the reference function of the same name.

    Routing epochs ramp from 64 doubling to ``epoch_cap`` (the vectorized
    backend's schedule): an epoch's requests are estimated with the EMA
    state as of the epoch start (:func:`estimate_budget`), then the epoch's
    observations fold in, in arrival order (:func:`update_stream`). This
    runs on CPU tensors whatever the fleet's device, as the reference runs
    it on its host: it is a sequential float32 fold. The reference pads
    each epoch to its ramp width for JAX's shape cache; the pad rows are
    inert, so the unpadded fold gives the same budgets and final state.

    Returns ``(budgets int32 (n,), final CalibState)``.
    """
    n = len(cols)
    budgets = np.zeros(n, dtype=np.int32)
    state = calibrator.to_state()
    gamma = float(calibrator.gamma)
    beta = float(calibrator.beta)
    chunk = min(64, epoch_cap)
    pos = 0
    while pos < n:
        start = pos
        pos = min(n, pos + chunk)
        chunk = min(epoch_cap, chunk * 2)
        cat = torch.as_tensor(np.asarray(cols.category[start:pos]), dtype=I32)
        budgets[start:pos] = estimate_budget(
            state,
            torch.as_tensor(np.asarray(cols.byte_len[start:pos])),
            torch.as_tensor(np.asarray(cols.max_output_tokens[start:pos])),
            cat,
            gamma=gamma,
        ).numpy()
        state = update_stream(
            state,
            torch.as_tensor(np.asarray(cols.byte_len[start:pos], np.float32)),
            torch.as_tensor(np.asarray(cols.true_input_tokens[start:pos], np.float32)),
            cat,
            beta=beta,
        )
    return budgets, state


def _ctrl_lanes(ctrl: dict, g: int, dev: torch.device) -> tuple:
    """A gain pack's ``g`` lanes on the device: (enabled, b_min, step,
    factor, err_hi, over_hi), the gains in window_step's float32."""
    ctrl = {k: np.asarray(v).reshape(g) for k, v in ctrl.items()}
    return (
        torch.as_tensor(ctrl["enabled"] > 0).to(dev),
        torch.as_tensor(ctrl["b_min"], dtype=I32).to(dev),
        torch.as_tensor(ctrl["step"], dtype=I32).to(dev),
        *(torch.as_tensor(ctrl[k], dtype=F32).to(dev) for k in ("factor", "err_hi", "over_hi")),
    )


def _ctrl_params(controller, enabled: bool) -> dict:
    """Controller gains (defaults when there is no controller)."""
    if controller is None:
        return {
            "enabled": 0,
            "b_min": 512,
            "step": DEFAULT_INCREASE_STEP,
            "factor": np.float32(DEFAULT_DECREASE_FACTOR),
            "err_hi": np.float32(DEFAULT_ERROR_RATE_HI),
            "over_hi": np.float32(DEFAULT_OVERLOAD_RATIO_HI),
        }
    return {
        "enabled": 1 if enabled else 0,
        "b_min": int(controller.b_min),
        "step": int(controller.increase_step),
        "factor": np.float32(controller.decrease_factor),
        "err_hi": np.float32(controller.error_rate_hi),
        "over_hi": np.float32(controller.overload_ratio_hi),
    }


def _as_columns(trace) -> TraceColumns:
    return (
        trace
        if isinstance(trace, TraceColumns)
        else TraceColumns.from_requests(trace)
    ).sorted_by_arrival()


def _fleet_spec(fleet):
    """The run's spec, from the live FleetSim's budget-ordered shells."""
    ordered = sorted(fleet._pool_index, key=fleet._pool_index.get)
    shells = [fleet.pools[name] for name in ordered]
    spec = _SimSpec(
        # capacities from the live shells, so total_blocks overrides count
        pools=tuple(
            _PoolSpec(
                name=name,
                c_max=int(s.config.c_max),
                n_seq=int(s.config.n_seq),
                total_blocks=int(s.total_blocks),
                max_inst=int(s.num_instances),
            )
            for name, s in zip(ordered, shells)
        ),
        w=float(fleet.timing.w_base),
        h=float(fleet.timing.h_per_seq),
        prefill_chunk=int(fleet.timing.prefill_chunk),
        win_size=int(fleet._win_size),
    )
    return spec, ordered, shells


# ---------------------------------------------------------------------------
# FleetSim backend entry
# ---------------------------------------------------------------------------


def run_fleet_torch(fleet, trace):
    """Execute one fleet run on the torch backend; returns FleetResult.

    Called by ``FleetSim.run`` for ``backend="torch"``, on
    ``fleet.device``. The fleet's ``VectorPoolSim`` shells receive the
    device-computed records and counters afterwards, so
    ``fleet.pools[name].record_arrays()``, the telemetry replay and
    ``router.stats()`` behave like a host run.
    """
    from repro_torch.sim.fleet import FleetResult
    from repro_torch.sim.metrics import summarize_columns

    cols = _as_columns(trace)
    n = len(cols)
    spec, ordered, shells = _fleet_spec(fleet)
    P = len(spec.pools)

    router = fleet.router
    budgets = None
    if router is not None and n:
        epoch_cap = (
            fleet.epoch
            if fleet.controller is None
            else max(1, min(fleet.epoch, fleet.control_window))
        )
        budgets, final_state = precompute_budget_trajectory(
            cols, router.calibrator, epoch_cap=epoch_cap
        )
        router.calibrator.load_state(final_state)
        th0 = [int(b) for b in router.pools.thresholds]
    else:
        th0 = []
    if fleet.telemetry is not None:
        fleet.telemetry.set_trace(
            cols.byte_len, cols.category, cols.true_input_tokens,
            cols.max_output_tokens,
        )

    if n == 0:
        empty = {k: np.empty(0, dt) for k, dt in (
            ("request_id", np.int64), ("arrival", np.float64),
            ("first_token", np.float64), ("finish", np.float64),
            ("output_tokens", np.int64), ("preemptions", np.int64),
            ("truncated", bool), ("rejected", bool),
        )}
        return FleetResult(
            summary=summarize_columns("fleet", empty),
            per_pool={name: summarize_columns(name, empty) for name in ordered},
            router_stats=router.stats() if router else {},
            preemptions=0, rejections=0, truncations=0,
            telemetry=fleet.telemetry, slo=fleet.slo,
        )

    trace_arrays = {
        "arr": np.asarray(cols.arrival_time, np.float64),
        "inp": np.asarray(cols.true_input_tokens, np.int32),
        "outp": np.asarray(cols.true_output_tokens, np.int32),
        "budget": np.zeros(n, np.int32) if budgets is None else budgets,
    }
    lane = {
        "th": np.asarray([th0], np.int32).reshape(1, P - 1),
        "ninst": np.asarray(
            [[fleet.pools[name].num_instances for name in ordered]], np.int32
        ),
        "ctrl": _ctrl_params(fleet.controller, enabled=True),
    }
    loop = _FleetLoop(spec, trace_arrays, lane, fleet.device, grid=False,
                      telemetry=fleet.telemetry is not None)
    loop.run()
    dev_out = loop.fold_records()
    win = dev_out.pop("win")
    _LAST_RUN.clear()
    _LAST_RUN.update(
        mode="fleet",
        n=n,
        iters=int(loop.iters[0]),
        rounds=int(loop.rounds[0]),
        host_syncs=loop.host_syncs,
        device=str(fleet.device),
    )
    out = {k: (v[0].cpu().numpy() if torch.is_tensor(v) else v[0]) for k, v in dev_out.items()}

    ids = np.asarray(cols.request_id, np.int64)
    arr = np.asarray(cols.arrival_time, np.float64)
    fleet_cols = {
        "request_id": ids,
        "arrival": arr,
        "first_token": out["recf"][:, 0],
        "finish": out["recf"][:, 1],
        "output_tokens": out["reci"][:, 0].astype(np.int64),
        "preemptions": out["reci"][:, 1].astype(np.int64),
        "truncated": out["reci"][:, 2].astype(bool),
        "rejected": out["rej"],
    }
    routed = np.bincount(out["pool"], minlength=P)
    per_pool_cols = {}
    for idx, name in enumerate(ordered):
        m = out["pool"] == idx
        pc = {k: v[m] for k, v in fleet_cols.items()}
        per_pool_cols[name] = pc
        shell = shells[idx]
        shell._records.add_bulk(*(pc[k] for k, _ in shell._records.COLUMNS))
        shell.preemption_count = int(out["preempt"][idx])
        shell.rejection_count = int(out["reject"][idx])
        shell.truncation_count = int(out["truncate"][idx])
        if router is not None:
            router.routed[name] += int(routed[idx])

    final_th = [int(b) for b in out["th"][: P - 1]]
    if router is not None and fleet.controller is not None:
        router.pools.set_thresholds(final_th)
        _synthesize_history(fleet.controller, loop.history(0), th0)

    if fleet.telemetry is not None:
        _replay_telemetry(
            fleet, shells, spec, out, {k: v[0] for k, v in win.items()}, n,
            float(np.max(out["recf"][:, 1])), final_th,
        )

    return FleetResult(
        summary=summarize_columns("fleet", fleet_cols),
        per_pool={
            name: summarize_columns(name, c)
            for name, c in per_pool_cols.items()
        },
        router_stats=router.stats() if router else {},
        preemptions=int(out["preempt"].sum()),
        rejections=int(out["reject"].sum()),
        truncations=int(out["truncate"].sum()),
        telemetry=fleet.telemetry,
        slo=fleet.slo,
    )


def _synthesize_history(controller, history: list, th0: list) -> None:
    """Rebuild a BoundaryMove trajectory from the window threshold
    snapshots: diffing consecutive snapshots recovers when each boundary
    moved and to what value (reason ``"device"``, as the reference)."""
    prev = list(th0)
    for t_req, th in history:
        cur = [int(b) for b in th[: len(prev)]]
        for k, (a, b) in enumerate(zip(prev, cur)):
            if a != b:
                controller.history.append(
                    BoundaryMove(t=int(t_req), boundary=k, value=b, reason="device")
                )
        prev = cur


def _replay_telemetry(fleet, shells, spec, out, win, n, t_end, final_th) -> None:
    """Replay the device window snapshots into the host FleetTelemetry; the
    counterpart of the reference function of the same name.

    Same windows, same sampling order as the host backends: the
    controller's thresholds first, then the sample; then the final flush
    at ``t_end`` from the drained end state. Counter columns come from the
    device's cumulative per-pool counters, gauges (queue depth, active,
    kv_frac) from the snapshot state. The calibration-error series uses the
    final EMA state for every window, because the device run does not carry
    the float EMA: the reference's own documented approximation."""
    telemetry = fleet.telemetry
    router = fleet.router
    controlled = router is not None and fleet.controller is not None
    prev_req = 0
    for shell in shells:
        shell.blocks_free = np.zeros(shell.num_instances, dtype=np.int64)
    for w in range(int(out["nwin"])):
        for idx, shell in enumerate(shells):
            shell.preemption_count = int(win["pre"][w, idx])
            shell.rejection_count = int(win["rej"][w, idx])
            shell.truncation_count = int(win["trunc"][w, idx])
            shell.state.queue_depth = int(win["queue"][w, idx])
            shell.state.active = int(win["active"][w, idx])
            shell.blocks_free[:] = 0
            shell.blocks_free[0] = int(win["freeb"][w, idx])
        if controlled:
            router.pools.set_thresholds(
                [int(b) for b in win["th"][w][: len(router.pools) - 1]]
            )
        t_req = int(win["t_req"][w])
        telemetry.sample(t_req=t_req, now=float(win["now"][w]), lo=prev_req, hi=t_req)
        prev_req = t_req
    # final flush (the host tiers' _finish_windows): the drained end state
    for idx, shell in enumerate(shells):
        shell.preemption_count = int(out["preempt"][idx])
        shell.rejection_count = int(out["reject"][idx])
        shell.truncation_count = int(out["truncate"][idx])
        shell.state.queue_depth = 0
        shell.state.active = 0
        shell.blocks_free[:] = spec.pools[idx].total_blocks
    if controlled:
        router.pools.set_thresholds(final_th)
    telemetry.sample(t_req=n, now=t_end, lo=prev_req, hi=n)


# ---------------------------------------------------------------------------
# Batched sensitivity grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetGridResult:
    """Columnar results of one fleet sweep (G grid lanes); the counterpart
    of the reference's class of the same name.

    Per-lane reductions are computed on the device over the *full* run (no
    warm-up discard — grid metrics are for relative comparisons across
    lanes; use a single-lane ``FleetSim`` run for paper-grade numbers).
    Percentiles are linear-interpolation (``torch.nanquantile``, as
    ``jnp.nanpercentile``), not the nearest-rank convention of
    :func:`repro_torch.sim.metrics.summarize`.
    """

    pool_names: tuple[str, ...]
    thresholds: np.ndarray  # (G, P-1) initial boundary vectors
    instances: np.ndarray  # (G, P) instance counts
    completed: np.ndarray  # (G,)
    rejected: np.ndarray  # (G,)
    truncated: np.ndarray  # (G,)
    preemptions: np.ndarray  # (G,) fleet total
    routed: np.ndarray  # (G, P) dispatches per pool
    ttft_mean: np.ndarray
    ttft_p50: np.ndarray
    ttft_p99: np.ndarray
    tpot_mean: np.ndarray
    tpot_p99: np.ndarray
    makespan: np.ndarray  # (G,) max finish − min arrival
    final_thresholds: np.ndarray  # (G, P-1) post-controller vectors
    controller_moves: np.ndarray  # (G,)
    #: (G, n) per-request record arrays when ``return_records=True``.
    records: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.completed)

    def goodput(self) -> np.ndarray:
        """Completed non-truncated requests per second, per lane."""
        span = np.maximum(self.makespan, 1e-12)
        return (self.completed - self.truncated) / span


def _broadcast_axis(values, g: int, name: str):
    if len(values) == 1:
        return [values[0]] * g
    if len(values) != g:
        raise ValueError(
            f"grid axis {name!r} has length {len(values)}, expected 1 or {g}"
        )
    return list(values)


def _pool_spec(name: str, cfg: PoolConfig, max_inst: int) -> _PoolSpec:
    total = min(TOTAL_KV_BLOCKS, cfg.n_seq * _blocks_for(cfg.c_max))
    return _PoolSpec(
        name=name,
        c_max=int(cfg.c_max),
        n_seq=int(cfg.n_seq),
        total_blocks=int(total),
        max_inst=int(max_inst),
    )


def _grid_metrics(out: dict, arr: torch.Tensor, P: int) -> dict:
    """Per-lane reductions on the device, as the reference computes them
    after its loop: counts, routing split, TTFT / TPOT means and linear
    percentiles, the end time and the makespan."""
    first, finish = out["recf"][..., 0], out["recf"][..., 1]
    out_tok = out["reci"][..., 0]
    compm = ~out["rej"]
    ttft = torch.where(compm, first - arr, math.nan)
    tpot = torch.where(
        compm & (out_tok > 1),
        (finish - first) / torch.clamp(out_tok - 1, min=1),
        math.nan,
    )
    t_end = finish.amax(dim=1)
    m = {
        "completed": compm.sum(dim=1),
        "rejected": out["rej"].sum(dim=1),
        "truncated": out["reci"][..., 2].sum(dim=1),
        "routed": torch.stack([(out["pool"] == p).sum(dim=1) for p in range(P)], dim=1),
        "ttft_mean": ttft.nanmean(dim=1),
        "ttft_p50": torch.nanquantile(ttft, 0.5, dim=1),
        "ttft_p99": torch.nanquantile(ttft, 0.99, dim=1),
        "tpot_mean": tpot.nanmean(dim=1),
        "tpot_p99": torch.nanquantile(tpot, 0.99, dim=1),
        "t_end": t_end,
        "makespan": t_end - arr.min(),
    }
    return {k: v.cpu().numpy() for k, v in m.items()}


def run_fleet_grid(
    trace,
    pools: dict[str, tuple[PoolConfig, int]],
    timing: TimingModel,
    *,
    thresholds: Optional[Sequence[Sequence[int]]] = None,
    instances: Optional[Sequence[Sequence[int]]] = None,
    gains: Optional[Sequence[Optional[dict]]] = None,
    b_short: int = 8192,
    calibrator: Optional[EmaCalibrator] = None,
    epoch: int = 2048,
    control_window: int = 512,
    return_records: bool = False,
    device: str | torch.device = "cuda",
) -> FleetGridResult:
    """Run a whole sensitivity sweep as one batched run on ``device``: the
    lanes ride a leading axis of every tensor of the loop, and each round
    is one ``sim_decode`` launch for all of them.

    Grid axes (all optional, zip semantics — length G or 1, broadcast):

    ``thresholds``
        Sequence of boundary vectors (each length P−1, pool-budget order).
    ``instances``
        Sequence of per-pool instance-count vectors (length P). Lanes run
        padded to the max count with dead-lane masking, so mixed fleet
        sizes share one run.
    ``gains``
        Sequence of AIMD controller parameter dicts (keys ``b_min``,
        ``increase_step``, ``decrease_factor``, ``error_rate_hi``,
        ``overload_ratio_hi`` — defaults from
        :mod:`repro_torch.core.adaptive`), or ``None`` entries for
        uncontrolled lanes.

    Budgets are precomputed once on the host — the EMA feedback trajectory
    depends only on the observation stream, not on routing — so every lane
    shares the same budget array. Each lane's records are bit-identical to
    the reference's ``run_fleet_grid`` lane, and its loop counts equal the
    reference's (:func:`last_run_stats`). ``device`` is ``"cuda"`` unless
    the caller asks for the CPU; without a GPU the default raises.
    """
    dev = resolve_device(device)
    cols = _as_columns(trace)
    n = len(cols)
    if n == 0:
        raise ValueError("run_fleet_grid needs a non-empty trace")

    # Budget-ordered pool frame, like FleetSim.
    ordered = sorted(pools.items(), key=lambda kv: kv[1][0].c_max)
    names = tuple(name for name, _ in ordered)
    base_inst = [int(ni) for _, (_, ni) in ordered]
    configs = [cfg for _, (cfg, _) in ordered]
    P = len(ordered)

    if thresholds is None:
        if set(names) == {"short", "long"}:
            base_th = [min(b_short, configs[0].c_max)]
        else:
            base_th = [c.c_max for c in configs[:-1]]
        thresholds = [base_th]
    if instances is None:
        instances = [base_inst]
    if gains is None:
        gains = [None]

    g = max(len(thresholds), len(instances), len(gains))
    thresholds = _broadcast_axis(list(thresholds), g, "thresholds")
    instances = _broadcast_axis(list(instances), g, "instances")
    gains = _broadcast_axis(list(gains), g, "gains")

    th_arr = np.asarray(thresholds, np.int32).reshape(g, P - 1)
    inst_arr = np.asarray(instances, np.int32).reshape(g, P)
    any_ctrl = any(gn is not None for gn in gains)
    ctrl_rows = [
        {
            "enabled": np.int32(0 if gn is None else 1),
            "b_min": np.int32((gn or {}).get("b_min", 512)),
            "step": np.int32((gn or {}).get("increase_step", DEFAULT_INCREASE_STEP)),
            "factor": np.float32((gn or {}).get("decrease_factor", DEFAULT_DECREASE_FACTOR)),
            "err_hi": np.float32((gn or {}).get("error_rate_hi", DEFAULT_ERROR_RATE_HI)),
            "over_hi": np.float32(
                (gn or {}).get("overload_ratio_hi", DEFAULT_OVERLOAD_RATIO_HI)
            ),
        }
        for gn in gains
    ]
    ctrl = {k: np.stack([r[k] for r in ctrl_rows]) for k in ctrl_rows[0]}

    spec = _SimSpec(
        pools=tuple(
            _pool_spec(name, cfg, int(inst_arr[:, j].max()))
            for j, (name, cfg) in enumerate(zip(names, configs))
        ),
        w=float(timing.w_base),
        h=float(timing.h_per_seq),
        prefill_chunk=int(timing.prefill_chunk),
        win_size=int(control_window) if any_ctrl else 0,
    )

    budgets = None
    if P > 1:
        cal = calibrator or EmaCalibrator()
        epoch_cap = max(1, min(epoch, control_window)) if any_ctrl else epoch
        budgets, _ = precompute_budget_trajectory(cols, cal, epoch_cap=epoch_cap)

    trace_arrays = {
        "arr": np.asarray(cols.arrival_time, np.float64),
        "inp": np.asarray(cols.true_input_tokens, np.int32),
        "outp": np.asarray(cols.true_output_tokens, np.int32),
        "budget": np.zeros(n, np.int32) if budgets is None else budgets,
    }
    lanes = {"th": th_arr, "ninst": inst_arr, "ctrl": ctrl}
    loop = _FleetLoop(spec, trace_arrays, lanes, dev, grid=True)
    loop.run()
    out = loop.fold_records()
    _LAST_RUN.clear()
    _LAST_RUN.update(
        mode="grid",
        n=n,
        g=g,
        iters=int(loop.iters.max()),
        rounds=int(loop.rounds.max()),
        iters_total=int(loop.iters.sum()),
        rounds_total=int(loop.rounds.sum()),
        host_syncs=loop.host_syncs,
        device=str(dev),
    )

    m = _grid_metrics(out, loop.arr, P)
    records = None
    if return_records:
        rf = out["recf"].cpu().numpy()
        ri = out["reci"].cpu().numpy()
        records = {
            "first": rf[..., 0],
            "finish": rf[..., 1],
            "out": ri[..., 0],
            "pre": ri[..., 1],
            "trunc": ri[..., 2].astype(bool),
            "pool": out["pool"].cpu().numpy(),
            "rejt": out["rejt"].cpu().numpy(),
            "rej": out["rej"].cpu().numpy(),
        }
    return FleetGridResult(
        pool_names=names,
        thresholds=th_arr,
        instances=inst_arr,
        completed=m["completed"].astype(np.int64),
        rejected=m["rejected"].astype(np.int64),
        truncated=m["truncated"].astype(np.int64),
        preemptions=out["preempt"].sum(axis=1).astype(np.int64),
        routed=m["routed"].astype(np.int64),
        ttft_mean=m["ttft_mean"],
        ttft_p50=m["ttft_p50"],
        ttft_p99=m["ttft_p99"],
        tpot_mean=m["tpot_mean"],
        tpot_p99=m["tpot_p99"],
        makespan=m["makespan"],
        final_thresholds=out["th"].reshape(g, P - 1),
        controller_moves=out["moves"].astype(np.int64),
        records=records,
    )
