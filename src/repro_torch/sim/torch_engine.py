"""Device fleet backend (``backend="torch"``): the port of the reference's
compiled tier, ``repro.sim.jax_engine``.

The reference compiles the whole event loop into one ``lax.while_loop``.
This module keeps that loop's semantics and structure and runs it as eager
PyTorch on one device:

* stacked ``(P, I, S)`` slot tensors for every pool at once (pools padded to
  the widest instance and slot counts; padding is inert: padded slots are
  never occupied, padded instances never wake), with per-pool ``c_max``,
  ``n_seq`` and block budgets as ``(P,)`` tensors;
* the outer epoch loop (one iteration per arrival burst, ``iters <= n+1``),
  the arrival drain (dispatch while the next arrival is no later than every
  instance wake) and the round sweep (rounds back-to-back until the next
  arrival);
* ``pool_round``: head-of-line FIFO admission with KV-block reservation as
  a fixpoint (one admission wave per iteration) that drains a per-instance
  victim stash before the FIFO; the fused decode-advance round
  (:func:`repro_torch.kernels.sim_decode.decode_advance`, the ``sim_decode``
  CUDA kernel on the GPU); the completion scatter into packed record
  tensors written in place; and the order-free batch preemption rule as a
  sort-free pass over the ``(S, S)`` slot square (pairwise ranks and masked
  prefix sums), gated so the pass runs only when some instance is over its
  block budget;
* request-indexed FIFO linked lists (``qnext`` plus per-instance head and
  tail);
* the in-loop AIMD controller, mirrored in float32 with the constants and
  feasibility projection of :class:`repro_torch.core.adaptive
  .AdaptiveController`, on the same dispatched-request windows;
* per-request budgets precomputed on the host
  (:func:`precompute_budget_trajectory`, a sequential float32 EMA fold in
  arrival order on CPU tensors, as the reference folds on its host), so the
  loop itself only does a ``searchsorted`` per dispatch.

Numerics follow the reference's compiled tier exactly: event times
(``now``, ``ft``, ``end``, wakes, records) are float64 and counters int32,
every tensor has an explicit dtype and device, and the products that XLA
contracts into fused multiply-adds are fused here too (see
:mod:`repro_torch.core.fma`). So the records are bit-identical to the
reference's ``jax`` tier in every class, and to the host tiers in the exact
classes (routerless single pool, ``coalesce_dt=0``, dyadic timing).

Loop control: the while conditions (next arrival against the earliest
wake, the admission fixpoint, the eviction gate) read a device scalar on
the host, one sync each; :func:`last_run_stats` counts them as
``host_syncs``. The per-request records, the slot state and ``t_limit``
stay on the device.

Left out, against the reference: the vmapped ``run_fleet_grid``, the AOT
executable cache and its probes (XLA-specific), and the in-loop telemetry
window snapshots and their replay (``FleetSim`` raises for telemetry,
event tracing and fault injection on this backend).
"""

from __future__ import annotations

import dataclasses
import math

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
from repro_torch.core.router import pool_ids
from repro_torch.kernels.sim_decode import (
    _BIG_I,
    blocks_for,
    decode_advance,
)
from repro_torch.traces.generator import TraceColumns

I32 = torch.int32
F32 = torch.float32
F64 = torch.float64

#: Per-request record tensors (name, dtype, width), each ``(n, …)`` and
#: indexed by request id. ``recf`` packs [first_token, finish]; ``reci``
#: packs [out_tokens, preemptions, truncated(0/1)]; ``rejt`` stages the
#: admission-reject time (+inf = not rejected).
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
    (outer epochs, at most ``n + 1``), ``rounds`` (sweep rounds),
    ``host_syncs`` (device scalars read by the loop's conditions), ``n``,
    ``mode`` (``"fleet"``) and ``device``."""
    return dict(_LAST_RUN)


def _fresh_records(n: int, device: torch.device) -> dict:
    """Record tensors for one run; ``rejt`` is +inf-filled."""
    rec = {}
    for name, dt, w in _REC_DTYPES:
        shape = (n,) if w == 1 else (n, w)
        fill = math.inf if name == "rejt" else 0
        rec[name] = torch.full(shape, fill, dtype=dt, device=device)
    return rec


def _init_pools(spec: _SimSpec, n: int, device: torch.device) -> dict:
    """Stacked ``(P, I, S)`` pool state (padded to the widest pool)."""
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
        return torch.full(shape, value, dtype=dtype, device=device)

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
        "free": torch.where(ivalid, tblocks[:, None], 0).to(I32),
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
    """One single-lane fleet run: the reference's ``core`` as an object.

    ``a`` (next arrival), ``iters``, ``rounds`` and the monitoring-window
    counters are host integers: they evolve by counting alone, so they
    need no device reads. Everything else lives on ``device``.
    """

    def __init__(self, spec: _SimSpec, trace: dict, lane: dict, device: torch.device):
        dev = self.dev = device
        self.spec = spec
        P = self.P = len(spec.pools)
        I = self.I = max(ps.max_inst for ps in spec.pools)
        S = self.S = max(ps.n_seq for ps in spec.pools)
        n = self.n = len(trace["arr"])
        self.win = spec.win_size
        self.cmax_v = torch.tensor([ps.c_max for ps in spec.pools], dtype=I32, device=dev)
        self.nseq_v = torch.tensor([ps.n_seq for ps in spec.pools], dtype=I32, device=dev)
        self.tblk_v = torch.tensor([ps.total_blocks for ps in spec.pools], dtype=I32, device=dev)
        self.pg = torch.arange(P, device=dev)
        self.ar_s = torch.arange(S, device=dev)
        self.eye = torch.eye(S, dtype=torch.bool, device=dev)
        # trace columns (arrival order); arr_p[n] = +inf is next_arr_at(n)
        self.arr_host = np.asarray(trace["arr"], np.float64)
        self.arr = torch.as_tensor(self.arr_host, dtype=F64).to(dev)
        self.arr_p = torch.cat([self.arr, torch.full((1,), math.inf, dtype=F64, device=dev)])
        self.inp = torch.as_tensor(trace["inp"], dtype=I32).to(dev)
        self.outp = torch.as_tensor(trace["outp"], dtype=I32).to(dev)
        self.bud = torch.as_tensor(trace["budget"], dtype=I32).to(dev)
        # lane parameters
        self.th = torch.as_tensor(lane["th"], dtype=I32).to(dev)
        ninst = torch.as_tensor(lane["ninst"], dtype=I32).to(dev)
        self.ninst = ninst
        self.alive = torch.arange(I, device=dev)[None, :] < ninst[:, None]
        ctrl = lane["ctrl"]
        self.ctrl_enabled = int(ctrl["enabled"]) > 0
        self.b_min = torch.tensor(int(ctrl["b_min"]), dtype=I32, device=dev)
        self.step = torch.tensor(int(ctrl["step"]), dtype=I32, device=dev)
        self.factor = torch.tensor(float(ctrl["factor"]), dtype=F32, device=dev)
        self.err_hi = torch.tensor(float(ctrl["err_hi"]), dtype=F32, device=dev)
        self.over_hi = torch.tensor(float(ctrl["over_hi"]), dtype=F32, device=dev)
        # carried state
        self.st = _init_pools(spec, n, dev)
        self.rec = _fresh_records(n, dev)
        self.a = 0
        self.iters = 0
        self.rounds = 0
        self.host_syncs = 0
        self.win_seen = 0
        self.win_prev = 0
        self.prev_err = torch.zeros((P,), dtype=I32, device=dev)
        self.moves = torch.zeros((), dtype=I32, device=dev)
        self.win_t_req: list[int] = []
        self.win_th: list[torch.Tensor] = []
        self._wake_min = math.inf  # last value read from the device
        self._wake_fresh = True  # no wake has changed since that read

    # -- host reads ----------------------------------------------------------
    def _read(self, t: torch.Tensor):
        self.host_syncs += 1
        return t.item()

    def _read_all(self, *ts: torch.Tensor) -> list[int]:
        """Several device scalars (flags and counts) in one host read."""
        self.host_syncs += 1
        return torch.stack([t.to(torch.int64) for t in ts]).tolist()

    @staticmethod
    def _rows(mask: torch.Tensor, count: int) -> torch.Tensor:
        """Flat indices of the ``count`` true entries of ``mask``; the count
        was read on the host already, so this needs no device sync."""
        return torch.nonzero_static(mask.flatten(), size=count)[:, 0]

    def wake_min(self) -> float:
        if not self._wake_fresh:
            self._wake_min = self._read(self.st["wake"].min())
            self._wake_fresh = True
        return self._wake_min

    def next_arr_at(self, a: int) -> float:
        return float(self.arr_host[a]) if a < self.n else math.inf

    # -- monitoring window + in-loop AIMD controller ---------------------------
    def window_step(self) -> None:
        """One window boundary (only called when it fires): the AIMD rule of
        ``AdaptiveController`` per boundary in float32, the feasibility
        projection, then the threshold snapshot for the controller history."""
        st = self.st
        P = self.P
        cur = st["npre"] + st["nrej"] + st["ntr"]
        delta = cur - self.prev_err
        wr = self.win_seen - self.win_prev
        queues = st["qlen"].sum(dim=1, dtype=I32)
        pressure = queues.to(F32) / torch.clamp(self.ninst, min=1).to(F32)
        old = self.th
        wrf = torch.tensor(float(max(wr, 1)), dtype=F32, device=self.dev)
        props = []
        for k in range(P - 1):
            err_rate = delta[k].to(F32) / wrf
            p_lo, p_hi = pressure[k], pressure[k + 1]
            dec = (err_rate > self.err_hi) | (
                (p_lo > self.over_hi * torch.clamp(p_hi, min=0.25)) & (p_lo > 1.0)
            )
            inc = (~dec) & (p_hi < 0.25) & (p_lo < 1.0)
            down = (old[k].to(F32) * self.factor).to(I32)
            props.append(torch.where(dec, down, torch.where(inc, old[k] + self.step, old[k])))
        # feasibility projection: forward pass with a running lower bound;
        # the degenerate case keeps the old vector
        lo = self.b_min
        feasible = torch.ones((), dtype=torch.bool, device=self.dev)
        newv = []
        for k in range(P - 1):
            cap = self.spec.pools[k].c_max
            feasible = feasible & (lo <= cap)
            nk = torch.clamp(torch.maximum(props[k], lo), max=cap)
            newv.append(nk)
            lo = nk + 1
        newv = torch.where(feasible, torch.stack(newv), old).to(I32)
        if self.ctrl_enabled and wr > 0:
            self.moves = self.moves + (newv != old).any().to(I32)
            self.th = newv
        self.win_t_req.append(self.win_seen)
        self.win_th.append(self.th)
        self.prev_err = cur
        self.win_prev = self.win_seen

    # -- arrival drain -----------------------------------------------------------
    def dispatch(self) -> None:
        """Route arrival ``a`` (threshold search on its precomputed budget),
        pick the least-loaded live instance of every pool, and enqueue it on
        the chosen pool's instance (submit-time rejects only count)."""
        st = self.st
        a, n, pg = self.a, self.n, self.pg
        t = self.arr[a]
        if self.P > 1:
            pidx = pool_ids(self.th, self.bud[a])
        else:
            pidx = torch.zeros((), dtype=I32, device=self.dev)
        self.rec["pool"][a] = pidx
        sel = pidx == pg
        i = torch.argmin(torch.where(self.alive, st["load"], _BIG_I), dim=1)
        rej = self.inp[a] >= self.cmax_v
        ok = sel & ~rej
        qh_i = st["qh"][pg, i]
        qt_i = st["qt"][pg, i]
        wake_i = st["wake"][pg, i]
        was_empty = qh_i < 0
        st["qnext"][pg, torch.where(ok, a, n)] = -1
        st["qnext"][pg, torch.where(ok & ~was_empty, qt_i, n).long()] = a
        st["qh"][pg, i] = torch.where(ok & was_empty, a, qh_i).to(I32)
        st["qt"][pg, i] = torch.where(ok, a, qt_i).to(I32)
        st["qlen"][pg, i] += ok.to(I32)
        st["load"][pg, i] += ok.to(I32)
        st["wake"][pg, i] = torch.where(ok & torch.isinf(wake_i), t, wake_i)
        st["nrej"] += (sel & rej).to(I32)
        self._wake_fresh = False
        self.a += 1
        self.win_seen += 1
        if self.win > 0 and self.win_seen - self.win_prev >= self.win:
            self.window_step()

    def drain(self) -> None:
        # Arrival-first tie-break: dispatch while t_arr <= every wake.
        while self.a < self.n and self.next_arr_at(self.a) <= self.wake_min():
            self.dispatch()

    # -- one masked round over the stacked pools ---------------------------------
    def admit(self, due: torch.Tensor) -> None:
        """Admission fixpoint: one wave admits or rejects at most one head
        (victim stash first, then the FIFO) per due instance, until no
        instance can make progress. Each instance fills at most one slot
        per wave, written in place through its slot index."""
        st, rec, n = self.st, self.rec, self.n
        while True:
            stash = st["vcnt"] > 0
            hrid = torch.where(stash, st["vrid"][:, :, 0], st["qh"])
            has = due & (stash | (st["qh"] >= 0))
            hc = torch.clamp(hrid, 0, n - 1).long()
            hinp = torch.where(stash, st["vinp"][:, :, 0], self.inp[hc])
            hpc = torch.where(stash, st["vpc"][:, :, 0], 0)
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
                        pop_st[:, :, None], torch.roll(st[key], -1, dims=2), st[key]
                    )
            pop_f = prog & ~stash
            nxt = torch.gather(st["qnext"], 1, torch.clamp(st["qh"], 0, n).long())
            st["qt"] = torch.where(pop_f & (nxt < 0), -1, st["qt"]).to(I32)
            st["qh"] = torch.where(pop_f, nxt, st["qh"])
            if n_rej:
                # stage the reject time (the host's first = finish = now)
                rows = self._rows(rejm, n_rej)
                rec["rejt"].index_copy_(
                    0, hc.flatten()[rows], st["wake"].flatten()[rows]
                )
            base = st["sqc"]
            admi = admm.to(I32)
            if n_adm:
                # admit into the first free slot of each admitting instance
                rows = self._rows(admm, n_adm)
                slot = torch.argmin(st["occ"].to(I32), dim=2).flatten()[rows]
                flat = rows * self.S + slot
                rank = torch.cumsum(admi, dim=1, dtype=I32) - admi
                out_h = self.outp[hc]
                for key, val in (
                    ("rid", hrid), ("enq", self.arr[hc]), ("inp", hinp),
                    ("outp", out_h), ("pre", hinp), ("rem", out_h),
                    ("blk", need), ("pc", hpc), ("sq", base[:, None] + rank),
                ):
                    st[key].view(-1).index_copy_(0, flat, val.flatten()[rows])
                for key, val in (
                    ("occ", True), ("gen", 0), ("ft", math.nan), ("tr", False)
                ):
                    st[key].view(-1).index_fill_(0, flat, val)
            st["vcnt"] = st["vcnt"] - pop_st.to(I32)
            st["qlen"] = st["qlen"] - prog.to(I32)
            st["load"] = st["load"] - rejm.to(I32)
            st["nrej"] = st["nrej"] + rejm.sum(dim=1, dtype=I32)
            st["sqc"] = base + admm.sum(dim=1, dtype=I32)
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
        k_a, k_b = keyq[:, :, :, None], keyq[:, :, None, :]
        sq_lt = sq[:, :, None, :] < sq[:, :, :, None]  # [a, b]: b before a
        prec = (k_b < k_a) | ((k_b == k_a) & sq_lt)
        rank = prec.sum(dim=3, dtype=I32)
        le = prec | self.eye
        blkv = torch.where(surv, blk0, 0)
        cum_blk = torch.where(le, blkv[:, :, None, :], 0).sum(dim=3, dtype=I32)
        cum_grow = torch.where(le, grow[:, :, None, :], 0).sum(dim=3, dtype=I32)
        okj = demand[:, :, None] - cum_grow <= free1[:, :, None] + cum_blk
        first_ok = torch.where(okj, rank, S).amin(dim=2)
        jsel = torch.where(
            demand <= free1, 0, torch.where(first_ok < S, first_ok + 1, 1)
        )
        ev = (rank < jsel[:, :, None]) & surv
        nev = ev.sum(dim=2, dtype=I32)
        vrank = (ev[:, :, None, :] & sq_lt).sum(dim=3, dtype=I32)
        rr = self.ar_s
        in_new = rr[None, None, :] < nev[:, :, None]
        # vm[j, a]: stash slot j takes the victim in slot a (victim rank j);
        # om[j, a]: stash slot j takes previous-stash slot a = j - n_victims
        vm = (
            ev[:, :, None, :]
            & (vrank[:, :, None, :] == rr[None, None, :, None])
            & in_new[:, :, :, None]
        )
        om = (
            rr[None, None, None, :] == rr[None, None, :, None] - nev[:, :, None, None]
        ) & ~in_new[:, :, :, None]

        def stash(old3, vals):
            return torch.where(vm, vals[:, :, None, :], 0).sum(
                dim=3, dtype=I32
            ) + torch.where(om, old3[:, :, None, :], 0).sum(dim=3, dtype=I32)

        vr = stash(st["vrid"], st["rid"])
        vi = stash(st["vinp"], inp2 + gen_a)
        vp = stash(st["vpc"], st["pc"] + 1)
        return ev, nev, vr, vi, vp

    def pool_round(self, t_limit: torch.Tensor) -> None:
        st, rec, n = self.st, self.rec, self.n
        P, I, S = self.P, self.I, self.S
        due = st["wake"] < t_limit
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
        bb = busy[:, :, None]
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
        ntr = st["ntr"] + adv["trunc_new"].sum(dim=(1, 2), dtype=I32)

        ncomp = comp.sum(dim=2, dtype=I32)
        free1 = st["free"] + torch.where(comp, blk0, 0).sum(dim=2, dtype=I32)
        surv = dec & (rem_a > 0) & bb
        need_s = torch.where(surv, blocks_for(inp2 + gen_a), blk0)
        grow = torch.where(surv, need_s - blk0, 0)
        demand = grow.sum(dim=2, dtype=I32)
        over, n_comp = self._read_all((demand > free1).any(), ncomp.sum())

        # completion scatter into the record tensors, in place (request ids
        # are unique, so every row is written at most once)
        if n_comp:
            rows = self._rows(comp, n_comp)
            ids = st["rid"].flatten()[rows].long()
            rec["recf"].index_copy_(0, ids, torch.stack(
                [ft_a.flatten()[rows], end.flatten()[rows // S]], dim=-1
            ))
            rec["reci"].index_copy_(0, ids, torch.stack(
                [gen_a.flatten()[rows], st["pc"].flatten()[rows],
                 tr_a.flatten()[rows].to(I32)], dim=-1
            ))

        if over:
            evict, nevict, vrid, vinp, vpc = self.evict_pass(
                surv, grow, demand, free1, blk0, inp2, gen_a
            )
        else:
            # demand <= free everywhere: nothing evicts, the stash stays
            evict = torch.zeros((P, I, S), dtype=torch.bool, device=self.dev)
            nevict = torch.zeros((P, I), dtype=I32, device=self.dev)
            vrid, vinp, vpc = st["vrid"], st["vinp"], st["vpc"]
        npre = st["npre"] + evict.sum(dim=(1, 2), dtype=I32)
        free1 = free1 + torch.where(evict, blk0, 0).sum(dim=2, dtype=I32)
        keep = surv & ~evict
        free1 = free1 - torch.where(keep, grow, 0).sum(dim=2, dtype=I32)
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
    def run(self) -> dict:
        n = self.n
        while self.a < n or math.isfinite(self.wake_min()):
            self.drain()
            # Coalesced sweep: rounds back-to-back until the next arrival.
            t_lim = self.next_arr_at(self.a)
            t_limit = self.arr_p[self.a]  # the same value, on the device
            while self.wake_min() < t_lim:
                self.pool_round(t_limit)
                self.rounds += 1
            self.iters += 1
        return self.fold_records()

    def fold_records(self) -> dict:
        """Post-loop: admission rejects (finite staged time) and submit
        rejects (prompt >= the recorded pool's C_max) get first = finish =
        the reject time. Returns host arrays of the n request rows."""
        rec, n = self.rec, self.n
        rejt = rec["rejt"][:n]
        pool = rec["pool"][:n]
        arej = torch.isfinite(rejt)
        rejm = arej | (self.inp >= self.cmax_v[pool.long()])
        recf = torch.where(
            rejm[:, None], torch.where(arej, rejt, self.arr)[:, None], rec["recf"][:n]
        )
        host = {
            "recf": recf.cpu().numpy(),
            "reci": rec["reci"][:n].cpu().numpy(),
            "pool": pool.cpu().numpy(),
            "rejt": rejt.cpu().numpy(),
            "rej": rejm.cpu().numpy(),
            "preempt": self.st["npre"].cpu().numpy(),
            "reject": self.st["nrej"].cpu().numpy(),
            "truncate": self.st["ntr"].cpu().numpy(),
            "th": self.th.cpu().numpy(),
            "moves": int(self.moves),
            "win_t_req": list(self.win_t_req),
            "win_th": [t.cpu().numpy() for t in self.win_th],
        }
        return host


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
    ``fleet.pools[name].record_arrays()`` and ``router.stats()`` behave
    like a host run.
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
            telemetry=None, slo=fleet.slo,
        )

    trace_arrays = {
        "arr": np.asarray(cols.arrival_time, np.float64),
        "inp": np.asarray(cols.true_input_tokens, np.int32),
        "outp": np.asarray(cols.true_output_tokens, np.int32),
        "budget": np.zeros(n, np.int32) if budgets is None else budgets,
    }
    lane = {
        "th": np.asarray(th0, np.int32),
        "ninst": np.asarray(
            [fleet.pools[name].num_instances for name in ordered], np.int32
        ),
        "ctrl": _ctrl_params(fleet.controller, enabled=True),
    }
    loop = _FleetLoop(spec, trace_arrays, lane, fleet.device)
    out = loop.run()
    _LAST_RUN.clear()
    _LAST_RUN.update(
        mode="fleet",
        n=n,
        iters=loop.iters,
        rounds=loop.rounds,
        host_syncs=loop.host_syncs,
        device=str(fleet.device),
    )

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

    if router is not None and fleet.controller is not None:
        router.pools.set_thresholds([int(b) for b in out["th"][: P - 1]])
        _synthesize_history(fleet.controller, out, th0)

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
        telemetry=None,
        slo=fleet.slo,
    )


def _synthesize_history(controller, out: dict, th0: list) -> None:
    """Rebuild a BoundaryMove trajectory from the window threshold
    snapshots: diffing consecutive snapshots recovers when each boundary
    moved and to what value (reason ``"device"``, as the reference)."""
    prev = list(th0)
    for t_req, th in zip(out["win_t_req"], out["win_th"]):
        cur = [int(b) for b in th[: len(prev)]]
        for k, (a, b) in enumerate(zip(prev, cur)):
            if a != b:
                controller.history.append(
                    BoundaryMove(t=int(t_req), boundary=k, value=b, reason="device")
                )
        prev = cur
