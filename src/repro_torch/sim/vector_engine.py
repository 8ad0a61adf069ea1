"""Struct-of-arrays vectorized pool simulator (``backend="vectorized"``).

The scalar reference engine (:mod:`repro_torch.sim.engine`) models one sequence as
one Python object and one instance-iteration as one method call — perfect for
unit tests, painfully slow for million-request fleet sweeps. This module
re-expresses the *same* iteration semantics as dense NumPy arrays:

* per-slot state lives in ``(num_instances, n_seq)`` arrays
  (``prefill_remaining``, ``decode_remaining``, ``generated``, ``blocks``,
  …) and per-instance state in ``(num_instances,)`` arrays
  (``blocks_free``, ``next_wake``, ``load``);
* one *round* advances every due instance by ``k ≥ 1`` engine iterations in
  bulk masked array ops, where ``k`` is the per-instance distance to the
  next discrete event (completion, context-window truncation, prefill
  chunk, KV-pressure, or the sweep horizon) — between events all iterations
  are identical, so jumping is exact;
* iteration wall-clock times come from the ``t_iter = W + H·n_active``
  roofline in one vectorized expression
  (:meth:`repro_torch.sim.timing.TimingModel.iter_time_batch`).

Equivalence contract with the scalar engine
-------------------------------------------
Admission (head-of-line FIFO with block reservation), KV-block growth, and
truncation are replicated exactly. KV-pressure rounds — where block growth
would exceed ``blocks_free`` — use the *order-free batch preemption rule*
shared verbatim by all three backends (reference, vectorized, torch): advance
→ truncate → completion credit → evict the minimal youngest-first prefix of
decoding survivors whose freed blocks cover the growth deficit (vLLM-style
preemption-by-recompute, enqueue-time descending with admission-order
tie-break). Because the rule is a single batch decision per iteration, it
vectorizes as a lexsort + cumsum masked pass here and as a sort-free
``torch.where`` victim-selection pass in :mod:`repro_torch.sim.torch_engine`,
with no scalar fallback. A copy of ``repro.sim.vector_engine``;
``tests/test_torch_sim.py`` holds it and the torch tier record-for-record
against the reference on seeded preemption-heavy traces (with power-of-two
timing constants so float accumulation is exact in every backend).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.pools import (
    KV_BLOCK_TOKENS,
    PoolConfig,
    PoolState,
    TOTAL_KV_BLOCKS,
)
from repro_torch.core.router import Request
from repro_torch.obs.events import ADMIT, PREEMPT, REJECT, TRUNCATE
from repro_torch.sim.engine import _blocks_for  # single source for KV rounding
from repro_torch.sim.metrics import RequestRecord
from repro_torch.sim.timing import TimingModel

#: Sentinel for "no constraint" in integer min-reductions.
_BIG = np.int64(1) << 62
_BIGF = 1.0e18

#: Queue entries are tuples to keep the admission loop allocation-light:
#: (request_id, arrival, input_tokens, output_tokens, enqueue, preemptions).
_QID, _QARR, _QIN, _QOUT, _QENQ, _QPRE = range(6)


class _ColumnStore:
    """Columnar request-record accumulator (bulk chunks + scalar buffer)."""

    COLUMNS = (
        ("request_id", np.int64),
        ("arrival", np.float64),
        ("first_token", np.float64),
        ("finish", np.float64),
        ("output_tokens", np.int64),
        ("preemptions", np.int64),
        ("truncated", np.bool_),
        ("rejected", np.bool_),
    )

    def __init__(self) -> None:
        self._chunks: list[tuple[np.ndarray, ...]] = []
        self._buffer: list[tuple] = []

    def add_bulk(self, *arrays: np.ndarray) -> None:
        if len(arrays[0]):
            self._chunks.append(tuple(np.ascontiguousarray(a) for a in arrays))

    def add_one(self, *values) -> None:
        self._buffer.append(values)

    def __len__(self) -> int:
        return sum(len(c[0]) for c in self._chunks) + len(self._buffer)

    def _flush(self) -> None:
        if self._buffer:
            cols = list(zip(*self._buffer))
            self._chunks.append(
                tuple(
                    np.asarray(col, dtype=dt)
                    for col, (_, dt) in zip(cols, self.COLUMNS)
                )
            )
            self._buffer.clear()

    def arrays(self) -> dict[str, np.ndarray]:
        """Concatenate every chunk into one array per column."""
        self._flush()
        if not self._chunks:
            return {
                name: np.empty(0, dtype=dt) for name, dt in self.COLUMNS
            }
        return {
            name: np.concatenate([c[j] for c in self._chunks])
            for j, (name, dt) in enumerate(self.COLUMNS)
        }


class VectorPoolSim:
    """All instances of one pool, stepped together as dense arrays.

    Drop-in behavioural twin of ``PoolSim`` + ``InstanceSim`` for the fleet
    layer: ``least_loaded``/``submit`` dispatch, ``sweep(t_limit)`` advances
    every instance through all engine iterations that start strictly before
    ``t_limit`` (matching the reference heap's arrival-first tie-break).
    """

    def __init__(
        self,
        config: PoolConfig,
        num_instances: int,
        timing: TimingModel,
        *,
        total_blocks: Optional[int] = None,
        name: Optional[str] = None,
    ) -> None:
        self.config = config
        self.timing = timing
        self.name = name or config.name
        if total_blocks is None:
            total_blocks = min(
                TOTAL_KV_BLOCKS, config.n_seq * _blocks_for(config.c_max)
            )
        self.total_blocks = total_blocks
        self.num_instances = num_instances
        self.state = PoolState(config=config, num_instances=num_instances)

        ii, ss = num_instances, config.n_seq
        # Token/block counts fit comfortably in int32 (c_max ≤ 65536); the
        # narrower dtype halves the memory traffic of the hot round.
        # -- per-slot SoA state, shape (I, S) --------------------------------
        self.occupied = np.zeros((ii, ss), dtype=bool)
        self.req_id = np.full((ii, ss), -1, dtype=np.int64)
        self.arrival = np.zeros((ii, ss), dtype=np.float64)
        self.enqueue = np.zeros((ii, ss), dtype=np.float64)
        self.input_tokens = np.zeros((ii, ss), dtype=np.int32)  # incl. recompute
        self.output_tokens = np.zeros((ii, ss), dtype=np.int32)  # original L_out
        self.prefill_remaining = np.zeros((ii, ss), dtype=np.int32)
        self.decode_remaining = np.zeros((ii, ss), dtype=np.int32)
        self.generated = np.zeros((ii, ss), dtype=np.int32)
        self.blocks = np.zeros((ii, ss), dtype=np.int32)
        self.first_token = np.full((ii, ss), np.nan, dtype=np.float64)
        self.truncated = np.zeros((ii, ss), dtype=bool)
        self.preempt_carried = np.zeros((ii, ss), dtype=np.int32)
        self.seq_no = np.zeros((ii, ss), dtype=np.int64)  # admission order
        # -- per-instance state, shape (I,) ----------------------------------
        self.blocks_free = np.full(ii, total_blocks, dtype=np.int64)
        self.next_wake = np.full(ii, np.inf, dtype=np.float64)
        self.n_active = np.zeros(ii, dtype=np.int64)
        self.queue_len = np.zeros(ii, dtype=np.int64)
        self.load = np.zeros(ii, dtype=np.int64)  # queue + active
        self.busy_time = np.zeros(ii, dtype=np.float64)
        self.queues: list[deque] = [deque() for _ in range(ii)]

        self.wake_min = np.inf
        self.preemption_count = 0
        self.rejection_count = 0
        self.truncation_count = 0
        self._seq_counter = 0
        self._records = _ColumnStore()
        self._completed_ids: list[np.ndarray] = []
        # Optional event tracing (repro_torch.obs): installed by the fleet layer;
        # None keeps the fast-path rounds free of any telemetry work.
        self.tracer = None
        self.pool_index = 0
        # Fault-injection lanes (repro_torch.sim.faults): per-instance slowdown
        # factors and down masks, applied as masked array ops inside the
        # round. ``_faulty`` stays False on fault-free runs so the hot path
        # is one extra predicate, exactly like ``tracer is None``.
        self._faulty = False
        self._n_down = 0
        self.slow = np.ones(ii, dtype=np.float64)
        self.down = np.zeros(ii, dtype=bool)
        self.down_until = np.zeros(ii, dtype=np.float64)

    # -- dispatch interface (fleet layer) ------------------------------------
    @property
    def preemptions(self) -> int:
        return self.preemption_count

    @property
    def rejections(self) -> int:
        return self.rejection_count

    @property
    def truncations(self) -> int:
        return self.truncation_count

    @property
    def busy(self) -> bool:
        return bool(np.isfinite(self.wake_min))

    def kv_occupancy(self) -> float:
        """Pool-wide KV block utilization: 1 − blocks_free / total_blocks."""
        cap = self.total_blocks * self.num_instances
        return 1.0 - float(self.blocks_free.sum()) / cap if cap else 0.0

    def least_loaded(self) -> int:
        """First instance with minimal load — same tie-break as the
        reference path's ``min(instances, key=load)``.

        Down instances are ejected from dispatch (masked to an impossible
        load); when *every* instance is down, dispatch falls back to plain
        least-loaded so requests queue for recovery instead of vanishing.
        """
        if 0 < self._n_down < self.num_instances:
            return int(np.argmin(np.where(self.down, _BIG, self.load)))
        return int(np.argmin(self.load))

    def submit(self, instance: int, request: Request, now: float) -> bool:
        """Enqueue a Request object on one instance (reference-parity API)."""
        return self.submit_raw(
            instance,
            request.request_id,
            request.arrival_time,
            request.true_input_tokens,
            request.true_output_tokens,
            now,
        )

    def submit_raw(
        self,
        instance: int,
        request_id: int,
        arrival: float,
        true_input_tokens: int,
        true_output_tokens: int,
        now: float,
    ) -> bool:
        """Columnar-native enqueue (scalar fields, no Request object);
        rejects if the prompt alone exceeds C_max."""
        if true_input_tokens >= self.config.c_max:
            self.rejection_count += 1
            if self.tracer is not None:
                self.tracer.emit(REJECT, now, self.pool_index, request_id)
            self._records.add_one(
                request_id, arrival, now, now, 0, 0, False, True,
            )
            return False
        self.queues[instance].append(
            (request_id, arrival, true_input_tokens, true_output_tokens, now, 0)
        )
        self.queue_len[instance] += 1
        self.load[instance] += 1
        self.state.queue_depth += 1
        if not np.isfinite(self.next_wake[instance]):
            t0 = now
            if (
                self._faulty
                and self.down[instance]
                and now < self.down_until[instance]
            ):
                # Reference parity: a sleeping crashed instance woken by a
                # submit self-reschedules to its recovery time.
                t0 = float(self.down_until[instance])
            self.next_wake[instance] = t0
            self.wake_min = min(self.wake_min, t0)
        return True

    # -- records -------------------------------------------------------------
    def record_arrays(self) -> dict[str, np.ndarray]:
        return self._records.arrays()

    @property
    def records(self) -> list[RequestRecord]:
        """Materialize RequestRecord objects (tests / debugging only)."""
        cols = self.record_arrays()
        return [
            RequestRecord(
                request_id=int(cols["request_id"][j]),
                pool=self.config.name,
                arrival=float(cols["arrival"][j]),
                first_token=float(cols["first_token"][j]),
                finish=float(cols["finish"][j]),
                output_tokens=int(cols["output_tokens"][j]),
                preemptions=int(cols["preemptions"][j]),
                truncated=bool(cols["truncated"][j]),
                rejected=bool(cols["rejected"][j]),
            )
            for j in range(len(cols["request_id"]))
        ]

    def drain_completed_ids(self) -> np.ndarray:
        """Request ids completed since the last drain (for router feedback)."""
        if not self._completed_ids:
            return np.empty(0, dtype=np.int64)
        out = np.concatenate(self._completed_ids)
        self._completed_ids.clear()
        return out

    # -- admission (exact mirror of InstanceSim._try_admit) ------------------
    def _try_admit(self, i: int, now: float) -> None:
        q = self.queues[i]
        n_seq = self.config.n_seq
        while q and self.n_active[i] < n_seq:
            entry = q[0]
            need = _blocks_for(entry[_QIN])
            if need > self.total_blocks:
                q.popleft()
                self.queue_len[i] -= 1
                self.load[i] -= 1
                self.state.queue_depth -= 1
                self.rejection_count += 1
                if self.tracer is not None:
                    self.tracer.emit(REJECT, now, self.pool_index, entry[_QID])
                self._records.add_one(
                    entry[_QID], entry[_QARR], now, now, 0, 0, False, True
                )
                continue
            if need > self.blocks_free[i]:
                break  # head-of-line: wait for blocks
            q.popleft()
            self.queue_len[i] -= 1
            self.state.queue_depth -= 1
            self.state.active += 1
            self.blocks_free[i] -= need
            self.n_active[i] += 1
            if self.tracer is not None:
                self.tracer.emit(ADMIT, now, self.pool_index, entry[_QID])
            slot = int(np.argmin(self.occupied[i]))  # first free slot
            self.occupied[i, slot] = True
            self.req_id[i, slot] = entry[_QID]
            self.arrival[i, slot] = entry[_QARR]
            self.enqueue[i, slot] = entry[_QENQ]
            self.input_tokens[i, slot] = entry[_QIN]
            self.output_tokens[i, slot] = entry[_QOUT]
            self.prefill_remaining[i, slot] = entry[_QIN]
            self.decode_remaining[i, slot] = entry[_QOUT]
            self.generated[i, slot] = 0
            self.blocks[i, slot] = need
            self.first_token[i, slot] = np.nan
            self.truncated[i, slot] = False
            self.preempt_carried[i, slot] = entry[_QPRE]
            self.seq_no[i, slot] = self._seq_counter
            self._seq_counter += 1

    # -- fault application (repro_torch.sim.faults) --------------------------------
    def install_faults(self) -> None:
        """Arm the per-round fault lanes (slowdown multiply, down masks)."""
        self._faulty = True

    def set_down(self, instance: int, down: bool, until: float = 0.0) -> None:
        if down and not self.down[instance]:
            self._n_down += 1
        if not down and self.down[instance]:
            self._n_down -= 1
        self.down[instance] = down
        if down:
            self.down_until[instance] = until

    def set_slow(self, instance: int, factor: float) -> None:
        self.slow[instance] = factor

    def _drop_slots(self, i: int, order: np.ndarray, requeue: bool) -> list[int]:
        """Destroy the given slots (admission order); requeue or report lost.

        Mirrors ``InstanceSim._drop_sequences``: blocks freed, recompute-
        style head-of-queue reinsertion preserving admission order.
        """
        k = len(order)
        if k == 0:
            return []
        self.blocks_free[i] += int(self.blocks[i, order].sum())
        self.blocks[i, order] = 0
        self.occupied[i, order] = False
        self.n_active[i] -= k
        self.state.active -= k
        if requeue:
            for s in order[::-1]:
                self.queues[i].appendleft(
                    (
                        int(self.req_id[i, s]),
                        float(self.arrival[i, s]),
                        int(self.input_tokens[i, s] + self.generated[i, s]),
                        int(self.output_tokens[i, s]),
                        float(self.enqueue[i, s]),
                        int(self.preempt_carried[i, s]),
                    )
                )
            self.queue_len[i] += k
            self.state.queue_depth += k
            return []
        self.load[i] -= k
        return [int(self.req_id[i, s]) for s in order]

    def fault_crash(self, instance: int, now: float, requeue: bool) -> list[int]:
        """Hard crash: drop all in-flight sequences, sleep until recovery.

        Call :meth:`set_down` first so the reschedule below sees the
        recovery time. Queued work survives; the pending wake becomes
        ``max(pending wake, down_until)`` — exactly when the reference
        instance's self-rescheduling heap event next admits (its in-heap
        event fires at the old time and either admits there, post-recovery,
        or re-sleeps until ``down_until``). A crash on an idle instance
        leaves it asleep; ``submit_raw``'s downtime guard covers later
        arrivals.
        """
        i = instance
        slots = np.flatnonzero(self.occupied[i])
        order = slots[np.argsort(self.seq_no[i, slots], kind="stable")]
        lost = self._drop_slots(i, order, requeue)
        nw = float(self.next_wake[i])
        if np.isfinite(nw):
            self.next_wake[i] = max(nw, float(self.down_until[i]))
            self.wake_min = float(self.next_wake.min())
        return lost

    def fault_oom(
        self, instance: int, now: float, evict_frac: float, requeue: bool
    ) -> list[int]:
        """KV-OOM kill: evict the youngest ``evict_frac`` of resident seqs
        (last in admission order — the same direction preemption victims
        go). The instance itself stays up."""
        i = instance
        slots = np.flatnonzero(self.occupied[i])
        n = len(slots)
        if n == 0:
            return []
        order = slots[np.argsort(self.seq_no[i, slots], kind="stable")]
        k = min(n, max(1, int(np.ceil(evict_frac * n))))
        return self._drop_slots(i, order[n - k :], requeue)

    # -- masked-lane pass for KV-pressure rounds (k == 1) --------------------
    def _pressure_rows(
        self,
        gi: np.ndarray,
        decp: np.ndarray,
        now: np.ndarray,
        t_it: np.ndarray,
        end: np.ndarray,
    ) -> None:
        """Decode phase for lanes whose block growth exceeds ``blocks_free``.

        Implements the order-free batch semantics shared with the reference
        engine's ``step()`` and the torch backend's round: advance
        every decoding lane one token → truncate at C_max → completions free
        their blocks (completion credit) → evict the minimal youngest-first
        prefix of decoding survivors whose freed blocks cover the remaining
        growth deficit → allocate growth. Victim selection is one lexsort +
        cumsum pass per lane (``enqueue`` descending, admission order
        tie-break) — no per-sequence Python loop, no dependence on
        within-iteration sequence order.
        """
        c_max = self.config.c_max
        inp = self.input_tokens[gi]
        gen = self.generated[gi] + decp  # a) advance one token
        rem = self.decode_remaining[gi] - decp
        ft = self.first_token[gi]
        ft = np.where(decp & np.isnan(ft), (now + t_it)[:, None], ft)

        # b) context-window truncation at C_max mid-generation
        trunc = decp & (inp + gen >= c_max) & (rem > 0)
        rem = np.where(trunc, 0, rem)
        trunc_all = self.truncated[gi] | trunc
        self.truncation_count += int(trunc.sum())
        if self.tracer is not None and trunc.any():
            for ri, si in zip(*np.nonzero(trunc)):
                self.tracer.emit(
                    TRUNCATE,
                    float(end[ri]),
                    self.pool_index,
                    int(self.req_id[gi[ri], si]),
                )

        self.generated[gi] = gen
        self.decode_remaining[gi] = rem
        self.first_token[gi] = ft
        self.truncated[gi] = trunc_all

        # c) completion credit: finished lanes release their blocks before
        # growth is charged.
        comp = decp & (rem == 0)
        if comp.any():
            ri, si = np.nonzero(comp)
            ci = gi[ri]
            self._records.add_bulk(
                self.req_id[ci, si],
                self.arrival[ci, si],
                ft[ri, si],
                end[ri],
                gen[ri, si],
                self.preempt_carried[ci, si],
                trunc_all[ri, si],
                np.zeros(len(ri), dtype=bool),
            )
            self._completed_ids.append(self.req_id[ci, si].copy())
            np.add.at(self.blocks_free, ci, self.blocks[ci, si])
            self.blocks[ci, si] = 0
            self.occupied[ci, si] = False
            done_per_row = np.bincount(ri, minlength=len(gi)).astype(np.int64)
            self.n_active[gi] -= done_per_row
            self.load[gi] -= done_per_row
            self.state.active -= len(ri)

        # d) growth deficit + minimal youngest-first prefix eviction
        surv = decp & (rem > 0)
        blk = self.blocks[gi]
        need = np.where(
            surv,
            np.maximum(1, (inp + gen + (KV_BLOCK_TOKENS - 1)) // KV_BLOCK_TOKENS),
            blk,
        )
        grow = np.where(surv, need - blk, 0)
        demand = grow.sum(axis=1)
        free = self.blocks_free[gi]

        # Victim order per lane: enqueue descending (youngest first),
        # admission order (seq_no) tie-break; non-candidates sort last.
        keyq = np.where(surv, -self.enqueue[gi], np.inf)
        order = np.lexsort((self.seq_no[gi], keyq), axis=1)
        sblk = np.take_along_axis(np.where(surv, blk, 0), order, axis=1)
        sgrow = np.take_along_axis(grow, order, axis=1)
        # Evicting the first j victims frees cum(blocks) and cancels
        # cum(grow); both sides are monotone in j, so the first prefix that
        # covers the deficit is minimal. j == 0 means no eviction (growth
        # fits once completion credit is applied).
        okj = demand[:, None] - np.cumsum(sgrow, axis=1) <= (
            free[:, None] + np.cumsum(sblk, axis=1)
        )
        j = np.where(demand <= free, 0, np.argmax(okj, axis=1) + 1)
        evict = np.zeros_like(surv)
        np.put_along_axis(
            evict, order, np.arange(okj.shape[1])[None, :] < j[:, None], axis=1
        )
        evict &= surv

        if evict.any():
            self.preemption_count += int(evict.sum())
            for r in np.flatnonzero(evict.any(axis=1)):
                i = int(gi[r])
                slots = np.flatnonzero(evict[r])
                vorder = slots[np.argsort(self.seq_no[i, slots], kind="stable")]
                if self.tracer is not None:
                    for s in vorder:
                        self.tracer.emit(
                            PREEMPT,
                            float(end[r]),
                            self.pool_index,
                            int(self.req_id[i, s]),
                        )
                self.blocks_free[i] += int(self.blocks[i, vorder].sum())
                # Recompute mode: requeue at the head preserving admission
                # order among the victim group, prompt += generated-so-far,
                # original output budget (reference engine semantics).
                for s in vorder[::-1]:
                    self.queues[i].appendleft(
                        (
                            int(self.req_id[i, s]),
                            float(self.arrival[i, s]),
                            int(self.input_tokens[i, s] + gen[r, s]),
                            int(self.output_tokens[i, s]),
                            float(self.enqueue[i, s]),
                            int(self.preempt_carried[i, s]) + 1,
                        )
                    )
                nv = len(vorder)
                self.occupied[i, vorder] = False
                self.blocks[i, vorder] = 0
                self.n_active[i] -= nv
                self.queue_len[i] += nv
                self.state.queue_depth += nv
                self.state.active -= nv

        # e) allocate growth to the remaining survivors
        keep = surv & ~evict
        self.blocks_free[gi] -= np.where(keep, grow, 0).sum(axis=1)
        self.blocks[gi] = np.where(keep, need, self.blocks[gi])

    # -- the vectorized round ------------------------------------------------
    def sweep(self, t_limit: float = np.inf) -> None:
        """Run every engine iteration starting strictly before ``t_limit``."""
        while self.wake_min < t_limit:
            self._round(t_limit)

    def _round(self, t_limit: float) -> None:
        due = np.flatnonzero(self.next_wake < t_limit)
        # Admission first, exactly like the reference step() prologue.
        for i in due[self.queue_len[due] > 0]:
            self._try_admit(i, float(self.next_wake[i]))

        nact = self.n_active[due]
        busy = nact > 0
        # Instances with nothing admitted go back to sleep (reference: idle
        # instances leave the wake heap). A non-empty queue here means the
        # head is future-dated relative to this instance — cannot happen,
        # but a defensive retry avoids a livelock if it ever does.
        idle_rows = due[~busy]
        if len(idle_rows):
            has_q = self.queue_len[idle_rows] > 0
            self.next_wake[idle_rows] = np.where(
                has_q, self.next_wake[idle_rows] + 1e-9, np.inf
            )
        rows = due[busy]
        if not len(rows):
            self.wake_min = float(self.next_wake.min())
            return

        nact = nact[busy]
        now = self.next_wake[rows]
        t_it = self.timing.iter_time_batch(nact)
        if self._faulty:
            # Straggler lanes: per-instance iteration-time multiplier.
            # Multiplying by exactly 1.0 is a bit-exact no-op, so healthy
            # lanes are unaffected (reference parity: base time first,
            # then the factor).
            t_it = t_it * self.slow[rows]

        # 1) One prefill chunk of up to C tokens to the oldest prefilling
        #    sequence of each instance (admission order == seq_no order).
        occ = self.occupied[rows]
        pre = self.prefill_remaining[rows]
        pmask = occ & (pre > 0)
        has_pre = pmask.any(axis=1)
        if has_pre.any():
            key = np.where(pmask, self.seq_no[rows], _BIG)
            oldest = key.argmin(axis=1)
            pr = np.flatnonzero(has_pre)
            gi, gs = rows[pr], oldest[pr]
            take = np.minimum(
                self.prefill_remaining[gi, gs], self.timing.prefill_chunk
            )
            self.prefill_remaining[gi, gs] -= take
            pre[pr, oldest[pr]] -= take  # keep the local copy in sync

        # 2) Decode phase. ``dec`` is the decoding mask at round start —
        #    sequences whose final prefill chunk just landed are included
        #    (prefill→decode fusion, as in the reference engine).
        dec = occ & (pre == 0) & (self.decode_remaining[rows] > 0)
        dec_rem = self.decode_remaining[rows]
        gen = self.generated[rows]
        inp = self.input_tokens[rows]
        ctx0 = inp + gen

        # Event-distance jump: k iterations are identical until the nearest
        # completion / truncation / prefill boundary / sweep horizon.
        k_complete = np.where(dec, dec_rem, _BIG).min(axis=1)
        k_trunc = np.where(dec, self.config.c_max - ctx0, _BIG).min(axis=1)
        with np.errstate(invalid="ignore"):
            q = (t_limit - now) / t_it
        k_time = np.where(np.isfinite(q), np.ceil(q - 1e-9), _BIGF)
        k = np.minimum(np.minimum(k_complete, k_trunc).astype(np.float64), k_time)
        k = np.where(has_pre, 1.0, np.maximum(k, 1.0))
        k = np.minimum(k, float(_BIG)).astype(np.int64)

        # KV growth over the whole jump; shrink to k=1 (and then to the
        # exact scalar fallback) when blocks_free cannot absorb it.
        blocks_r = self.blocks[rows]

        def growth(kk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            new_gen = gen + np.where(dec, kk[:, None], 0)
            need = np.where(
                occ,
                np.maximum(
                    1, (inp + new_gen + (KV_BLOCK_TOKENS - 1)) // KV_BLOCK_TOKENS
                ),
                0,
            )
            grow = np.maximum(need - blocks_r, 0)
            return need, grow.sum(axis=1)

        need_end, total_grow = growth(k)
        over = total_grow > self.blocks_free[rows]
        if over.any():
            k = np.where(over, 1, k)
            need_end, total_grow = growth(k)
            pressure = total_grow > self.blocks_free[rows]
        else:
            pressure = np.zeros(len(rows), dtype=bool)

        end = now + k * t_it
        self.busy_time[rows] += k * t_it

        # -- vectorized fast path (no preemption possible) -------------------
        v = np.flatnonzero(~pressure)
        if len(v):
            gv = rows[v]
            decv = dec[v]
            kv = k[v][:, None]
            endv = end[v]

            ft = self.first_token[gv]
            ft_new = np.where(
                decv & np.isnan(ft), (now[v] + t_it[v])[:, None], ft
            )
            gen_after = gen[v] + np.where(decv, kv, 0)
            rem_after = dec_rem[v] - np.where(decv, kv, 0)

            # context-window truncation at C_max mid-generation
            trunc = decv & (inp[v] + gen_after >= self.config.c_max) & (
                rem_after > 0
            )
            rem_after = np.where(trunc, 0, rem_after)
            trunc_all = self.truncated[gv] | trunc
            self.truncation_count += int(trunc.sum())
            if self.tracer is not None and trunc.any():
                for ri, si in zip(*np.nonzero(trunc)):
                    self.tracer.emit(
                        TRUNCATE,
                        float(endv[ri]),
                        self.pool_index,
                        int(self.req_id[gv[ri], si]),
                    )

            grow_v = np.maximum(need_end[v] - blocks_r[v], 0)
            self.blocks_free[gv] -= grow_v.sum(axis=1)
            self.blocks[gv] = np.where(occ[v], need_end[v], blocks_r[v])

            comp = decv & (rem_after == 0)
            self.generated[gv] = gen_after
            self.decode_remaining[gv] = rem_after
            self.first_token[gv] = ft_new
            self.truncated[gv] = trunc_all

            if comp.any():
                ri, si = np.nonzero(comp)
                gi = gv[ri]
                self._records.add_bulk(
                    self.req_id[gi, si],
                    self.arrival[gi, si],
                    ft_new[ri, si],
                    endv[ri],
                    gen_after[ri, si],
                    self.preempt_carried[gi, si],
                    trunc_all[ri, si],
                    np.zeros(len(ri), dtype=bool),
                )
                self._completed_ids.append(self.req_id[gi, si].copy())
                np.add.at(self.blocks_free, gi, self.blocks[gi, si])
                self.blocks[gi, si] = 0
                self.occupied[gi, si] = False
                done_per_row = np.bincount(ri, minlength=len(v)).astype(np.int64)
                self.n_active[gv] -= done_per_row
                self.load[gv] -= done_per_row
                self.state.active -= len(ri)

        # -- masked-lane pass for KV-pressure rounds (k == 1) ----------------
        pj = np.flatnonzero(pressure)
        if len(pj):
            self._pressure_rows(rows[pj], dec[pj], now[pj], t_it[pj], end[pj])

        # 3) Reschedule: wake at iteration end while work remains.
        alive_rows = (self.n_active[rows] > 0) | (self.queue_len[rows] > 0)
        self.next_wake[rows] = np.where(alive_rows, end, np.inf)
        self.wake_min = float(self.next_wake.min())
