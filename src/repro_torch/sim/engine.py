"""Instance-level discrete-event simulator (paper Appendix A, layer 1).

Each vLLM-style engine is an *iteration-based continuous-batching server*:

* every iteration processes one prefill chunk of up to ``C`` tokens plus one
  decode token for every active-decoding sequence;
* block-level KV accounting (16-token blocks) gates admission; exhaustion
  during decode triggers vLLM-style preemption-by-recompute of the youngest
  sequence;
* iteration wall-clock time follows the linear-overhead roofline
  ``t_iter = W + H · n_active``.

The fleet layer (:mod:`repro_torch.sim.fleet`) drives many instances plus the
token-budget router; this module is single-instance and time is advanced by
the caller, which makes it directly unit-testable.

This scalar engine is the **reference backend** (``backend="reference"``):
one Python object per sequence, one call per instance per iteration. The
struct-of-arrays **vectorized backend** (:mod:`repro_torch.sim.vector_engine`,
``backend="vectorized"``) steps every instance of a pool in bulk NumPy ops
and must stay behaviourally equivalent to this implementation — the
equivalence suite in ``tests/test_vector_engine.py`` locks the two together.
When changing admission, preemption, truncation, or timing semantics here,
mirror the change there.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

from repro_torch.core.pools import (
    KV_BLOCK_TOKENS,
    PoolConfig,
    PoolState,
    TOTAL_KV_BLOCKS,
)
from repro_torch.core.router import Request
from repro_torch.obs.events import ADMIT, PREEMPT, REJECT, TRUNCATE
from repro_torch.sim.metrics import RequestRecord
from repro_torch.sim.timing import TimingModel


@dataclasses.dataclass
class _Seq:
    """One in-flight sequence inside an instance."""

    request: Request
    enqueue_time: float
    prefill_remaining: int
    decode_remaining: int
    generated: int = 0
    blocks: int = 0
    first_token_time: Optional[float] = None
    preemptions: int = 0
    truncated: bool = False

    @property
    def context_len(self) -> int:
        done_prefill = self.request.true_input_tokens - self.prefill_remaining
        return done_prefill + self.generated

    @property
    def decoding(self) -> bool:
        return self.prefill_remaining == 0 and self.decode_remaining > 0


def _blocks_for(tokens: int) -> int:
    return max(1, math.ceil(tokens / KV_BLOCK_TOKENS))


class InstanceSim:
    """One serving instance with `pool.n_seq` slots and a KV block budget."""

    def __init__(
        self,
        pool: PoolConfig,
        timing: TimingModel,
        *,
        total_blocks: Optional[int] = None,
        name: str = "instance",
        pool_state: Optional[PoolState] = None,
    ) -> None:
        self.pool = pool
        self.timing = timing
        self.name = name
        # Shared dispatch state, maintained *incrementally* on every
        # submit/admit/preempt/complete so the router reads O(1) counters
        # instead of sweeping all instances per arrival (paper §2.2).
        self.pool_state = pool_state
        # The block budget reserves C_max tokens per slot (the paper's
        # provisioning rule): n_seq slots x ceil(C_max/16) blocks.
        if total_blocks is None:
            total_blocks = min(
                TOTAL_KV_BLOCKS, pool.n_seq * _blocks_for(pool.c_max)
            )
        self.total_blocks = total_blocks
        self.blocks_free = total_blocks
        self.queue: deque[tuple[Request, float]] = deque()
        self.active: list[_Seq] = []
        self.records: list[RequestRecord] = []
        self.preemption_count = 0
        self.rejection_count = 0
        self.truncation_count = 0
        self.busy_time = 0.0
        self._carried_preemptions: dict[int, int] = {}
        # Optional event tracing (repro_torch.obs): the fleet layer installs an
        # EventTrace and this instance's pool index. None (the default)
        # keeps every emission site a single predicate on the hot path.
        self.tracer = None
        self.pool_index = 0
        self._now = 0.0  # iteration-end time, maintained only when tracing
        # Fault-injection state (repro_torch.sim.faults). Defaults are the
        # fault-free fast path: `now < 0.0` is false and `slow_factor`
        # stays exactly 1.0, so un-faulted runs are bit-identical.
        self.downed = False
        self.down_until = 0.0
        self.slow_factor = 1.0

    # -- queue interface (fleet layer) ---------------------------------------
    @property
    def load(self) -> int:
        return len(self.queue) + len(self.active)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def _state_add(self, d_queue: int, d_active: int) -> None:
        if self.pool_state is not None:
            self.pool_state.queue_depth += d_queue
            self.pool_state.active += d_active

    def submit(self, request: Request, now: float) -> bool:
        """Enqueue a request; reject if the prompt alone exceeds C_max."""
        if request.true_input_tokens >= self.pool.c_max:
            self.rejection_count += 1
            if self.tracer is not None:
                self.tracer.emit(
                    REJECT, now, self.pool_index, request.request_id
                )
            self.records.append(
                RequestRecord(
                    request_id=request.request_id,
                    pool=self.pool.name,
                    arrival=request.arrival_time,
                    first_token=now,
                    finish=now,
                    output_tokens=0,
                    rejected=True,
                )
            )
            return False
        self.queue.append((request, now))
        self._state_add(+1, 0)
        return True

    # -- admission ------------------------------------------------------------
    def _try_admit(self, now: float) -> None:
        while self.queue and len(self.active) < self.pool.n_seq:
            request, enq = self.queue[0]
            need = _blocks_for(request.true_input_tokens)
            if need > self.total_blocks:
                # can never fit, even on an empty instance → reject
                self.queue.popleft()
                self._state_add(-1, 0)
                self.rejection_count += 1
                if self.tracer is not None:
                    self.tracer.emit(
                        REJECT, now, self.pool_index, request.request_id
                    )
                self.records.append(
                    RequestRecord(
                        request_id=request.request_id,
                        pool=self.pool.name,
                        arrival=request.arrival_time,
                        first_token=now,
                        finish=now,
                        output_tokens=0,
                        rejected=True,
                    )
                )
                continue
            if need > self.blocks_free:
                break  # head-of-line: wait for blocks
            self.queue.popleft()
            self._state_add(-1, +1)
            self.blocks_free -= need
            if self.tracer is not None:
                self.tracer.emit(
                    ADMIT, now, self.pool_index, request.request_id
                )
            self.active.append(
                _Seq(
                    request=request,
                    enqueue_time=enq,
                    prefill_remaining=request.true_input_tokens,
                    decode_remaining=request.true_output_tokens,
                    blocks=need,
                    preemptions=self._carried_preemptions.get(
                        request.request_id, 0
                    ),
                )
            )

    # -- preemption (vLLM recompute mode: youngest victims, batch rule) --------
    def _evict_victims(self, victims: list[_Seq]) -> None:
        """Preempt ``victims`` (given in admission order): free their blocks
        and requeue them recompute-style at the queue head, preserving
        admission order among the group (vLLM behaviour)."""
        for seq in victims:
            self.active.remove(seq)
            self.blocks_free += seq.blocks
            seq.blocks = 0
            seq.preemptions += 1
            self.preemption_count += 1
            if self.tracer is not None:
                self.tracer.emit(
                    PREEMPT, self._now, self.pool_index, seq.request.request_id
                )
            self._carried_preemptions[seq.request.request_id] = seq.preemptions
        for seq in reversed(victims):
            # Recompute mode: restart prefill over prompt + generated-so-far
            # with the original output budget.
            req = seq.request
            restart = dataclasses.replace(
                req, true_input_tokens=req.true_input_tokens + seq.generated
            )
            self.queue.appendleft((restart, seq.enqueue_time))
        self._state_add(+len(victims), -len(victims))

    # -- fault application (repro_torch.sim.faults) ----------------------------------
    def _drop_sequences(self, victims: list[_Seq], requeue: bool) -> list[int]:
        """Destroy in-flight sequences; requeue locally or report them lost.

        Victims must be in admission order; requeue preserves that order at
        the head of the queue (recompute-style, generated tokens folded into
        the prompt). Returns the lost request ids (empty when requeueing).
        """
        for seq in victims:
            self.blocks_free += seq.blocks
            seq.blocks = 0
        self._state_add(0, -len(victims))
        if requeue:
            for seq in reversed(victims):
                req = seq.request
                self._carried_preemptions[req.request_id] = seq.preemptions
                restart = dataclasses.replace(
                    req, true_input_tokens=req.true_input_tokens + seq.generated
                )
                self.queue.appendleft((restart, seq.enqueue_time))
            self._state_add(+len(victims), 0)
            return []
        lost = [seq.request.request_id for seq in victims]
        for rid in lost:
            self._carried_preemptions.pop(rid, None)
        return lost

    def fault_crash(self, now: float, requeue: bool) -> list[int]:
        """Hard crash: every in-flight sequence is dropped.

        Downtime itself is handled by the fleet via ``down_until`` — the
        instance's pending iteration event self-reschedules through the
        early return in :meth:`step`.
        """
        victims = self.active
        self.active = []
        return self._drop_sequences(victims, requeue)

    def fault_oom(self, now: float, evict_frac: float, requeue: bool) -> list[int]:
        """KV-OOM kill: evict the youngest ``evict_frac`` of resident seqs."""
        n = len(self.active)
        if n == 0:
            return []
        k = min(n, max(1, math.ceil(evict_frac * n)))
        victims = self.active[n - k :]
        del self.active[n - k :]
        return self._drop_sequences(victims, requeue)

    # -- one engine iteration ---------------------------------------------------
    def step(self, now: float) -> tuple[float, list[RequestRecord]]:
        """Run one iteration starting at `now`; returns (t_iter, completions)."""
        if now < self.down_until:
            # Crashed: sleep (not busy) until recovery, then resume. Queued
            # work survives; admission happens at recovery time.
            return self.down_until - now, []
        self._try_admit(now)
        if not self.active:
            return 0.0, []

        n_active = len(self.active)
        t_iter = self.timing.iter_time(n_active)
        if self.slow_factor != 1.0:
            t_iter *= self.slow_factor
        end = now + t_iter
        if self.tracer is not None:
            self._now = end  # timestamp for mid-iteration preempt events
        completed: list[RequestRecord] = []

        # 1) One prefill chunk of up to C tokens (oldest prefilling sequence).
        budget = self.timing.prefill_chunk
        for seq in self.active:
            if seq.prefill_remaining > 0 and budget > 0:
                chunk = min(seq.prefill_remaining, budget)
                seq.prefill_remaining -= chunk
                budget -= chunk
                # Blocks were reserved for the whole prompt at admission
                # (the paper's point: chunking does NOT shrink KV footprint).
                break  # a single chunk per iteration (Appendix A)

        # 2) One decode token per active-decoding sequence — *order-free batch
        # semantics*, shared verbatim with the vectorized and torch backends:
        #   a. advance every decoding sequence one token (prefill→decode
        #      fusion: a sequence whose last prefill chunk landed this
        #      iteration emits its first token in the same iteration);
        #   b. truncate sequences that hit C_max mid-generation;
        #   c. completions free their blocks (completion credit) *before*
        #      KV growth is resolved;
        #   d. if the survivors' block growth exceeds blocks_free, evict the
        #      minimal youngest-first prefix of decoding survivors (max
        #      enqueue_time first, first-admitted tie-break) whose freed
        #      blocks cover the deficit — one batch decision per iteration,
        #      with no dependence on within-iteration sequence order.
        done: list[_Seq] = []
        growers: list[_Seq] = []  # admission order (self.active invariant)
        for seq in self.active:
            if not seq.decoding:
                continue
            if seq.first_token_time is None:
                seq.first_token_time = end
            seq.generated += 1
            seq.decode_remaining -= 1

            # Context-window truncation (hits C_max mid-generation).
            if seq.context_len >= self.pool.c_max and seq.decode_remaining > 0:
                seq.truncated = True
                seq.decode_remaining = 0
                self.truncation_count += 1
                if self.tracer is not None:
                    self.tracer.emit(
                        TRUNCATE, end, self.pool_index, seq.request.request_id
                    )
            if seq.decode_remaining == 0:
                done.append(seq)
            else:
                growers.append(seq)

        # c) Completion credit: finished sequences release their blocks
        # before growth is charged.
        for seq in done:
            self.active.remove(seq)
            self._state_add(0, -1)
            self.blocks_free += seq.blocks
            completed.append(
                RequestRecord(
                    request_id=seq.request.request_id,
                    pool=self.pool.name,
                    arrival=seq.request.arrival_time,
                    first_token=seq.first_token_time or end,
                    finish=end,
                    output_tokens=seq.generated,
                    preemptions=seq.preemptions,
                    truncated=seq.truncated,
                )
            )

        # d) KV growth: a new block every KV_BLOCK_TOKENS generated tokens.
        grow = [
            _blocks_for(s.request.true_input_tokens + s.generated) - s.blocks
            for s in growers
        ]
        demand = sum(grow)
        if demand > self.blocks_free:
            # Youngest-first eviction order; `sorted` is stable, so ties on
            # enqueue_time keep admission order (first-admitted evicted
            # first — the reference `max()` victim rule).
            order = sorted(
                range(len(growers)), key=lambda j: -growers[j].enqueue_time
            )
            supply = self.blocks_free
            evicted: set[int] = set()
            for j in order:
                if demand <= supply:
                    break
                demand -= grow[j]
                supply += growers[j].blocks
                evicted.add(j)
            self._evict_victims([growers[j] for j in sorted(evicted)])
            growers = [s for j, s in enumerate(growers) if j not in evicted]
        for seq in growers:
            need = _blocks_for(seq.request.true_input_tokens + seq.generated)
            self.blocks_free -= need - seq.blocks
            seq.blocks = need

        self.records.extend(completed)
        self.busy_time += t_iter
        return t_iter, completed
