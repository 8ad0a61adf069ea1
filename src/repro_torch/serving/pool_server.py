"""Two-pool server: the paper's system, end to end, on the port's engines.

Wires Algorithm 1 (token-budget dispatch + EMA calibration + spillover) to
two :class:`ServingEngine` instances — a short pool with small ``c_max``
and high slot count, and a long pool with the full context window. The
router sees only bytes + ``max_output_tokens``; exact prompt token counts
flow back through ``Completion.prompt_tokens`` (= ``usage.prompt_tokens``).
Counterpart of ``repro.serving.pool_server``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.calibration import EmaCalibrator
from repro_torch.core.pools import PoolConfig, PoolState
from repro_torch.core.router import Request, TokenBudgetRouter
from repro_torch.models.model_zoo import Model
from repro_torch.serving.engine import Completion, ServeRequest, ServingEngine
from repro_torch.serving.sampler import SamplingParams


@dataclasses.dataclass
class ServedResponse:
    request_id: int
    pool: str
    prompt_tokens: int
    output_tokens: list[int]
    estimated_budget: int
    spilled: bool


class TwoPoolServer:
    """Production topology of the paper, scaled to in-process engines."""

    def __init__(
        self,
        model: Model,
        params: Any,
        *,
        short_cmax: int,
        long_cmax: int,
        short_slots: int,
        long_slots: int,
        b_short: Optional[int] = None,
        bytes_per_token_hint: float = 4.0,
        sampling: SamplingParams = SamplingParams(),
        spillover: bool = True,
        queue_limit: int = 64,
    ) -> None:
        self.short_engine = ServingEngine(
            model, params, c_max=short_cmax, n_slots=short_slots,
            sampling=sampling,
        )
        self.long_engine = ServingEngine(
            model, params, c_max=long_cmax, n_slots=long_slots,
            sampling=sampling,
        )
        short_cfg = PoolConfig(
            "short", short_cmax, short_slots, queue_limit=queue_limit
        )
        long_cfg = PoolConfig(
            "long", long_cmax, long_slots, queue_limit=queue_limit
        )
        self._short_state = PoolState(config=short_cfg, num_instances=1)
        self._long_state = PoolState(config=long_cfg, num_instances=1)
        self.router = TokenBudgetRouter(
            self._short_state,
            self._long_state,
            b_short=b_short or short_cmax,
            calibrator=EmaCalibrator(c0=bytes_per_token_hint),
            spillover=spillover,
        )
        self._inflight: dict[int, tuple[Request, str]] = {}
        self.responses: list[ServedResponse] = []

    # -- request path -----------------------------------------------------------
    def submit(
        self,
        request_id: int,
        prompt_tokens: list[int],
        prompt_bytes: int,
        max_output_tokens: int,
        category: int = 0,
    ) -> str:
        """Route and enqueue. Returns the pool name chosen."""
        req = Request(
            request_id=request_id,
            byte_len=prompt_bytes,
            max_output_tokens=max_output_tokens,
            category=category,
        )
        self._refresh_states()
        decision = self.router.route(req)
        engine = (
            self.short_engine if decision.pool == "short" else self.long_engine
        )
        ok = engine.submit(
            ServeRequest(
                request_id=request_id,
                tokens=prompt_tokens,
                max_new_tokens=max_output_tokens,
            )
        )
        if not ok and decision.pool == "short":
            # hard-constraint miss (estimate was wrong): bounce to long pool
            self.long_engine.submit(
                ServeRequest(
                    request_id=request_id,
                    tokens=prompt_tokens,
                    max_new_tokens=max_output_tokens,
                )
            )
            decision = dataclasses.replace(decision, pool="long")
        self._inflight[request_id] = (req, decision.pool)
        return decision.pool

    def _refresh_states(self) -> None:
        self._short_state.queue_depth = self.short_engine.queue_depth
        self._short_state.active = self.short_engine.active
        self._long_state.queue_depth = self.long_engine.queue_depth
        self._long_state.active = self.long_engine.active

    # -- engine loop --------------------------------------------------------------
    def step(self) -> list[ServedResponse]:
        """One iteration on both pools; feeds usage back to the calibrator."""
        out: list[ServedResponse] = []
        for name, engine in (
            ("short", self.short_engine),
            ("long", self.long_engine),
        ):
            for comp in engine.step():
                out.append(self._complete(name, comp))
        self.responses.extend(out)
        return out

    def _complete(self, pool: str, comp: Completion) -> ServedResponse:
        req, routed_pool = self._inflight.pop(comp.request_id)
        # usage.prompt_tokens feedback → EMA calibration (Algorithm 1 l.15–19)
        self.router.on_response(req, comp.prompt_tokens)
        est = self.router.calibrator.estimate_total_budget(
            req.byte_len, req.max_output_tokens, req.category
        )
        return ServedResponse(
            request_id=comp.request_id,
            pool=pool,
            prompt_tokens=comp.prompt_tokens,
            output_tokens=comp.output_tokens,
            estimated_budget=est,
            spilled=routed_pool != pool,
        )

    def run_to_completion(self, max_iters: int = 100_000) -> list[ServedResponse]:
        out: list[ServedResponse] = []
        for _ in range(max_iters):
            out.extend(self.step())
            if not self._inflight:
                break
        return out

    def stats(self) -> dict:
        return {
            "router": self.router.stats(),
            "short_iterations": self.short_engine.iterations,
            "long_iterations": self.long_engine.iterations,
            "short_rejections": self.short_engine.rejections,
            "long_rejections": self.long_engine.rejections,
            "short_decode_tokens": self.short_engine.decode_tokens,
            "long_decode_tokens": self.long_engine.decode_tokens,
        }
