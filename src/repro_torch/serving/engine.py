"""Iteration-based continuous-batching serving engine (one pool instance).

Counterpart of ``repro.serving.engine``: ``n_seq`` slots, one decode token
per active slot per iteration, prompt prefill on admission. Where the
reference ``vmap``s a single-sequence decode over the slot axis, the port
runs one decode over an explicit slot batch dimension with a per-slot
``index`` tensor, so every slot writes its KV at its own position (both
families). Dense and MoE prompts are right-padded to ``prompt_bucket``
tokens; hybrid and xLSTM (ssm) prompts go unpadded, since pad tokens would
enter the recurrent state (the reference pads the same families).

Every decode step runs all ``n_slots`` rows, free ones included (their
token and index are stale and their outputs ignored), as the reference
does.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.model_zoo import Model
from repro_torch.serving.kv_cache import SlotAllocator, SlotKVCache, bucket_length
from repro_torch.serving.sampler import SamplingParams, sample


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    tokens: list[int]  # prompt token ids
    max_new_tokens: int
    eos_id: int = -1  # -1 → never stops early


@dataclasses.dataclass
class Completion:
    request_id: int
    prompt_tokens: int  # usage.prompt_tokens — the router's feedback signal
    output_tokens: list[int]
    iterations: int


@dataclasses.dataclass
class _SlotState:
    request: ServeRequest
    length: int  # current context length (prompt + generated)
    remaining: int
    generated: list[int]
    iterations: int = 0


class ServingEngine:
    """One pool instance: admission queue + slot cache + decode loop.

    The cache lives on the device of ``params["embed"]``.
    """

    def __init__(
        self,
        model: Model,
        params: Any,
        *,
        c_max: int,
        n_slots: int,
        sampling: SamplingParams = SamplingParams(),
        prompt_bucket: int = 64,
    ) -> None:
        if model.cfg.frontend != "tokens":
            raise ValueError("serving engine requires a token-frontend arch")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.c_max = c_max
        self.n_slots = n_slots
        self.sampling = sampling
        self.prompt_bucket = prompt_bucket
        self.cache = SlotKVCache(
            model, c_max, n_slots, device=self.device, act_dtype=params["embed"].dtype
        )
        self.alloc = SlotAllocator(n_slots)
        self.queue: deque[ServeRequest] = deque()
        self.slots: dict[int, _SlotState] = {}
        self.rejections = 0
        self.iterations = 0
        self.decode_tokens = 0  # tokens produced by decode steps (not prefill)
        self.last_logits: Optional[torch.Tensor] = None  # (n_slots, V) of the last decode
        self._token_buf = np.zeros((n_slots,), np.int32)
        self._index_buf = np.zeros((n_slots,), np.int32)

    # -- queue ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active(self) -> int:
        return len(self.slots)

    def submit(self, request: ServeRequest) -> bool:
        """Reject requests whose prompt alone exceeds c_max (paper §1.3)."""
        if len(request.tokens) >= self.c_max:
            self.rejections += 1
            return False
        self.queue.append(request)
        return True

    # -- admission ----------------------------------------------------------------
    def _admit(self) -> None:
        while self.queue and self.alloc.num_free > 0:
            req = self.queue.popleft()
            slot = self.alloc.alloc()
            n = len(req.tokens)
            if self.model.cfg.family in ("hybrid", "ssm"):
                batch = {"tokens": torch.tensor([req.tokens], device=self.device)}
            else:
                pad = bucket_length(n, multiple=self.prompt_bucket, max_len=self.c_max)
                padded = np.zeros((1, pad), np.int64)
                padded[0, :n] = req.tokens
                batch = {
                    "tokens": torch.from_numpy(padded).to(self.device),
                    "last_pos": torch.tensor([n - 1], device=self.device),
                }
            logits, prefill_state = self.model.prefill(self.params, batch)
            self.cache.insert_prefill(slot, prefill_state)
            first = int(sample(logits, req.request_id, self.sampling)[0])
            self.slots[slot] = _SlotState(
                request=req,
                length=n + 1,
                remaining=req.max_new_tokens - 1,
                generated=[first],
            )
            self._token_buf[slot] = first
            self._index_buf[slot] = n

    # -- one iteration ---------------------------------------------------------
    def step(self, seed: Optional[int] = None) -> list[Completion]:
        """Admit + decode one token per active slot. Returns completions."""
        self._admit()
        completions: list[Completion] = []
        done_now = [
            s
            for s, st in self.slots.items()
            if st.remaining <= 0 or st.length >= self.c_max
        ]
        for s in done_now:
            completions.append(self._finish(s))
        if not self.slots:
            return completions

        batch = {
            "tokens": torch.from_numpy(self._token_buf[:, None]).to(self.device),
            "index": torch.from_numpy(self._index_buf).to(self.device),
        }
        logits, _ = self.model.decode_step(self.params, self.cache.state, batch)
        self.last_logits = logits
        next_tokens = sample(
            logits, self.iterations if seed is None else seed, self.sampling
        ).cpu().numpy()
        self.iterations += 1

        for slot, st in list(self.slots.items()):
            tok = int(next_tokens[slot])
            st.generated.append(tok)
            st.length += 1
            st.remaining -= 1
            st.iterations += 1
            self.decode_tokens += 1
            self._token_buf[slot] = tok
            self._index_buf[slot] = st.length - 1
            if (
                st.remaining <= 0
                or st.length >= self.c_max
                or tok == st.request.eos_id
            ):
                completions.append(self._finish(slot))
        return completions

    def _finish(self, slot: int) -> Completion:
        st = self.slots.pop(slot)
        self.alloc.release(slot)
        return Completion(
            request_id=st.request.request_id,
            prompt_tokens=len(st.request.tokens),
            output_tokens=st.generated,
            iterations=st.iterations,
        )

    def run_to_completion(self, max_iters: int = 100_000) -> list[Completion]:
        """Drain queue + slots (examples / tests)."""
        out: list[Completion] = []
        for _ in range(max_iters):
            out.extend(self.step())
            if not self.queue and not self.slots:
                break
        return out
