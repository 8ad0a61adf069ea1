"""Token sampling for the serving engine (counterpart of
``repro.serving.sampler``).

Greedy decoding is exact. Temperature sampling draws from a
``torch.Generator`` seeded with the integer the reference feeds
``jax.random.key``; the draws are not the reference's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → no top-k filter


def sample(
    logits: torch.Tensor,  # (B, V)
    seed: int,
    params: SamplingParams = SamplingParams(),
) -> torch.Tensor:
    """Returns (B,) int32 token ids."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits.float() / params.temperature
    if params.top_k > 0:
        kth = torch.topk(lf, params.top_k, dim=-1).values[..., -1:]
        lf = lf.masked_fill(lf < kth, float("-inf"))
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
