"""Model facade (counterpart of ``repro.models.model_zoo``), dense family.

``Model(cfg)`` exposes ``init`` / ``forward`` / ``prefill`` /
``decode_step`` / ``init_cache``. Any other family raises
``NotImplementedError``: the reference's MoE, VLM, audio, hybrid and SSM
stacks are later slices of the port (ROADMAP.md, queue A, item A9).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.params import init_params, param_bytes, param_count

#: dtype of the KV cache, whatever the parameters' dtype (the reference
#: derives its cache from the bf16 abstract parameters).
KV_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Model:
    """The KV cache is bf16 (the reference's default ``kv_dtype``); its
    int8 cache needs the int8 paged kernel, not ported yet."""

    cfg: ArchConfig

    def __post_init__(self) -> None:
        self.defs = transformer.transformer_defs(self.cfg)

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int = 0, *, device: str | torch.device = "cuda") -> dict:
        return init_params(self.defs, seed, device=device)

    def param_count(self) -> int:
        return param_count(self.defs)

    def param_bytes(self) -> int:
        return param_bytes(self.defs)

    # -- apply ----------------------------------------------------------------
    def forward(self, params: dict, batch: dict):
        return transformer.forward(params, self.cfg, batch)

    def prefill(self, params: dict, batch: dict):
        return transformer.prefill(params, self.cfg, batch)

    def decode_step(self, params: dict, caches: tuple, batch: dict):
        return transformer.decode_step(params, self.cfg, caches, batch)

    # -- decode state -----------------------------------------------------------
    def init_cache(
        self, cell: ShapeCell, *, device: str | torch.device = "cuda"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero (k, v) caches for a decode cell, each
        (n_layers, global_batch, seq_len, K, head_dim) in bf16."""
        cfg = self.cfg
        shape = (cfg.n_layers, cell.global_batch, cell.seq_len, cfg.n_kv_heads, cfg.head_dim)
        dev = resolve_device(device)
        return (
            torch.zeros(shape, dtype=KV_DTYPE, device=dev),
            torch.zeros(shape, dtype=KV_DTYPE, device=dev),
        )
