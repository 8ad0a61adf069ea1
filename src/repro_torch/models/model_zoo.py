"""Model facade (counterpart of ``repro.models.model_zoo``): the dense, MoE
and hybrid families.

``Model(cfg, kv_dtype=..., moe_group=...)`` exposes ``init`` / ``forward``
/ ``prefill`` / ``decode_step`` / ``init_cache``, the slot axis of every
decode-state leaf (``cache_batch_axes``) and the parameter counts
(``active_param_count`` counts an MoE layer's top-k experts only);
:func:`get_model` builds one by config name. The dense and MoE families
(yi-6b, granite-3-8b, granite-34b, gemma-2b, llama3-70b; qwen3-235b-a22b,
llama4-scout, llama4-maverick) run ``transformer``, the hybrid family
(zamba2) ``hybrid``. Any other family raises ``NotImplementedError``: the
reference's VLM, audio and xLSTM stacks are later slices of the port
(ROADMAP.md, queue A, item A11).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import hybrid, transformer
from repro_torch.models.params import init_params, param_bytes, param_count

KV_DTYPES = ("bf16", "int8")


@dataclasses.dataclass
class Model:
    """``kv_dtype="int8"`` (dense and MoE families) keeps the KV cache as
    int8 with one f16 scale per (position, head), as the reference's
    ``Model`` does. ``moe_group`` is the tokens an MoE group takes in
    ``forward`` and ``prefill`` (decode routes each sequence alone)."""

    cfg: ArchConfig
    kv_dtype: str = "bf16"
    moe_group: int = 512

    def __post_init__(self) -> None:
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in {KV_DTYPES}")
        if self.cfg.family == "hybrid":
            if self.kv_dtype != "bf16":
                raise NotImplementedError("the hybrid family keeps a bf16 KV cache")
            self._mod, self._kw = hybrid, {}
            self.defs = hybrid.hybrid_defs(self.cfg)
        else:
            self._mod, self._kw = transformer, {"kv_dtype": self.kv_dtype}
            self.defs = transformer.transformer_defs(self.cfg)  # raises for the rest

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int = 0, *, device: str | torch.device = "cuda") -> dict:
        return init_params(self.defs, seed, device=device)

    def param_count(self) -> int:
        return param_count(self.defs)

    def active_param_count(self) -> int:
        """Parameters one token uses: an MoE layer's top-k experts, not all
        of them."""
        cfg = self.cfg
        if not cfg.is_moe:
            return self.param_count()
        mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        per_expert = mats * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
        inactive = cfg.n_layers // cfg.moe_every * (cfg.n_experts - cfg.top_k) * per_expert
        return self.param_count() - inactive

    def param_bytes(self) -> int:
        return param_bytes(self.defs)

    # -- apply ----------------------------------------------------------------
    def _group(self) -> dict:
        return {"moe_group": self.moe_group} if self.cfg.is_moe else {}

    def forward(self, params: dict, batch: dict):
        return self._mod.forward(params, self.cfg, batch, **self._group())

    def prefill(self, params: dict, batch: dict):
        return self._mod.prefill(params, self.cfg, batch, **self._kw, **self._group())

    def decode_step(self, params: dict, caches: Any, batch: dict):
        return self._mod.decode_step(params, self.cfg, caches, batch, **self._kw)

    # -- decode state -----------------------------------------------------------
    def init_cache(
        self,
        cell: ShapeCell,
        *,
        device: str | torch.device = "cuda",
        act_dtype: torch.dtype = torch.bfloat16,
    ) -> Any:
        """Zero decode state for a decode cell (``global_batch`` slots of
        ``seq_len`` positions) of a model whose activations are
        ``act_dtype``, laid out by the family's module
        (``transformer.init_cache``, ``hybrid.init_cache``)."""
        return self._mod.init_cache(
            self.cfg, cell.global_batch, cell.seq_len, act_dtype=act_dtype,
            device=resolve_device(device), **self._kw,
        )

    def cache_batch_axes(self) -> Any:
        """The slot axis of each decode-state leaf, as a tree shaped like
        :meth:`init_cache`'s (the reference's ``SlotKVCache.batch_axes``)."""
        return self._mod.cache_batch_axes(**self._kw)


@functools.lru_cache(maxsize=None)
def get_model(name: str) -> Model:
    """``Model`` of the named config at its published widths."""
    return Model(get_config(name))
