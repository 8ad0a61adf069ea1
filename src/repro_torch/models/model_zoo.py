"""Model facade (counterpart of ``repro.models.model_zoo``): every family
the reference ships.

``Model(cfg, kv_dtype=..., moe_group=..., remat=...)`` exposes ``init`` /
``forward`` / ``loss`` / ``prefill`` / ``decode_step`` / ``init_cache``,
the slot axis of every decode-state leaf (``cache_batch_axes``), the
inputs of a shape cell as meta tensors (``input_specs``) and the parameter
counts (``active_param_count`` counts an MoE layer's top-k experts only);
:func:`get_model` builds one by config name. The dense, MoE, vlm and audio
families (yi-6b, granite-3-8b, granite-34b, gemma-2b, llama3-70b;
qwen3-235b-a22b, llama4-scout, llama4-maverick; qwen2-vl-7b;
musicgen-medium) run ``transformer``, the hybrid (zamba2) ``hybrid`` and
the ssm family (xlstm-350m) ``xlstm_model``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import hybrid, transformer, xlstm_model
from repro_torch.models.params import init_params, param_bytes, param_count
from repro_torch.models.remat import REMAT_MODES

KV_DTYPES = ("bf16", "int8")
#: Families whose decode state is a tree of recurrent states (and, for the
#: hybrid, a bf16 KV cache): their module and parameter declarations. The
#: rest run ``transformer``.
_STATE_FAMILIES = {"hybrid": (hybrid, hybrid.hybrid_defs),
                   "ssm": (xlstm_model, xlstm_model.xlstm_defs)}


@dataclasses.dataclass
class Model:
    """``kv_dtype="int8"`` (dense and MoE families) keeps the KV cache as
    int8 with one f16 scale per (position, head), as the reference's
    ``Model`` does. ``moe_group`` is the tokens an MoE group takes in
    ``forward``, ``loss`` and ``prefill`` (decode routes each sequence
    alone). ``remat`` ("none", "full", "dots") is the per-layer (hybrid
    and xLSTM: per-group) rematerialization of ``loss``
    (:mod:`repro_torch.models.remat`); ``forward`` runs without it, as the
    reference's does."""

    cfg: ArchConfig
    kv_dtype: str = "bf16"
    moe_group: int = 512
    remat: str = "none"

    def __post_init__(self) -> None:
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat {self.remat!r} not in {REMAT_MODES}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in {KV_DTYPES}")
        family = self.cfg.family
        if family in _STATE_FAMILIES:
            if self.kv_dtype != "bf16":
                raise NotImplementedError(f"the {family} family keeps no int8 KV cache")
            self._mod, defs = _STATE_FAMILIES[family]
            self._kw, self.defs = {}, defs(self.cfg)
        else:
            self._mod, self._kw = transformer, {"kv_dtype": self.kv_dtype}
            self.defs = transformer.transformer_defs(self.cfg)  # raises for unknown families

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

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Training loss → (scalar, metrics): the family's ``loss_fn``
        (cross-entropy of the logits against ``batch["labels"]``; for MoE
        plus 0.01 times the routers' aux loss)."""
        return self._mod.loss_fn(params, self.cfg, batch, remat=self.remat, **self._group())

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
        (``transformer.init_cache``, ``hybrid.init_cache``,
        ``xlstm_model.init_cache``)."""
        return self._mod.init_cache(
            self.cfg, cell.global_batch, cell.seq_len, act_dtype=act_dtype,
            device=resolve_device(device), **self._kw,
        )

    def cache_batch_axes(self) -> Any:
        """The slot axis of each decode-state leaf, as a tree shaped like
        :meth:`init_cache`'s (the reference's ``SlotKVCache.batch_axes``)."""
        return self._mod.cache_batch_axes(self.cfg, **self._kw)

    def input_specs(self, cell: ShapeCell) -> dict:
        """The model's inputs for one shape cell, as tensors on the meta
        device with the reference's shapes and dtypes (its ``input_specs``
        without the logical axes): ``tokens`` or ``embeds``, M-RoPE's
        ``positions``, cross-attention's ``memory``, and ``labels`` (train)
        or a scalar ``index`` (decode)."""
        cfg = self.cfg
        b = cell.global_batch
        n = 1 if cell.kind == "decode" else cell.seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        specs = {}
        if cfg.frontend == "tokens":
            specs["tokens"] = meta((b, n), torch.int32)
        else:
            specs["embeds"] = meta((b, n, cfg.d_model), torch.bfloat16)
        if cfg.pos_type == "mrope":
            specs["positions"] = meta((3, b, n), torch.int32)
        if cfg.cross_attention:
            specs["memory"] = meta((b, cfg.cross_mem_len, cfg.d_model), torch.bfloat16)
        if cell.kind == "train":
            labels = (b, n, cfg.n_codebooks) if cfg.n_codebooks > 0 else (b, n)
            specs["labels"] = meta(labels, torch.int32)
        elif cell.kind == "decode":
            specs["index"] = meta((), torch.int32)
        return specs


@functools.lru_cache(maxsize=None)
def get_model(name: str) -> Model:
    """``Model`` of the named config at its published widths."""
    return Model(get_config(name))
