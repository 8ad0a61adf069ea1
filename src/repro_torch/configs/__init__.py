"""Architecture registry: ``--arch <id>`` resolves here.

One module per assigned architecture (exact published dims) plus the paper's
own evaluation model (llama3-70b) and the §4.7 case-study model
(qwen3-235b-a22b).
"""

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    SUB_QUADRATIC_FAMILIES,
    TRAIN_4K,
    ArchConfig,
    ShapeCell,
    shape_applicable,
)
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.granite_3_8b import CONFIG as GRANITE_3_8B
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.llama3_70b import CONFIG as LLAMA3_70B
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.qwen3_235b_a22b import CONFIG as QWEN3_235B
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_2_7B

#: The ten assigned architectures (dry-run matrix rows), in assignment order.
ASSIGNED: tuple[ArchConfig, ...] = (
    GEMMA_2B,
    GRANITE_3_8B,
    YI_6B,
    GRANITE_34B,
    LLAMA4_SCOUT,
    LLAMA4_MAVERICK,
    QWEN2_VL_7B,
    MUSICGEN_MEDIUM,
    ZAMBA2_2_7B,
    XLSTM_350M,
)

#: Paper-specific models (evaluation + case study).
PAPER_MODELS: tuple[ArchConfig, ...] = (LLAMA3_70B, QWEN3_235B)

REGISTRY: dict[str, ArchConfig] = {
    cfg.name: cfg for cfg in (*ASSIGNED, *PAPER_MODELS)
}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(REGISTRY))
        raise KeyError(f"unknown arch {name!r}; known: {known}") from None


__all__ = [
    "ArchConfig",
    "ShapeCell",
    "ALL_SHAPES",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "SUB_QUADRATIC_FAMILIES",
    "shape_applicable",
    "ASSIGNED",
    "PAPER_MODELS",
    "REGISTRY",
    "get_config",
]
