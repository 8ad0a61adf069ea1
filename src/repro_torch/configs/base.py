"""Architecture config schema + input-shape cells for the dry-run matrix."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One selectable ``--arch`` configuration (exact published dims)."""

    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # positional encoding
    pos_type: str = "rope"  # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()  # head_dim/2 split for M-RoPE

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1  # MoE on every k-th layer (others dense)
    moe_d_ff: int = 0  # expert hidden size (0 → d_ff)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0  # zamba2: shared attn after every k ssm blocks
    n_shared_attn_blocks: int = 0  # zamba2: number of distinct shared blocks
    shared_lora_rank: int = 0  # zamba2: per-invocation LoRA rank
    slstm_every: int = 0  # xlstm: sLSTM at every k-th block

    # modality frontend
    frontend: str = "tokens"  # tokens | embeddings (vlm/audio stubs)
    cross_attention: bool = False  # musicgen text conditioning
    cross_mem_len: int = 256
    n_codebooks: int = 0  # musicgen multi-codebook output heads

    # serving / provenance
    max_context: int = 65_536
    source: str = ""

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(1, self.n_kv_heads):
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}"
            )

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding to a TP-friendly multiple of 256.

        Embedding tables and logits use the padded size internally; the loss
        masks the padded tail, labels never reference it. Only granite-3-8b
        (49155) actually pads among the assigned archs.
        """
        if self.vocab % 256 == 0 or self.vocab % 16 == 0:
            return self.vocab
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same family/wiring, tiny dims."""
        return dataclasses.replace(
            self,
            name=f"{self.name}-reduced",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            moe_d_ff=128 if self.is_moe else 0,
            vocab=512,
            n_experts=min(4, self.n_experts) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            ssm_state=min(16, self.ssm_state) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            n_shared_attn_blocks=min(2, self.n_shared_attn_blocks),
            shared_lora_rank=4 if self.shared_lora_rank else 0,
            slstm_every=2 if self.slstm_every else 0,
            cross_mem_len=16 if self.cross_attention else 256,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            max_context=512,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell of the dry-run matrix."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def sub_quadratic_only(self) -> bool:
        return self.seq_len >= 262_144


TRAIN_4K = ShapeCell("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524_288, 1)

ALL_SHAPES: tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

#: Families with sub-quadratic sequence mixing (run long_500k).
SUB_QUADRATIC_FAMILIES = {"hybrid", "ssm"}


def shape_applicable(cfg: ArchConfig, shape: ShapeCell) -> bool:
    """Is this (arch x shape) cell live, per the assignment's skip rule?"""
    if shape.sub_quadratic_only and cfg.family not in SUB_QUADRATIC_FAMILIES:
        return False
    return True
