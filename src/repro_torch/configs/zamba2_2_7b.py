"""zamba2-2.7b — Mamba2 backbone + 2 shared attention blocks applied
round-robin every 6 SSM blocks, with per-invocation LoRA [arXiv:2411.15242].

Simplification recorded in DESIGN.md §5: the shared block attends over the
hidden state only (the published model concatenates the original embedding)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,  # shared attn block is full MHA
    head_dim=80,
    d_ff=10_240,
    vocab=32_000,
    activation="gelu",
    pos_type="rope",
    ssm_state=64,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,  # shared attn after every 6 mamba blocks (9 applications)
    n_shared_attn_blocks=2,
    shared_lora_rank=128,
    max_context=1_048_576,  # sub-quadratic: long-context capable
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)
