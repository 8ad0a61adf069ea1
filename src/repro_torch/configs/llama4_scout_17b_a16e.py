"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, GQA kv=8
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Text backbone only
(early-fusion multimodality out of scope per LM-family shape assignment)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    activation="swiglu",
    pos_type="rope",
    rope_theta=500_000.0,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_every=1,  # Scout: MoE on every layer
    moe_d_ff=8192,
    max_context=65_536,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
)
