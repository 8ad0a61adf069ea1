"""llama4-maverick-400b-a17b — MoE 128 experts top-1 + shared expert,
alternating dense/MoE layers, GQA kv=8 [hf:meta-llama/Llama-4-Maverick;
unverified]. Text backbone only."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
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
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_every=2,  # Maverick: MoE every other layer
    moe_d_ff=8192,
    max_context=65_536,
    source="hf:meta-llama/Llama-4-Maverick-17B-128E (unverified)",
)
