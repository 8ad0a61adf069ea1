"""qwen3-235b-a22b — the paper's §4.7 case-study model (MoE 128e top-8,
GQA 16:1) [Qwen3 Technical Report]. Used by the Table-5 benchmark's cost
model and available as a full model config."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=12_288,
    vocab=151_936,
    activation="swiglu",
    pos_type="rope",
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    n_shared_experts=0,
    moe_every=1,
    moe_d_ff=1536,
    max_context=65_536,
    source="Qwen3 Technical Report; hf:Qwen/Qwen3-235B-A22B",
)
