"""gemma-2b — dense, GeGLU, MQA (kv=1), head_dim 256 [arXiv:2403.08295; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab=256_000,
    activation="geglu",
    pos_type="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    max_context=65_536,
    source="arXiv:2403.08295; hf:google/gemma-2b",
)
