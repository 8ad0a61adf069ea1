"""yi-6b — llama-arch dense GQA (kv=4) [arXiv:2403.04652; hf:01-ai/Yi-6B]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab=64_000,
    activation="swiglu",
    pos_type="rope",
    rope_theta=5_000_000.0,
    max_context=65_536,
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)
