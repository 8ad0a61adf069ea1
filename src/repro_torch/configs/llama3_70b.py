"""llama3-70b — the paper's own evaluation model (§4.1) [arXiv:2407.21783]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab=128_256,
    activation="swiglu",
    pos_type="rope",
    rope_theta=500_000.0,
    max_context=65_536,
    source="arXiv:2407.21783; hf:meta-llama/Meta-Llama-3-70B-Instruct",
)
