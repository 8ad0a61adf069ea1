"""granite-3-8b — dense GQA (kv=8) [hf:ibm-granite/granite-3.0-8b-base]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab=49_155,
    activation="swiglu",
    pos_type="rope",
    rope_theta=10_000.0,
    max_context=65_536,
    source="hf:ibm-granite/granite-3.0-8b-base",
)
