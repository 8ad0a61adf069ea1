"""granite-34b — llama-arch code model, MQA (kv=1), 88L [arXiv:2405.04324]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab=49_152,
    activation="gelu",  # GPTBigCode-style plain MLP (hf config)
    pos_type="rope",
    rope_theta=10_000.0,
    max_context=65_536,
    source="arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base",
)
