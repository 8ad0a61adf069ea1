"""qwen2-vl-7b — VLM backbone with M-RoPE and GQA kv=4 [arXiv:2409.12191].

The vision frontend (dynamic-resolution ViT) is a STUB per the assignment:
``input_specs()`` provides precomputed patch/text embeddings plus the 3D
M-RoPE position ids (temporal, height, width)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab=152_064,
    activation="swiglu",
    pos_type="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # head_dim/2 = 64 rotary pairs: t/h/w
    frontend="embeddings",
    max_context=65_536,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct",
)
