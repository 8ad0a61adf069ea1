"""musicgen-medium — decoder-only over EnCodec tokens with text-conditioning
cross-attention and 4 codebook heads [arXiv:2306.05284].

The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (codebook embeddings already summed) and the
text-conditioning memory embeddings. The delay-pattern interleaving lives in
the (stubbed) frontend."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,  # full MHA
    head_dim=64,
    d_ff=6144,
    vocab=2048,  # EnCodec codebook size
    activation="gelu",  # plain (non-gated) GELU MLP
    pos_type="rope",
    frontend="embeddings",
    cross_attention=True,
    cross_mem_len=256,  # T5 text-conditioning sequence (stub embeddings)
    n_codebooks=4,
    max_context=65_536,
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
)
