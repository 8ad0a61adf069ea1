"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the assignment: blocks carry their own up/down projections
(mLSTM pre-up-projection pf=2; sLSTM post-up-projection MLP pf=4/3),
matching the xLSTM paper's block designs. sLSTM every 8th block (3 of 24)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50_304,
    activation="gelu",
    pos_type="none",
    slstm_every=8,
    max_context=1_048_576,  # recurrent: O(1) state, unbounded context
    source="arXiv:2405.04517 (unverified)",
)
