"""Hymba-1.5B [arXiv:2411.13676] — hybrid heads: parallel attention +
mamba(SSD) branches in every layer; full attention on layers {0, mid,
last}, SWA elsewhere; 25 query heads (head_dim 64), kv=5, ssm_state=16.
As the reference reads it: no meta tokens, no cross-layer KV sharing."""
from repro_torch.models.config import ArchConfig

_TYPES = tuple(
    "hyb_g" if i in (0, 15, 31) else "hyb_l" for i in range(32)
)

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    layer_types=_TYPES, window=1024,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ssm_conv=4, ssm_chunk=256,
    mlp_act="silu", tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_types=("hyb_g", "hyb_l", "hyb_g"), window=16,
    ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
    ssm_conv=4, ssm_chunk=16,
    mlp_act="silu", tie_embeddings=True,
)
