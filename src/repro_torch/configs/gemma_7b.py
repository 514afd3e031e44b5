"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim=256, 16 heads/16 kv."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    layer_types=("attn",) * 28,
    mlp_act="gelu", embed_scale=True, tie_embeddings=True,
    rope_theta=10_000.0, rope_theta_global=10_000.0,
)

SMOKE = ArchConfig(
    name="gemma-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=256,
    layer_types=("attn",) * 2,
    mlp_act="gelu", embed_scale=True, tie_embeddings=True,
)
