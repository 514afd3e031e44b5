"""InternVL2-26B — InternViT-6B + InternLM2-20B backbone [arXiv:2404.16821].

The transformer BACKBONE only (48L, d=6144, 48H GQA kv=8, ff=16384,
vocab=92553); the vision frontend is a stub providing precomputed patch
embeddings (input_mode="mixed")."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    layer_types=("attn",) * 48,
    mlp_act="silu", rope_theta=1_000_000.0, rope_theta_global=1_000_000.0,
    tie_embeddings=False, input_mode="mixed", n_patches=256,
)

SMOKE = ArchConfig(
    name="internvl2-26b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
    layer_types=("attn",) * 2,
    mlp_act="silu", tie_embeddings=False, input_mode="mixed", n_patches=4,
)
