"""DeepSeek-7B [arXiv:2401.02954] — llama-arch, MHA (kv=32)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400,
    layer_types=("attn",) * 30,
    mlp_act="silu", tie_embeddings=False,
    rope_theta=10_000.0, rope_theta_global=10_000.0,
)

SMOKE = ArchConfig(
    name="deepseek-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_types=("attn",) * 2,
    mlp_act="silu", tie_embeddings=False,
)
