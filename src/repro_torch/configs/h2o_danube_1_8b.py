"""H2O-Danube-1.8B [arXiv:2401.16818] — llama+mistral mix, sliding-window
attention (4096 window) on all layers."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    layer_types=("swa",) * 24, window=4096,
    mlp_act="silu", tie_embeddings=False,
    rope_theta=10_000.0, rope_theta_global=10_000.0,
)

SMOKE = ArchConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_types=("swa",) * 2, window=16,
    mlp_act="silu", tie_embeddings=False,
)
