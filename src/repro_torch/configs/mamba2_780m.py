"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD (state-space
duality), d_state=128, head_dim=64, expand=2."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    layer_types=("ssm",) * 48,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=256,
    layer_types=("ssm",) * 2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
    ssm_conv=4, ssm_chunk=16,
    tie_embeddings=True,
)
