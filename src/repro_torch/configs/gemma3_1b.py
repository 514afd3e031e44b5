"""Gemma3-1B [hf:google/gemma-3-1b-pt] — 5:1 local(512):global layer
pattern, MQA (kv=1), head_dim=256, 262k vocab, qk-norm, dual rope theta
(local 10k / global 1M)."""
from repro_torch.models.config import ArchConfig

# 26 layers: (5 local + 1 global) x 4 + 2 local
_PATTERN = (("swa",) * 5 + ("attn",)) * 4 + ("swa",) * 2

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    layer_types=_PATTERN, window=512,
    mlp_act="gelu", embed_scale=True, tie_embeddings=True, qk_norm=True,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
)

SMOKE = ArchConfig(
    name="gemma3-1b-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=256,
    layer_types=("swa",) * 5 + ("attn",), window=16,
    mlp_act="gelu", embed_scale=True, tie_embeddings=True, qk_norm=True,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
)
