"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only (bidirectional),
LayerNorm + non-gated GELU FFN, 504-class target vocabulary.  The audio
frontend (conv feature extractor) is a stub: input_specs provides
precomputed frame embeddings."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    layer_types=("enc",) * 48,
    mlp_act="gelu_nogate", causal=False, tie_embeddings=False,
    input_mode="embeds",
)

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64,
    layer_types=("enc",) * 2,
    mlp_act="gelu_nogate", causal=False, tie_embeddings=False,
    input_mode="embeds",
)
