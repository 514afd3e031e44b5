"""OLMoE-1B-7B [arXiv:2409.02060] — 64 routed experts top-8, qk-norm,
no shared experts."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    layer_types=("moe",) * 16,
    n_experts=64, n_shared_experts=0, top_k=8, moe_d_ff=1024,
    router_renorm=False, mlp_act="silu", qk_norm=True, tie_embeddings=False,
    rope_theta=10_000.0, rope_theta_global=10_000.0,
)

SMOKE = ArchConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256,
    layer_types=("moe",) * 2,
    n_experts=8, n_shared_experts=0, top_k=2, moe_d_ff=32,
    router_renorm=False, mlp_act="silu", qk_norm=True, tie_embeddings=False,
)
