"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts
top-4 (d_ff 1408 each) + 4 shared experts fused as one 5632-wide shared
expert with a sigmoid token gate."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=5632,                      # fused shared-expert width (4 x 1408)
    vocab_size=151936,
    layer_types=("moe",) * 24,
    n_experts=60, n_shared_experts=4, top_k=4, moe_d_ff=1408,
    router_renorm=False, mlp_act="silu", tie_embeddings=False,
    rope_theta=1_000_000.0, rope_theta_global=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=256,
    layer_types=("moe",) * 2,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32,
    router_renorm=False, mlp_act="silu", tie_embeddings=False,
)
