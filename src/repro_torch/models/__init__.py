"""Model substrate of the port: config, layers, attention, the Mamba2 SSM
block, the MoE FFN, and the transformer over dense, ssm and moe layers."""
from .config import ArchConfig
from .model import Model, synthetic_batch
from .moe import moe_block
from .transformer import (
    compute_copy, decode_step, forward, init_cache, init_params, loss_fn,
)

__all__ = [
    "ArchConfig", "Model", "synthetic_batch", "compute_copy",
    "decode_step", "forward", "init_cache", "init_params", "loss_fn",
    "moe_block",
]
