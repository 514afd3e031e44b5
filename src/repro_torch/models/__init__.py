"""Model substrate of the port: config, layers, attention, the Mamba2 SSM
block, the MoE FFN, and the transformer over every layer kind and input
mode of the reference."""
from .config import SHAPES, ArchConfig, ShapeConfig, cell_applicable
from .model import Model, cache_specs, input_specs, synthetic_batch
from .moe import moe_block
from .transformer import (
    compute_copy, decode_step, forward, init_cache, init_params,
    init_serving_params, loss_fn,
)

__all__ = [
    "SHAPES", "ArchConfig", "ShapeConfig", "cell_applicable", "Model",
    "cache_specs", "input_specs", "synthetic_batch", "compute_copy",
    "decode_step", "forward", "init_cache", "init_params",
    "init_serving_params", "loss_fn", "moe_block",
]
