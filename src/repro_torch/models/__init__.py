"""Model substrate of the port: config, layers, attention, the Mamba2 SSM
block, and the transformer over dense and ssm layers."""
from .config import ArchConfig
from .model import Model, synthetic_batch
from .transformer import (
    compute_copy, decode_step, forward, init_cache, init_params,
)

__all__ = [
    "ArchConfig", "Model", "synthetic_batch", "compute_copy",
    "decode_step", "forward", "init_cache", "init_params",
]
