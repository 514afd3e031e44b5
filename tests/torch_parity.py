"""Helpers shared by the port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both frameworks;
weights come from the JAX ``init_params`` through ``jax.device_get`` and
``repro_torch.bridge``.  Neither framework's generator is seeded to
expect equal numbers.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)   # the suite runs under 6 xdist workers

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(x: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a CPU tensor of ``dtype``
    (both round float32 to bf16 to nearest-even)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
        return jnp.asarray(x.astype(np.int32)), torch.from_numpy(x.astype(np.int64))
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def np32(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, tol: float) -> None:
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


def randn(seed: int, *shape: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)
