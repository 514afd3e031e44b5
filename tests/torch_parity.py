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


def patch_plain_launches(monkeypatch) -> dict[str, int]:
    """Every kernel launch of flash attention, the SSD scan and the grouped
    GEMM replaced by its plain version on the CPU tensors it is given, each
    counted by name in the dict returned; the wrappers take their card's
    branches (the autograd.Functions and their vmap rules) for CPU
    tensors (the grouped GEMM's take them on the CPU as well)."""
    from repro_torch.kernels import batched, needs_grad
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ssd_scan as kssd
    calls = {"fa": 0, "fa_bwd": 0, "state": 0, "scan": 0, "state_bwd": 0,
             "scan_bwd": 0, "gmm": 0, "gmm_dx": 0, "gmm_dw": 0}

    def q_of(x, chunk):
        return min(chunk, x.shape[1])

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    plain_fa = fa.flash_attention

    def fa_on_card(q, k, v, *, causal=True, window=0):
        # the card's branch of the wrapper, on CPU tensors
        if needs_grad(q, k, v) or batched(q, k, v):
            return fa.FlashAttention.apply(q, k, v, causal, window)[0]
        return plain_fa(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fa, "_forward", counted(
        "fa", lambda q, k, v, causal, window, with_lse:
        fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)))
    monkeypatch.setattr(fa, "flash_attention_bwd", counted(
        "fa_bwd", fa.flash_attention_bwd_plain))
    monkeypatch.setattr(fa, "flash_attention", fa_on_card)
    monkeypatch.setattr(moe_gmm, "_forward", counted("gmm", moe_gmm.grouped_matmul_plain))
    monkeypatch.setattr(moe_gmm, "grouped_matmul_dx", counted(
        "gmm_dx", moe_gmm.grouped_matmul_dx_plain))
    monkeypatch.setattr(moe_gmm, "grouped_matmul_dw", counted(
        "gmm_dw", moe_gmm.grouped_matmul_dw_plain))
    monkeypatch.setattr(kssd, "_on_card", lambda x: True)
    monkeypatch.setattr(kssd, "_state_launch", counted(
        "state", lambda x, la, b, chunk, init:
        kssd.chunk_state_plain(x, la, b, q_of(x, chunk), init)))
    monkeypatch.setattr(kssd, "_scan_launch", counted(
        "scan", lambda x, la, b, c, prev, chunk:
        kssd.chunk_scan_plain(x, la, b, c, prev, q_of(x, chunk))))
    monkeypatch.setattr(kssd, "_scan_bwd_launch", counted(
        "scan_bwd", lambda x, la, b, c, prev, dy, gnext, d_total, chunk:
        kssd.chunk_scan_bwd_plain(x, la, b, c, prev, dy, gnext, d_total,
                                  q_of(x, chunk))))
    monkeypatch.setattr(kssd, "_state_bwd_launch", counted(
        "state_bwd", lambda dy, la, c, prev, dfinal, chunk:
        kssd.chunk_state_bwd_plain(dy, la, c, prev, q_of(dy, chunk), dfinal)))
    return calls
