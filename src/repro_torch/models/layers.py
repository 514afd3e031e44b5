"""Shared neural layers: norms, rotary embeddings, gated MLPs.

Port of ``repro.models.layers``.  Functions on tensors; parameters are
plain dicts.  Parameters are stored in ``param_dtype`` and cast to
``compute_dtype`` at the point of use, where the reference casts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def as_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (config fields are names)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def cast(x: torch.Tensor, dtype: str | torch.dtype) -> torch.Tensor:
    dtype = as_dtype(dtype)
    return x.to(dtype) if x.dtype != dtype else x


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype: a constant is rounded to the
    tensor's dtype before it multiplies, as a JAX weak-typed scalar is
    (a Python float would multiply at full precision)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``(1 + scale)`` convention, fp32 math, x's dtype out."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies for half the head dim (fp32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves (x[..., :d/2], x[..., d/2:]), not interleaved
    pairs, in fp32.  x: (B, S, H, D); positions: (B, S) integers."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)               # (D/2,)
    angles = positions.float()[..., None] * inv_freq              # (B,S,D/2)
    cos = torch.cos(angles)[..., None, :]                         # (B,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _act(name: str):
    if name in ("silu", "swiglu"):
        return F.silu
    if name in ("gelu", "geglu", "gelu_nogate"):
        # jax.nn.gelu(approximate=True) is the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def mlp(x: torch.Tensor, p: dict[str, torch.Tensor], act: str,
        compute_dtype: str | torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain two-layer MLP."""
    fn = _act(act)
    cd = as_dtype(compute_dtype)
    xc = cast(x, cd)
    if act == "gelu_nogate":
        h = fn(xc @ cast(p["wi"], cd) + cast(p["bi"], cd))
        return h @ cast(p["wo"], cd) + cast(p["bo"], cd)
    gate = xc @ cast(p["wi_gate"], cd)
    up = xc @ cast(p["wi_up"], cd)
    return (fn(gate) * up) @ cast(p["wo"], cd)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, scale: bool,
                 compute_dtype: str | torch.dtype = torch.bfloat16
                 ) -> torch.Tensor:
    x = cast(table[tokens], compute_dtype)
    if scale:
        # sqrt(d) rounded to the compute dtype first: 34.0, not 33.94, in
        # bf16 at d = 1152 (reference layers.py:120)
        x = x * scalar(table.shape[-1] ** 0.5, x)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor,
            compute_dtype: str | torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Logits, in the compute dtype."""
    return cast(x, compute_dtype) @ cast(table, compute_dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(generator: torch.Generator, shape: tuple[int, ...],
                dtype: str | torch.dtype, stddev: float = 0.02) -> torch.Tensor:
    """N(0, stddev²) drawn in fp32 on the generator's device."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * stddev).to(as_dtype(dtype))
