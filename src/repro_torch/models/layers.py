"""Shared neural layers: norms, rotary embeddings, gated MLPs.

Port of ``repro.models.layers``.  Functions on tensors; parameters are
plain dicts.  Parameters are stored in ``param_dtype`` and cast to
``compute_dtype`` at the point of use, where the reference casts them.

Under an ambient mesh with a ``model`` axis of M > 1 ranks (tensor
parallelism, :mod:`repro_torch.distributed.context`), the parameters are
this rank's stored shards: :func:`mlp` computes its block of the hidden
units (Megatron's f before, g after) and :func:`embed_tokens` looks up the
tokens of its rows (zeros for the others, then g) or, for a table whose d
columns are sharded, gathers the looked-up columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd


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
        compute_dtype: str | torch.dtype = torch.bfloat16, *, d_ff: int = 0,
        seq: bool = False) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain two-layer MLP.  With M > 1 ``model``
    ranks each computes its block of the ``d_ff`` hidden units between
    :func:`~repro_torch.distributed.context.enter` and ``leave`` (``seq``:
    x is this rank's sequence shard, and so is the output).  ``d_ff`` is
    the whole leaf's hidden size; with one rank the leaves are used whole
    and it may be left 0."""
    fn = _act(act)
    cd = as_dtype(compute_dtype)
    m = mesh_ctx.axis_size("model")
    if m > 1 and d_ff < 1:
        raise ValueError(f"mlp over {m} model ranks needs the whole hidden "
                         f"size d_ff, got {d_ff}")
    hid = shd.hidden_view(d_ff, m, mesh_ctx.model_rank())

    def w(key, dim):
        return cast(mesh_ctx.model_view(p[key], dim, hid, d_ff), cd)

    xc = cast(mesh_ctx.enter(x, seq), cd)
    if act == "gelu_nogate":
        h = fn(xc @ w("wi", -1) + w("bi", -1))
        # bo acts on the stream: on a sequence shard, through f
        bo = mesh_ctx.model_copy(p["bo"]) if seq else p["bo"]
        return mesh_ctx.leave(h @ w("wo", -2), seq) + cast(bo, cd)
    gate = xc @ w("wi_gate", -1)
    up = xc @ w("wi_up", -1)
    return mesh_ctx.leave((fn(gate) * up) @ w("wo", -2), seq)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, scale: bool,
                 compute_dtype: str | torch.dtype = torch.bfloat16,
                 layout: str = "whole") -> torch.Tensor:
    """The rows of ``tokens``, in the compute dtype (times sqrt(d) with
    ``scale``).  ``layout`` is how this ``model`` rank holds the table
    (:func:`repro_torch.distributed.sharding.vocab_view`): ``"whole"``,
    ``"vocab"`` (its block of rows: it looks up the tokens in its range,
    zeros for the others, then g) or ``"d"`` (its block of d columns: the
    looked-up columns are gathered)."""
    if layout == "vocab":
        rows = table.shape[0]
        local = tokens - mesh_ctx.model_rank() * rows
        mine = (local >= 0) & (local < rows)
        x = cast(table[local.clamp(0, rows - 1)], compute_dtype)
        x = torch.where(mine[..., None], x, 0.0)
        return mesh_ctx.model_sum(_scaled(x, scale, table.shape[-1]))
    if layout == "d":
        d = table.shape[-1] * mesh_ctx.axis_size("model")
        x = _scaled(cast(table[tokens], compute_dtype), scale, d)
        return mesh_ctx.model_gather(x, -1, summed=False)
    return _scaled(cast(table[tokens], compute_dtype), scale, table.shape[-1])


def _scaled(x: torch.Tensor, scale: bool, d: int) -> torch.Tensor:
    if scale:
        # sqrt(d) rounded to the compute dtype first: 34.0, not 33.94, in
        # bf16 at d = 1152 (reference layers.py:120)
        x = x * scalar(d ** 0.5, x)
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
