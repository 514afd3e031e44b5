"""Model assembly: embeddings → layer segments → head (dense subset).

Port of ``repro.models.transformer`` for the kinds ``attn`` and ``swa``
with token inputs.  Consecutive layers of one kind form a *segment* whose
parameters are stacked on a leading layer axis, the reference's layout; a
Python loop over that axis replaces ``lax.scan``.  ``loss_fn``, remat,
MoE, SSM, hybrid and encoder layers are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from .attention import attn_block
from .config import ArchConfig
from .layers import (
    as_dtype, cast, embed_tokens, mlp, normal_init, rms_norm, unembed,
)

DENSE_KINDS = ("attn", "swa")

#: leaves the reference casts to the compute dtype at every use (matmul
#: weights and the embedding table); norm scales stay in param dtype
_CAST_ON_USE = ("embed", "lm_head", "wq", "wk", "wv", "wo", "wi_gate",
                "wi_up")


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.layer_types) - set(DENSE_KINDS)
    if kinds or cfg.input_mode != "tokens" or cfg.mlp_act == "gelu_nogate":
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} / input mode "
            f"{cfg.input_mode!r} / MLP {cfg.mlp_act!r} not yet ported")


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def _init_segment(gen: torch.Generator, cfg: ArchConfig, n: int
                  ) -> dict[str, Any]:
    """Parameters of ``n`` dense layers, stacked on a leading axis."""
    d, ad, kd, ff = cfg.d_model, cfg.attn_dim, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff
    dt = as_dtype(cfg.param_dtype)

    def zeros(*shape):
        return torch.zeros((n, *shape), dtype=dt, device=gen.device)

    attn = {
        "wq": normal_init(gen, (n, d, ad), dt),
        "wk": normal_init(gen, (n, d, kd), dt),
        "wv": normal_init(gen, (n, d, kd), dt),
        "wo": normal_init(gen, (n, ad, d), dt),
    }
    if cfg.qk_norm:
        attn["q_norm"] = zeros(cfg.head_dim)
        attn["k_norm"] = zeros(cfg.head_dim)
    mlp_p = {"wi_gate": normal_init(gen, (n, d, ff), dt),
             "wi_up": normal_init(gen, (n, d, ff), dt),
             "wo": normal_init(gen, (n, ff, d), dt)}
    return {"norm1": zeros(d), "norm2": zeros(d), "attn": attn, "mlp": mlp_p}


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict[str, Any]:
    """Random parameters on the generator's device, in the reference's
    layout (the values differ: jax.random cannot be reproduced)."""
    _check_supported(cfg)
    dt = as_dtype(cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": normal_init(generator, (cfg.padded_vocab, cfg.d_model), dt),
        "segments": [_init_segment(generator, cfg, count)
                     for _, count in cfg.segments()],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                  device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(
            generator, (cfg.d_model, cfg.padded_vocab), dt)
    return params


def compute_copy(cfg: ArchConfig, params: dict[str, Any]) -> dict[str, Any]:
    """The parameters with every leaf that the reference casts at each use
    held in the compute dtype already.  A cast gives the same values once
    as at every use, so serving from this copy changes no result and saves
    re-casting the weights on every step."""
    def walk(node: Any, key: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        return cast(node, cfg.compute_dtype) if key in _CAST_ON_USE else node

    return walk(params, "")


def _layer(seg: Any, i: int) -> Any:
    """Layer ``i`` of a stacked segment (views, no copies)."""
    if isinstance(seg, dict):
        return {k: _layer(v, i) for k, v in seg.items()}
    return seg[i]


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def layer_body(cfg: ArchConfig, kind: str, x: torch.Tensor,
               lp: dict[str, Any], positions: torch.Tensor,
               cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """One dense layer: returns (x, new_cache)."""
    eps = cfg.norm_eps
    h = rms_norm(x, lp["norm1"], eps)
    a_out, new_cache = attn_block(
        h, lp["attn"],
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, kind=kind, window=cfg.window,
        positions=positions,
        rope_theta=cfg.rope_theta_global if kind == "attn" else cfg.rope_theta,
        q_chunk=cfg.attn_q_chunk, softcap=cfg.logit_softcap,
        qk_norm=cfg.qk_norm, norm_eps=eps, compute_dtype=cfg.compute_dtype,
        use_kernels=cfg.use_kernels, cache=cache)
    x = x + a_out.to(x.dtype)
    h2 = rms_norm(x, lp["norm2"], eps)
    f_out = mlp(h2, lp["mlp"], cfg.mlp_act, cfg.compute_dtype)
    return x + f_out.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def backbone(cfg: ArchConfig, params: dict[str, Any],
             batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Embeddings → layers → final norm.  Returns x (B,S,d)."""
    _check_supported(cfg)
    x = embed_tokens(batch["tokens"], params["embed"], cfg.embed_scale,
                     cfg.compute_dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for (kind, count), seg in zip(cfg.segments(), params["segments"]):
        for i in range(count):
            x, _ = layer_body(cfg, kind, x, _layer(seg, i), positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(cfg: ArchConfig, params: dict[str, Any]) -> torch.Tensor:
    return (params["lm_head"] if not cfg.tie_embeddings
            else params["embed"].T)


def forward(cfg: ArchConfig, params: dict[str, Any],
            batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Full forward pass → logits (B,S,V), sliced to ``vocab_size``.
    (The reference also returns MoE aux losses; dense layers have none.)"""
    x = backbone(cfg, params, batch)
    logits = unembed(x, _head(cfg, params), cfg.compute_dtype)
    return logits[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: str | torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> dict[str, Any]:
    """Per-segment stacked KV caches; swa segments hold a ring of
    ``min(window, max_len)`` entries.  ``pos`` is one Python int shared by
    every slot, as in the reference."""
    _check_supported(cfg)
    segments = []
    for kind, count in cfg.segments():
        t = min(cfg.window, max_len) if kind == "swa" and cfg.window else max_len
        shape = (count, batch, t, cfg.n_kv_heads, cfg.head_dim)
        segments.append({
            "k": torch.zeros(shape, dtype=as_dtype(dtype), device=device),
            "v": torch.zeros(shape, dtype=as_dtype(dtype), device=device)})
    return {"pos": 0, "segments": segments}


def decode_step(cfg: ArchConfig, params: dict[str, Any], cache: dict[str, Any],
                token: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
    """One autoregressive step → (logits (B,V), cache).  token: (B, 1).

    The cache tensors are updated in place; the returned cache holds the
    same tensors and ``pos + 1``."""
    if not cfg.has_decode():
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    pos = cache["pos"]
    b = token.shape[0]
    x = embed_tokens(token, params["embed"], cfg.embed_scale, cfg.compute_dtype)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for (kind, count), seg, seg_cache in zip(
            cfg.segments(), params["segments"], cache["segments"]):
        for i in range(count):
            lc = {"k": seg_cache["k"][i], "v": seg_cache["v"][i], "pos": pos}
            x, _ = layer_body(cfg, kind, x, _layer(seg, i), positions, cache=lc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, _head(cfg, params), cfg.compute_dtype)[:, 0]
    return (logits[..., :cfg.vocab_size],
            {"pos": pos + 1, "segments": cache["segments"]})
