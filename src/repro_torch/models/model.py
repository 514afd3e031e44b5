"""Public model API: ``Model`` binds an ArchConfig and a device to the
functions of :mod:`repro_torch.models.transformer` (port of
``repro.models.model``).  ``input_specs`` and ``cache_specs`` give meta
tensors for every input of an (arch × shape) cell, and
``Model.init_abstract`` the parameter tree's: the sharding rules and a dry
run read their shapes without allocating anything."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ArchConfig, ShapeConfig
from .transformer import (
    decode_step, forward, init_abstract_params, init_cache, init_params,
    init_serving_params, loss_fn,
)


class Model:
    """An architecture on one device: ``cuda`` unless ``device="cpu"``."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0, serving: bool = False) -> dict[str, Any]:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``: in ``param_dtype`` for training, or with ``serving`` the
        serving tree made directly in the compute dtype
        (:func:`~repro_torch.models.transformer.init_serving_params`)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return (init_serving_params if serving else init_params)(self.cfg, gen)

    def init_abstract(self) -> dict[str, Any]:
        """The parameter tree as meta tensors (paths, shapes, dtypes; no
        allocation)."""
        return init_abstract_params(self.cfg)

    def forward(self, params: dict[str, Any],
                batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(self.cfg, params, batch)

    def loss(self, params: dict[str, Any], batch: dict[str, torch.Tensor],
             moe_groups: int = 1) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        return loss_fn(self.cfg, params, batch, moe_groups)

    def init_cache(self, batch: int, max_len: int,
                   dtype: str | torch.dtype = torch.bfloat16,
                   mesh: Any = None) -> dict[str, Any]:
        """The decode cache; with a ``DeviceMesh``, only this rank's shards
        of it (``batch`` the global batch)."""
        return init_cache(self.cfg, batch, max_len, dtype, self.device, mesh)

    def decode_step(self, params: dict[str, Any], cache: dict[str, Any],
                    token: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
        return decode_step(self.cfg, params, cache, token)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """Meta tensors for one (arch × shape) cell's inputs, in the reference's
    dtypes: train/prefill → the training batch (tokens and labels int32,
    embeddings bf16; ``mixed``: ``n_patches`` patch embeddings, then
    tokens); decode → the one-token step's input (the cache:
    :func:`cache_specs`)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "tokens":
            return {"tokens": meta(b, s), "labels": meta(b, s)}
        if cfg.input_mode == "embeds":
            return {"embeds": meta(b, s, cfg.d_model, dtype=torch.bfloat16),
                    "labels": meta(b, s)}
        return {"tokens": meta(b, s - cfg.n_patches),
                "patch_embeds": meta(b, cfg.n_patches, cfg.d_model,
                                     dtype=torch.bfloat16),
                "labels": meta(b, s)}
    return {"token": meta(b, 1)}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype: str | torch.dtype = torch.bfloat16) -> dict[str, Any]:
    """A decode cell's cache as meta tensors, ``pos`` the reference's 0-d
    int32 as in a live cache."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, dtype, "meta")


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int,
                    rng: torch.Generator | np.random.Generator,
                    device: str | torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
    """A random batch of ``seq`` positions from a torch or a numpy
    generator, by the input mode, as the reference's: tokens with the
    tokens shifted left by one as labels; frame embeddings (N(0, 0.1²),
    bf16) with random labels (``embeds``); or ``min(n_patches, seq // 2)``
    patch embeddings (bf16) then tokens, the patches' labels -100
    (``mixed``)."""
    dev = resolve_device(device)

    def ints(*shape):
        if isinstance(rng, np.random.Generator):
            return torch.from_numpy(
                rng.integers(0, cfg.vocab_size, shape).astype(np.int64)).to(dev)
        return torch.randint(0, cfg.vocab_size, shape, generator=rng,
                             device=rng.device).to(dev)

    def normal(*shape):
        if isinstance(rng, np.random.Generator):
            x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        else:
            x = torch.randn(shape, generator=rng, device=rng.device)
        return (x * 0.1).to(device=dev, dtype=torch.bfloat16)

    if cfg.input_mode == "tokens":
        toks = ints(batch, seq)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.input_mode == "embeds":
        return {"embeds": normal(batch, seq, cfg.d_model), "labels": ints(batch, seq)}
    npatch = min(cfg.n_patches, seq // 2)
    toks = ints(batch, seq - npatch)
    patches = normal(batch, npatch, cfg.d_model)
    labels = torch.cat([torch.full((batch, npatch), -100, dtype=torch.int64,
                                   device=dev), ints(batch, seq - npatch)], dim=1)
    return {"tokens": toks, "patch_embeds": patches, "labels": labels}
