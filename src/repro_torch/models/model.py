"""Public model API: ``Model`` binds an ArchConfig and a device to the
functions of :mod:`repro_torch.models.transformer` (port of
``repro.models.model``)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ArchConfig
from .transformer import decode_step, forward, init_cache, init_params, loss_fn


class Model:
    """An architecture on one device: ``cuda`` unless ``device="cpu"``."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> dict[str, Any]:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.cfg, gen)

    def forward(self, params: dict[str, Any],
                batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(self.cfg, params, batch)

    def loss(self, params: dict[str, Any], batch: dict[str, torch.Tensor],
             moe_groups: int = 1) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        return loss_fn(self.cfg, params, batch, moe_groups)

    def init_cache(self, batch: int, max_len: int,
                   dtype: str | torch.dtype = torch.bfloat16) -> dict[str, Any]:
        return init_cache(self.cfg, batch, max_len, dtype, self.device)

    def decode_step(self, params: dict[str, Any], cache: dict[str, Any],
                    token: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
        return decode_step(self.cfg, params, cache, token)


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int,
                    rng: torch.Generator | np.random.Generator,
                    device: str | torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
    """Random token batch (token mode) from a torch or a numpy generator;
    labels are the tokens shifted left by one, as in the reference."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input mode {cfg.input_mode!r} not yet ported")
    dev = resolve_device(device)
    if isinstance(rng, np.random.Generator):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)).to(dev)
    else:
        toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=rng,
                             device=rng.device).to(dev)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
