"""Train-step factory: loss → grads → AdamW, with microbatching and the
optional int8 round trip of the gradients (port of ``repro.train.step``).

The state is ``{"params", "opt", "step"}`` as in the reference.  The step
writes the new parameters and optimizer state into the state's tensors and
returns the state (the reference's loop donates it).  One card, so the int8
round trip stands for the data-parallel reduction it would compress.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.adamw import (
    AdamW, accumulate_grads, compress_int8, decompress_int8, value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1              # gradient-accumulation microbatches
    moe_groups: int = 1           # GShard dispatch groups
    compress_grads: bool = False  # int8 round trip of the gradients
    seq_spec: Any = None          # sequence-parallel sharding: not ported


def make_train_step(cfg: ArchConfig, opt: AdamW,
                    step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.  Batch
    leaves have the batch dim first; with ``n_micro`` > 1 the batch is split
    on it and the grads are averaged over the pieces."""
    if step_cfg.seq_spec is not None:
        raise NotImplementedError(
            "sequence-parallel activations (seq_spec) need the multi-device "
            "layer, which is not ported")

    def _loss(params, batch):
        return loss_fn(cfg, params, batch, step_cfg.moe_groups)

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]
                   ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params = state["params"]
        if step_cfg.n_micro > 1:
            n = step_cfg.n_micro
            micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads, loss, aux = accumulate_grads(_loss, params, micro, n)
        else:
            (loss, aux), grads = value_and_grad(_loss, params, batch)
        if step_cfg.compress_grads:
            grads = decompress_int8(compress_int8(grads))
        new_params, new_opt, opt_metrics = opt.update(grads, state["opt"], params)
        metrics = {"loss": loss, **aux, **opt_metrics}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def init_train_state(cfg: ArchConfig, opt: AdamW, generator: torch.Generator
                     ) -> dict[str, Any]:
    """Random parameters on the generator's device, their optimizer state
    and step 0."""
    params = init_params(cfg, generator)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=generator.device)}
