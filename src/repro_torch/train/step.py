"""Train-step factory: loss → grads → AdamW, with microbatching and the
optional int8 round trip of the gradients (port of ``repro.train.step``).

The state is ``{"params", "opt", "step"}`` as in the reference.  The step
writes the new parameters and optimizer state into the state's tensors and
returns the state (the reference's loop donates it).  One card, so the int8
round trip stands for the data-parallel reduction it would compress.  The
batch's inputs follow the config's input mode (tokens, frame embeddings,
or patch embeddings then tokens); the step passes them through as they
are.  :func:`train_memory_gb` reckons what a train state and one step
need on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import HYBRID_KINDS, init_params, loss_fn
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


#: bytes a parameter of a train state holds: fp32 parameters, gradients,
#: AdamW's fp32 master copy and its two moments
BYTES_PER_PARAM = 20
#: fp32 temporaries of one leaf that AdamW's update makes, one leaf at a
#: time: counted against the largest leaf
UPDATE_TEMPORARIES = 5
#: a step's activations with full remat: one layer's recompute at a time,
#: the residual stream at every layer, the logits with their gradient
ACTIVATION_GB = 8.0


def largest_leaf(cfg: ArchConfig) -> int:
    """Elements of ``cfg``'s largest parameter leaf: the embedding table or
    a segment's stacked weight (an expert weight, an SSM in_proj, an MLP
    or attention projection)."""
    d = cfg.d_model
    sizes = [cfg.padded_vocab * d]
    for kind, count in cfg.segments():
        per_layer = [] if kind == "ssm" else [d * cfg.attn_dim]
        if kind == "ssm" or kind in HYBRID_KINDS:
            gn = cfg.ssm_groups * cfg.ssm_state
            per_layer.append(d * (2 * cfg.d_inner + 2 * gn + cfg.ssm_heads))
        if kind == "moe":
            per_layer.append(cfg.n_experts * d * cfg.moe_d_ff)
        elif kind != "ssm":
            per_layer.append(d * cfg.d_ff)
        sizes.append(count * max(per_layer))
    return max(sizes)


def train_memory_gb(cfg: ArchConfig) -> dict[str, float]:
    """GB that training ``cfg`` on one device needs, reckoned before
    anything is allocated: the state (BYTES_PER_PARAM a parameter), AdamW's
    fp32 temporaries of the largest leaf, the activations, and their
    total."""
    out = {"state_gb": BYTES_PER_PARAM * cfg.param_count() / 1e9,
           "update_gb": UPDATE_TEMPORARIES * 4 * largest_leaf(cfg) / 1e9,
           "activation_gb": ACTIVATION_GB}
    return {**out, "total_gb": sum(out.values())}
