"""AdamW, schedules and gradient utilities (port of ``repro.optim.adamw``).

The optimizer state keeps the reference's tree layout, ``{"m", "v",
"master", "count"}`` with m, v and master nested as the parameters, so a
checkpoint of either package restores into the other.  It is a dict of
tensors, not a ``torch.optim.Optimizer``.

Unlike the reference, whose arrays are immutable, :meth:`AdamW.update`
writes the new m, v, master and parameters into the tensors it is given (the
reference's train loop donates the state, ``donate_argnums=(0,)``): at 1 B
parameters a second copy of the state would cost 20 GB of card memory.  The
arithmetic is the reference's, leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.bridge import flatten
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _as_step(step: Any) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Any], torch.Tensor]:
    def fn(step: Any) -> torch.Tensor:
        step = _as_step(step)
        warm = base_lr * step / max(1.0, warmup)
        progress = ((step - warmup) / max(1.0, total - warmup)).clamp(0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup, warm, cos)
    return fn


def linear_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    def fn(step: Any) -> torch.Tensor:
        step = _as_step(step)
        warm = base_lr * step / max(1.0, warmup)
        lin = base_lr * (1.0 - (step - warmup)
                         / max(1.0, total - warmup)).clamp(0.0, 1.0)
        return torch.where(step < warmup, warm, lin)
    return fn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with fp32 master weights, global-norm clipping and bias
    correction; weight decay on the leaves of two or more dims."""

    schedule: Callable[[Any], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Pytree) -> dict[str, Pytree]:
        def zeros(p):
            return tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), p)

        leaf = tree_leaves(params)[0]
        return {"m": zeros(params), "v": zeros(params),
                # a copy: fp32 params must not alias the master (the
                # reference needs copy=True for the same reason)
                "master": tree_map(
                    lambda x: x.detach().to(torch.float32, copy=True), params),
                "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    @torch.no_grad()
    def update(self, grads: Pytree, state: dict[str, Pytree], params: Pytree,
               grad_norm: torch.Tensor | None = None
               ) -> tuple[Pytree, dict[str, Pytree], dict[str, torch.Tensor]]:
        """One step; writes m, v, master and the parameters in place and
        returns them with the metrics ``lr`` and ``grad_norm``.  The
        arithmetic is elementwise, so the leaves may be matching slices of
        the full ones (ZeRO-1); then ``grad_norm`` is the full gradients'
        global norm, which clipping uses (default: the norm of ``grads``)."""
        count = state["count"] + 1
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm else None)
        b1, b2 = self.b1, self.b2
        c = count.to(torch.float32)
        lr = self.schedule(count)
        trees = [flatten(t) for t in (grads, state["m"], state["v"],
                                      state["master"])]
        for key, p in flatten(params).items():
            g, m, v, w = (t[key] for t in trees)
            g = g.float() * scale if scale is not None else g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            mhat = m / (1 - b1 ** c)
            vhat = v / (1 - b2 ** c)
            step = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and w.dim() >= 2:   # decay matrices only
                step = step + self.weight_decay * w
            w.copy_(w - lr * step)
            p.copy_(w)
        state["count"] = count
        return params, state, {"lr": lr, "grad_norm": gnorm}


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn: Callable, params: Pytree, batch: Any
                   ) -> tuple[tuple[torch.Tensor, dict[str, torch.Tensor]], Pytree]:
    """((loss, aux), grads) of ``loss_fn(params, batch) -> (loss, aux)``,
    the grads nested as the parameters (zeros for a leaf the loss does not
    reach), as ``jax.value_and_grad(..., has_aux=True)`` gives them."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
            tree_unflatten(params, grads))


def accumulate_grads(loss_fn: Callable, params: Pytree, batches: dict[str, torch.Tensor],
                     n_micro: int) -> tuple[Pytree, torch.Tensor, dict[str, torch.Tensor]]:
    """Over ``n_micro`` microbatches (leading axis of ``batches``): the mean
    of the grads (summed in fp32, in place: one fp32 tree beside each
    microbatch's grads), the mean loss and the last microbatch's aux."""
    total = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), params)
    loss_sum = 0.0
    aux = {}
    for i in range(n_micro):
        (loss, aux), g = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in batches.items()})
        tree_map(torch.Tensor.add_, total, g)
        del g
        loss_sum = loss_sum + loss
    return tree_map(lambda t: t.div_(n_micro), total), loss_sum / n_micro, aux


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def compress_int8(tree: Pytree) -> Pytree:
    """Per-leaf symmetric int8 quantization: {"q", "scale"}."""
    def q(x):
        amax = torch.max(torch.abs(x)) + 1e-12
        scale = amax / 127.0
        return {"q": torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8),
                "scale": scale.to(torch.float32)}
    return tree_map(q, tree)


def decompress_int8(tree: Pytree) -> Pytree:
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return tree["q"].to(torch.float32) * tree["scale"]
    if isinstance(tree, dict):
        return {k: decompress_int8(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [decompress_int8(v) for v in tree]
    raise TypeError(f"not a compressed tree: {type(tree)}")
