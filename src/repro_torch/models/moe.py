"""Mixture-of-Experts FFN: routed experts (+ an optional shared expert),
top-k routing.

Port of ``repro.models.moe`` (``router_probs``, ``load_balance_loss``,
``router_z_loss``, ``moe_ragged``, ``moe_einsum``, ``moe_block``).  Both
dispatches send their three expert products through the grouped-GEMM
wrapper :func:`repro_torch.kernels.moe_gmm.grouped_matmul`: on a CUDA
tensor that is the kernel, whatever ``use_kernels`` says; on a CPU tensor
its plain version.

* ``ragged`` — dropless: the (token, k) rows sorted by expert (a stable
  sort, as ``jnp.argsort``), the three products as grouped GEMMs, then
  un-sorted and combined in fp32.
* ``einsum`` — the reference's GShard capacity dispatch, ported by what it
  computes: a (token, k) pair is kept iff its position in its expert's
  queue within its group is below ``capacity``.  The reference's
  (G, Tg, E, C) one-hot dispatch and combine tensors are not built: the
  same grouped GEMM runs over all T·K rows and a dropped row gets weight
  0, as its contribution is 0 in the reference.  That costs the dropped
  rows' FLOPs.  The combine rounds where the reference's does.

Nothing here reads a device tensor on the host (no ``.item()``, no
``bincount``, no boolean-mask indexing), so a MoE layer adds no host
synchronisation to a decode step.  Nothing updates a fresh tensor in
place from a batched one, so a gang runs the layer under
``torch.func.vmap``: the grouped GEMM's vmap rule folds the members into
its expert axis.  ``moe_sorted_local`` and
``moe_ragged_sharded`` need a device mesh and are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import moe_gmm

from .layers import _act, as_dtype, cast, mlp


def router_probs(x: torch.Tensor, w_router: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Router softmax in fp32 from an fp32 product.  x (T,d) → (probs,
    logits), both (T,E)."""
    logits = x.float() @ w_router.float()
    return torch.softmax(logits, dim=-1), logits


def load_balance_loss(probs: torch.Tensor, expert_mask: torch.Tensor,
                      n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · p_e.  probs (T,E);
    expert_mask (T,E) the count of the token's k slots that chose each
    expert."""
    f = expert_mask.float().mean(dim=0) / top_k
    return n_experts * (f * probs.mean(dim=0)).sum()


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits, dim=-1).square().mean()


def _expert_mask(top_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(T,E) fp32: how many of each token's k slots chose each expert (the
    reference's one-hot summed over k), by a scatter."""
    mask = torch.zeros((top_idx.shape[0], n_experts), dtype=torch.float32,
                       device=top_idx.device)
    # out of place: under torch.func.vmap (a gang) top_idx is batched
    return mask.scatter_add(1, top_idx, torch.ones_like(top_idx, dtype=torch.float32))


def _queue_positions(top_idx: torch.Tensor, n_experts: int, groups: int
                     ) -> torch.Tensor:
    """(T,K) 0-based position of each (token, k) in its expert's queue
    within its group, the queues filled in (token, k) order: the
    reference's cumulative sum of the one-hot, got from a stable sort by
    (group, expert) instead of a (G, Tg·K, E) scan."""
    t, k = top_idx.shape
    group = torch.arange(t, device=top_idx.device) // (t // groups)
    key = (group[:, None] * n_experts + top_idx).reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_key = key.gather(0, order)
    rank = torch.arange(key.numel(), device=key.device)
    in_queue = rank - torch.searchsorted(sorted_key, sorted_key, side="left")
    return torch.empty_like(in_queue).scatter(0, order, in_queue).view(t, k)


def _route(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
           router_renorm: bool) -> tuple[torch.Tensor, ...]:
    """(probs, logits, top_p (T,K), top_idx (T,K)), top-k in descending
    order."""
    probs, logits = router_probs(x, w_router)
    top_p, top_idx = torch.topk(probs, top_k, dim=-1)
    if router_renorm:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, logits, top_p, top_idx


def _expert_rows(x: torch.Tensor, p: dict[str, Any], top_idx: torch.Tensor,
                 n_experts: int, act: str, cd: torch.dtype) -> torch.Tensor:
    """Each (token, k) row through its expert's gated FFN: (T·K, d) in the
    compute dtype, in (token, k) order.  The rows go through the grouped
    GEMMs sorted by expert; the group sizes are counted on the device."""
    k = top_idx.shape[1]
    flat_expert = top_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    xs = cast(x, cd).index_select(0, order // k)
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=x.device).scatter_add(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))
    fn = _act(act)
    gate = moe_gmm.grouped_matmul(xs, cast(p["wi_gate"], cd), sizes)
    up = moe_gmm.grouped_matmul(xs, cast(p["wi_up"], cd), sizes)
    h = moe_gmm.grouped_matmul(fn(gate) * up, cast(p["wo"], cd), sizes)
    inverse = torch.empty_like(order).scatter(
        0, order, torch.arange(order.numel(), device=order.device))
    return h.index_select(0, inverse)


def moe_ragged(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
               top_k: int, act: str, router_renorm: bool,
               compute_dtype: str | torch.dtype = torch.bfloat16
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Dropless sort-based dispatch.  x (T,d) → (out (T,d) in x's dtype,
    aux).  The combine sums each token's K weighted rows in fp32 (the
    reference's scatter-add, without atomics)."""
    t, d = x.shape
    probs, logits, top_p, top_idx = _route(x, p["router"], top_k, router_renorm)
    h = _expert_rows(x, p, top_idx, n_experts, act, as_dtype(compute_dtype))
    out = (h.float().view(t, top_k, d) * top_p.float()[..., None]).sum(dim=1)
    aux = {
        "load_balance": load_balance_loss(
            probs, _expert_mask(top_idx, n_experts), n_experts, top_k),
        "router_z": router_z_loss(logits),
        "dropped": torch.zeros((), dtype=torch.float32, device=x.device),
    }
    return out.to(x.dtype), aux


def moe_einsum(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
               top_k: int, capacity_factor: float, act: str,
               router_renorm: bool, groups: int,
               compute_dtype: str | torch.dtype = torch.bfloat16
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """GShard capacity dispatch.  Tokens split into G groups of Tg;
    capacity per group and expert as the reference's.  x (T,d) → (out
    (T,d) in x's dtype, aux with ``dropped``, the mean share of a token's
    k slots over capacity)."""
    t_total, d = x.shape
    cd = as_dtype(compute_dtype)
    g = max(1, min(groups, t_total))
    while t_total % g:
        g -= 1
    tg = t_total // g
    capacity = max(top_k, int(tg * top_k * capacity_factor / n_experts))
    capacity = ((capacity + 31) // 32) * 32

    probs, logits, top_p, top_idx = _route(x, p["router"], top_k, router_renorm)
    keep = _queue_positions(top_idx, n_experts, g) < capacity
    # combine weights in the compute dtype; the sum over k rounded to it
    weight = torch.where(keep, top_p, 0.0).to(cd)
    h = _expert_rows(x, p, top_idx, n_experts, act, cd)
    out = (h.float().view(t_total, top_k, d) * weight.float()[..., None]).sum(dim=1)
    aux = {
        "load_balance": load_balance_loss(
            probs, _expert_mask(top_idx, n_experts), n_experts, top_k),
        "router_z": router_z_loss(logits),
        "dropped": (1.0 - keep.float().sum(dim=-1) / top_k).mean(),
    }
    return out.to(cd).to(x.dtype), aux


def moe_block(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
              n_shared: int, top_k: int, capacity_factor: float, act: str,
              router_renorm: bool, dispatch: str, groups: int,
              compute_dtype: str | torch.dtype = torch.bfloat16
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full MoE FFN: routed experts (+ the shared expert, gated per token
    by an fp32 sigmoid, where ``n_shared``).  x (B,S,d) → (out (B,S,d),
    aux: load_balance, router_z, dropped)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    if dispatch == "ragged":
        out, aux = moe_ragged(
            flat, p, n_experts=n_experts, top_k=top_k, act=act,
            router_renorm=router_renorm, compute_dtype=compute_dtype)
    else:
        out, aux = moe_einsum(
            flat, p, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor, act=act,
            router_renorm=router_renorm, groups=groups,
            compute_dtype=compute_dtype)
    if n_shared:
        sp = p["shared"]
        shared = mlp(flat, sp, act, compute_dtype)
        gate = torch.sigmoid(flat.float() @ sp["gate"].float())
        out = out + (shared.float() * gate).to(out.dtype)
    return out.reshape(b, s, d), aux
