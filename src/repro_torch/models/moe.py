"""Mixture-of-Experts FFN: routed experts (+ an optional shared expert),
top-k routing.

Port of ``repro.models.moe`` (``router_probs``, ``load_balance_loss``,
``router_z_loss``, ``moe_ragged``, ``moe_einsum``, ``moe_sorted_local``,
``moe_ragged_sharded``, ``moe_block``).  Both
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
its expert axis.

Under an ambient device mesh (:mod:`repro_torch.distributed.context`),
``moe_block`` routes as the reference does:

* ``ragged`` with a ``model`` axis → ``moe_ragged_sharded``: each rank
  runs ``moe_sorted_local`` (a per-rank sort into (E, Cl, d) slots of a
  capacity Cl, a multiple of 128, dropping past it; its three products are
  grouped GEMMs with every group size Cl) on its data shard of the tokens
  and its ``model`` slice of the experts, sums the output over ``model``
  and reports the aux losses as the mean over data of each rank's own.
* ``einsum`` over a data axis of D > 1 ranks computes what the single
  program computes on the global batch: the capacity from the global group
  size, each rank's queue positions offset by the earlier ranks' counts in
  its group (one all-gather of the (G, E) counts), and the aux losses from
  global means.

Over a data axis of D > 1 each aux value is this rank's *share*: the sum
over the data ranks is the value (the train step sums them, with the
gradients).  With no mesh, or a data axis of 1, the numbers are the
single-device ones.

Tensor parallelism over M > 1 ``model`` ranks: the router and the tokens
are the same on every ``model`` rank, so is the routing; each rank runs
the three products on its block of every expert's hidden units
(``(E, ·, d)·(E, d, f/M)``), the rows and the combine weights entering
through f, and the partial outputs are summed (g; with sequence-parallel
activations the tokens are all-gathered first and the sum is a
reduce-scatter).  The shared expert is a tensor-parallel MLP.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
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


def _queue_positions(top_idx: torch.Tensor, n_experts: int, group_size: int,
                     groups: int) -> torch.Tensor:
    """(T,K) 0-based position of each (token, k) in its expert's queue
    within its group of ``group_size`` tokens, the queues filled in (token,
    k) order: the reference's cumulative sum of the one-hot, got from a
    stable sort by (group, expert) instead of a (G, Tg·K, E) scan.  Over a
    data axis of D > 1 the tokens are this rank's block of the global
    batch: the groups are the global batch's ``groups``, and a position is
    offset by the counts of the earlier ranks' (token, k) pairs in its
    (group, expert) queue."""
    t, k = top_idx.shape
    dp = mesh_ctx.dp_size()
    first = mesh_ctx.dp_index() * t if dp > 1 else 0
    group = (first + torch.arange(t, device=top_idx.device)) // group_size
    key = (group[:, None] * n_experts + top_idx).reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_key = key.gather(0, order)
    rank = torch.arange(key.numel(), device=key.device)
    in_queue = rank - torch.searchsorted(sorted_key, sorted_key, side="left")
    if dp > 1:
        counts = torch.zeros(groups * n_experts, dtype=torch.int64,
                             device=key.device).scatter_add(0, key, torch.ones_like(key))
        earlier = mesh_ctx.dp_all_gather(counts)[:mesh_ctx.dp_index()].sum(0)
        in_queue = in_queue + earlier.gather(0, sorted_key)
    return torch.empty_like(in_queue).scatter(0, order, in_queue).view(t, k)


def _aux_losses(probs: torch.Tensor, logits: torch.Tensor, top_idx: torch.Tensor,
                n_experts: int, top_k: int, dropped: torch.Tensor
                ) -> dict[str, torch.Tensor]:
    """load_balance, router_z and dropped (``dropped`` (T,): each token's
    share of its k slots over capacity) as the means over the tokens; over
    a data axis of D > 1, this rank's shares of the means over the global
    batch (load_balance from the global expert counts, which carry no
    gradient: E·Σ f_e·p_e does not commute with a mean over ranks)."""
    mask = _expert_mask(top_idx, n_experts)
    dp = mesh_ctx.dp_size()
    if dp == 1:
        return {"load_balance": load_balance_loss(probs, mask, n_experts, top_k),
                "router_z": router_z_loss(logits),
                "dropped": dropped.mean()}
    t_global = probs.shape[0] * dp
    f = mesh_ctx.dp_all_reduce(mask.sum(dim=0)) / t_global / top_k
    p_share = probs.sum(dim=0) / t_global
    return {"load_balance": n_experts * (f * p_share).sum(),
            "router_z": torch.logsumexp(logits, dim=-1).square().sum() / t_global,
            "dropped": dropped.sum() / t_global}


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
                 n_experts: int, act: str, cd: torch.dtype,
                 tp: bool = False) -> torch.Tensor:
    """Each (token, k) row through its expert's gated FFN: (T·K, d) in the
    compute dtype, in (token, k) order.  The rows go through the grouped
    GEMMs sorted by expert; the group sizes are counted on the device.
    With ``tp`` the experts are this rank's hidden block (the rows enter
    through f; the output is this rank's partial sum)."""
    t, k = top_idx.shape
    flat_expert = top_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    # each token's K copies, then the permutation: the gradient sums a
    # token's K rows in a fixed order (a gather of each token K times
    # would sum them by atomic adds, in a different order every run)
    xs = cast(mesh_ctx.model_copy(x) if tp else x, cd)
    xs = xs.unsqueeze(1).expand(t, k, xs.shape[-1]).reshape(t * k, -1).index_select(0, order)
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
    aux = _aux_losses(probs, logits, top_idx, n_experts, top_k,
                      torch.zeros(t, dtype=torch.float32, device=x.device))
    return out.to(x.dtype), aux


def moe_einsum(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
               top_k: int, capacity_factor: float, act: str,
               router_renorm: bool, groups: int,
               compute_dtype: str | torch.dtype = torch.bfloat16,
               tp: bool = False
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """GShard capacity dispatch.  Tokens split into G groups of Tg;
    capacity per group and expert as the reference's.  x (T,d) → (out
    (T,d) in x's dtype, aux with ``dropped``, the mean share of a token's
    k slots over capacity).  With ``tp`` the experts are this ``model``
    rank's hidden block and ``out`` is its partial sum in fp32 (the caller
    sums it over ``model``)."""
    t, d = x.shape
    cd = as_dtype(compute_dtype)
    t_total = t * mesh_ctx.dp_size()            # the global batch's tokens
    g = max(1, min(groups, t_total))
    while t_total % g:
        g -= 1
    tg = t_total // g
    capacity = max(top_k, int(tg * top_k * capacity_factor / n_experts))
    capacity = ((capacity + 31) // 32) * 32

    probs, logits, top_p, top_idx = _route(x, p["router"], top_k, router_renorm)
    keep = _queue_positions(top_idx, n_experts, tg, g) < capacity
    # combine weights in the compute dtype; the sum over k rounded to it
    weight = torch.where(keep, top_p, 0.0).to(cd)
    h = _expert_rows(x, p, top_idx, n_experts, act, cd, tp)
    if tp:
        weight = mesh_ctx.model_copy(weight)
    out = (h.float().view(t, top_k, d) * weight.float()[..., None]).sum(dim=1)
    aux = _aux_losses(probs, logits, top_idx, n_experts, top_k,
                      1.0 - keep.float().sum(dim=-1) / top_k)
    return (out if tp else out.to(cd).to(x.dtype)), aux


def moe_sorted_local(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
                     top_k: int, act: str, router_renorm: bool,
                     compute_dtype: str | torch.dtype,
                     capacity_factor: float = 1.25, tp: bool = False
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Sort + capacity-padded grouped GEMM over one rank's tokens.  x (T,d)
    → (out (T,d) in x's dtype, aux of these tokens alone).

    The (token, k) rows, stably sorted by expert, fill (E, Cl) slots, Cl =
    T·K·capacity_factor / E rounded up to a multiple of 128 (at least 128);
    a row past its expert's Cl drops (``dropped``: the share of rows
    dropped) into a trash slot that is sliced away.  The three (E, Cl, d)
    products are grouped GEMMs with every group size Cl (on a CUDA tensor
    the kernel).  The combine sums each token's K weighted rows in fp32, in
    (token, k) order.

    With ``tp`` the expert weights are this rank's ``model`` slice of their
    hidden size: the rows entering the products and the combine weights go
    through Megatron's f (their gradients summed over ``model``), and
    ``out`` is this rank's partial sum in fp32, which the caller sums over
    ``model``."""
    t, d = x.shape
    cd = as_dtype(compute_dtype)
    probs, logits, top_p, top_idx = _route(x, p["router"], top_k, router_renorm)
    tk = t * top_k
    cl = int(tk * capacity_factor / n_experts)
    cl = max(128, ((cl + 127) // 128) * 128)

    flat_expert = top_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert.gather(0, order)
    rank = torch.arange(tk, device=x.device)
    pos_in_run = rank - torch.searchsorted(sorted_expert, sorted_expert, side="left")
    keep = pos_in_run < cl
    dest = torch.where(keep, sorted_expert * cl + pos_in_run, n_experts * cl)

    enter = mesh_ctx.model_copy if tp else (lambda v: v)
    xs = enter(cast(x, cd)).index_select(0, order // top_k)
    # out of place; dropped rows land in the trash slot E·Cl, sliced away
    xin = torch.zeros((n_experts * cl + 1, d), dtype=cd, device=x.device
                      ).index_copy(0, dest, xs)[:-1]
    sizes = torch.full((n_experts,), cl, dtype=torch.int32, device=x.device)
    fn = _act(act)
    gate = moe_gmm.grouped_matmul(xin, cast(p["wi_gate"], cd), sizes)
    up = moe_gmm.grouped_matmul(xin, cast(p["wi_up"], cd), sizes)
    h = moe_gmm.grouped_matmul(fn(gate) * up, cast(p["wo"], cd), sizes)

    inverse = torch.empty_like(order).scatter(0, order, rank)
    h_rows = h.index_select(0, dest.clamp_max(n_experts * cl - 1).index_select(0, inverse))
    weight = enter(top_p.reshape(-1) * keep.index_select(0, inverse).float())
    out = (h_rows.float().view(t, top_k, d) * weight.view(t, top_k, 1)).sum(dim=1)
    aux = {
        "load_balance": load_balance_loss(
            probs, _expert_mask(top_idx, n_experts), n_experts, top_k),
        "router_z": router_z_loss(logits),
        "dropped": 1.0 - keep.float().mean(),
    }
    return (out if tp else out.to(x.dtype)), aux


def _expert_view(p: dict[str, Any], moe_d_ff: int) -> dict[str, Any]:
    """The router and this ``model`` rank's hidden block of every expert,
    from leaves stored whole or as the rules' ``model`` shards of an
    expert hidden size ``moe_d_ff`` (with one rank: the leaves whole, and
    ``moe_d_ff`` may be 0)."""
    m = mesh_ctx.axis_size("model")
    if m > 1 and moe_d_ff < 1:
        raise ValueError(f"experts over {m} model ranks need the whole hidden "
                         f"size moe_d_ff, got {moe_d_ff}")
    hid = shd.hidden_view(moe_d_ff, m, mesh_ctx.model_rank())
    out = {"router": p["router"],
           "wi_gate": mesh_ctx.model_view(p["wi_gate"], -1, hid, moe_d_ff),
           "wi_up": mesh_ctx.model_view(p["wi_up"], -1, hid, moe_d_ff),
           "wo": mesh_ctx.model_view(p["wo"], -2, hid, moe_d_ff)}
    ffm = out["wo"].shape[-2]
    if out["wi_gate"].shape[-1] != ffm or out["wi_up"].shape[-1] != ffm:
        raise ValueError(f"expert slices disagree: wi_gate {tuple(p['wi_gate'].shape)}, "
                         f"wi_up {tuple(p['wi_up'].shape)}, wo {tuple(p['wo'].shape)}")
    return out


def moe_ragged_sharded(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
                       top_k: int, act: str, router_renorm: bool,
                       compute_dtype: str | torch.dtype, moe_d_ff: int,
                       seq: bool = False
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The ragged dispatch on the ambient mesh (the reference's
    ``shard_map``): a sort per rank, capacity-padded, so rows past Cl
    drop.  x (B,S,d) is this rank's data shard (with ``seq``, its
    sequence shard, all-gathered first); ``wi_gate``/``wi_up`` (E, d, f)
    and ``wo`` (E, f, d) of ``f = moe_d_ff`` are stored whole or as the
    rules' ``model`` shards, from which its slice is taken.  Each
    rank sorts its own tokens (:func:`moe_sorted_local`), the output is
    summed over ``model`` (Megatron's g), and the aux losses are each
    rank's own statistics averaged over data (the reference's ``pmean``;
    over D > 1 each rank returns its share, aux / D)."""
    m = mesh_ctx.axis_size("model")
    xr = mesh_ctx.enter_replicated(x, seq)
    b, s, d = xr.shape
    out, aux = moe_sorted_local(
        xr.reshape(b * s, d), _expert_view(p, moe_d_ff), n_experts=n_experts,
        top_k=top_k, act=act, router_renorm=router_renorm,
        compute_dtype=compute_dtype, tp=m > 1)
    out = mesh_ctx.leave(out.float().reshape(b, s, d), seq)
    dp = mesh_ctx.dp_size()
    if dp > 1:
        aux = {k: v / dp for k, v in aux.items()}
    return out.to(x.dtype), aux


def moe_block(x: torch.Tensor, p: dict[str, Any], *, n_experts: int,
              n_shared: int, top_k: int, capacity_factor: float, act: str,
              router_renorm: bool, dispatch: str, groups: int,
              compute_dtype: str | torch.dtype = torch.bfloat16,
              moe_d_ff: int = 0, d_ff: int = 0, seq: bool = False
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full MoE FFN: routed experts (+ the shared expert, gated per token
    by an fp32 sigmoid, where ``n_shared``).  x (B,S,d) → (out (B,S,d),
    aux: load_balance, router_z, dropped).  ``ragged`` under a mesh with a
    ``model`` axis takes :func:`moe_ragged_sharded`, as the reference.
    With M > 1 ``model`` ranks the experts' hidden size ``moe_d_ff`` and
    the shared expert's ``d_ff`` are split (module docstring); ``seq``
    says x (and the output) is this rank's sequence shard."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    if dispatch == "ragged" and "model" in mesh_ctx.mesh_axis_names():
        out, aux = moe_ragged_sharded(
            x, p, n_experts=n_experts, top_k=top_k, act=act,
            router_renorm=router_renorm, compute_dtype=compute_dtype,
            moe_d_ff=moe_d_ff, seq=seq)
        out = out.reshape(b * s, d)
    elif mesh_ctx.axis_size("model") > 1:
        xr = mesh_ctx.enter_replicated(x, seq)
        out, aux = moe_einsum(
            xr.reshape(-1, d), _expert_view(p, moe_d_ff), n_experts=n_experts,
            top_k=top_k, capacity_factor=capacity_factor, act=act,
            router_renorm=router_renorm, groups=groups,
            compute_dtype=compute_dtype, tp=True)
        out = mesh_ctx.leave(out.view(xr.shape), seq)
        out = out.to(as_dtype(compute_dtype)).to(x.dtype).reshape(b * s, d)
    elif dispatch == "ragged":
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
        shared = mlp(flat, sp, act, compute_dtype, d_ff=d_ff, seq=seq)
        # the token gate acts on the stream: on a sequence shard, through f
        gate_w = mesh_ctx.model_copy(sp["gate"]) if seq else sp["gate"]
        gate = torch.sigmoid(flat.float() @ gate_w.float())
        out = out + (shared.float() * gate).to(out.dtype)
    return out.reshape(b, s, d), aux
