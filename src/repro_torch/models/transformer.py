"""Model assembly: embeddings → layer segments → head.

Port of ``repro.models.transformer`` for every layer kind of the
reference: ``attn``, ``swa``, ``ssm``, ``moe``, the hybrid
``hyb_g``/``hyb_l`` (hymba: an attention branch and a Mamba2 branch on
the same normed input, fused as the mean of their RMS-normed outputs) and
the encoder's ``enc`` (bidirectional attention, LayerNorm, a non-gated
GELU MLP with biases), and for its three input modes: tokens, frame
embeddings (``embeds``, hubert) and patch embeddings followed by tokens
(``mixed``, a VLM), both projected by ``frontend_proj``.  Consecutive
layers of one kind form a *segment* whose parameters are stacked on a
leading layer axis, the reference's layout; a Python loop over that axis
replaces ``lax.scan``.
The MoE aux losses are summed over the layers, as the reference's scan
carry does, and ``loss_fn`` adds them to the masked cross entropy; each
layer runs under ``torch.utils.checkpoint`` as ``cfg.remat`` says (the
reference's ``jax.checkpoint``).  A gang's members (``members=True``)
are stacked on a leading axis of every leaf and run in one batched pass.

Under an ambient mesh with M > 1 ``model`` ranks (tensor parallelism) the
parameters are each rank's stored shards (the sharding rules), the
residual stream is the same on every ``model`` rank, and each block
computes its slice between Megatron's f and g (attention, the MLP, the
experts, the Mamba2 mixer; a block whose heads do not split runs whole).
The embedding looks up its rows and sums over ``model``; the head is
vocab-parallel where the rules shard the vocabulary (a cross entropy over
the local logit columns: the max, the sum of ``exp`` and the gold logit
summed over ``model``), a product summed over ``model`` for a tied table
whose d columns are sharded (an odd vocabulary), and whole otherwise.
With ``seq_spec`` (sequence-parallel activations) each ``model`` rank
holds the residual stream as its ``(B, S/M, d)`` shard between blocks:
the norms run on the shard, each layer's checkpoint saves it, and f and g
become an all-gather and a reduce-scatter over the sequence.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.bridge import SEP
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.tree import tree_map

from .attention import attn_block
from .config import ArchConfig
from .layers import (
    as_dtype, cast, embed_tokens, layer_norm, mlp, normal_init, rms_norm,
    unembed,
)
from .moe import moe_block
from .ssm import init_ssm_cache, mamba2_block

HYBRID_KINDS = ("hyb_g", "hyb_l")
#: the attention kind each layer kind runs (the reference's map): a hybrid
#: global layer attends causally over every position, a hybrid local one
#: over the window, from a ring cache
_ATTN_KIND = {"moe": "attn", "hyb_g": "attn", "hyb_l": "swa"}

#: leaves the reference casts to the compute dtype at every use (matmul
#: weights, expert weights included, the embedding table, the frontend
#: projection and the non-gated MLP's biases); norm scales and LayerNorm
#: biases, the conv, dt_bias, A_log, D, the MoE router and the shared
#: expert's token gate stay in param dtype (the reference reads the last
#: two, and LayerNorm's scale and bias, in fp32)
_CAST_ON_USE = ("embed", "lm_head", "frontend_proj", "wq", "wk", "wv", "wo",
                "wi_gate", "wi_up", "wi", "bi", "bo", "in_proj", "out_proj")

#: fp32 elements of one draw of the serving init (256 MB): a stacked leaf
#: is filled a layer at a time, the embedding and the head a block of rows
#: at a time
_DRAW_ELEMENTS = 1 << 26


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

class _Leaves:
    """Makes the leaves of an init on the generator's device: every leaf in
    the param dtype, or with ``serving`` every leaf of ``_CAST_ON_USE`` in
    the compute dtype already, a drawn one filled a block of its leading
    axis at a time from fp32 draws (so no fp32 copy of it is ever whole)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None,
                 serving: bool = False, place: Any = None) -> None:
        self.gen = gen
        # with ``place``, each leaf goes to ``place(path, leaf)`` as it is
        # made, and the tree holds what that returns; its path is the keys
        # entered by ``at`` and its own
        self.place = place
        self.prefix: list[str] = []
        # no generator: the tree's shapes and dtypes on the meta device,
        # nothing drawn or allocated
        self.device = gen.device if gen is not None else torch.device("meta")
        self.param_dtype = as_dtype(cfg.param_dtype)
        self.cast_dtype = as_dtype(cfg.compute_dtype) if serving else self.param_dtype

    def dtype(self, key: str) -> torch.dtype:
        return self.cast_dtype if key in _CAST_ON_USE else self.param_dtype

    @contextlib.contextmanager
    def at(self, *keys: str):
        self.prefix.extend(keys)
        try:
            yield
        finally:
            del self.prefix[-len(keys):]

    def made(self, key: str, leaf: torch.Tensor) -> torch.Tensor:
        if self.place is None:
            return leaf
        return self.place(SEP.join([*self.prefix, key]), leaf)

    def normal(self, key: str, shape: tuple[int, ...],
               stddev: float = 0.02) -> torch.Tensor:
        dt = self.dtype(key)
        if self.gen is None:
            return self.made(key, torch.empty(shape, dtype=dt, device=self.device))
        if dt == self.param_dtype:
            return self.made(key, normal_init(self.gen, shape, dt, stddev))
        out = torch.empty(shape, dtype=dt, device=self.device)
        step = max(1, _DRAW_ELEMENTS // math.prod(shape[1:]))
        for start in range(0, shape[0], step):
            block = out[start:start + step]
            block.copy_(torch.randn(block.shape, generator=self.gen,
                                    dtype=torch.float32,
                                    device=self.device).mul_(stddev))
        return self.made(key, out)

    def fill(self, key: str, shape: tuple[int, ...],
             value: float = 0.0) -> torch.Tensor:
        return self.made(key, torch.full(shape, value, dtype=self.dtype(key),
                                         device=self.device))

    def layer_norm(self, key: str, shape: tuple[int, ...]
                   ) -> dict[str, torch.Tensor]:
        with self.at(key):
            return {"scale": self.fill("scale", shape, 1.0),
                    "bias": self.fill("bias", shape)}


def _init_ssm(leaves: _Leaves, cfg: ArchConfig, n: int) -> dict[str, Any]:
    """Mamba2 mixer parameters of ``n`` layers, stacked (reference
    ``_init_ssm``)."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_ch = di + 2 * gn
    a_init = torch.linspace(1.0, 16.0, h, device=leaves.device)
    with leaves.at("ssm"):
        return {
            "in_proj": leaves.normal("in_proj", (n, d, 2 * di + 2 * gn + h)),
            "conv_w": leaves.normal("conv_w", (n, cfg.ssm_conv, conv_ch), 0.2),
            "conv_b": leaves.fill("conv_b", (n, conv_ch)),
            "dt_bias": leaves.fill("dt_bias", (n, h)),
            "A_log": leaves.made("A_log", torch.log(a_init).to(
                leaves.dtype("A_log")).expand(n, h).clone()),
            "D": leaves.fill("D", (n, h), 1.0),
            "norm": leaves.fill("norm", (n, di)),
            "out_proj": leaves.normal("out_proj", (n, di, d)),
        }


def _init_moe(leaves: _Leaves, cfg: ArchConfig, n: int) -> dict[str, Any]:
    """Router, routed experts and the optional shared expert (with its
    token gate) of ``n`` layers, stacked (reference ``_init_moe``)."""
    d, ffm, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    with leaves.at("moe"):
        p: dict[str, Any] = {
            "router": leaves.normal("router", (n, d, e)),
            "wi_gate": leaves.normal("wi_gate", (n, e, d, ffm)),
            "wi_up": leaves.normal("wi_up", (n, e, d, ffm)),
            "wo": leaves.normal("wo", (n, e, ffm, d)),
        }
        if cfg.n_shared_experts:
            ffs = cfg.d_ff
            with leaves.at("shared"):
                p["shared"] = {
                    "wi_gate": leaves.normal("wi_gate", (n, d, ffs)),
                    "wi_up": leaves.normal("wi_up", (n, d, ffs)),
                    "wo": leaves.normal("wo", (n, ffs, d)),
                    "gate": leaves.normal("gate", (n, d, 1)),
                }
    return p


def _init_mlp(leaves: _Leaves, cfg: ArchConfig, n: int) -> dict[str, Any]:
    """A gated MLP, or a non-gated GELU one with biases (``gelu_nogate``),
    of ``n`` layers, stacked (reference ``_init_mlp``)."""
    d, ff = cfg.d_model, cfg.d_ff
    with leaves.at("mlp"):
        if cfg.mlp_act == "gelu_nogate":
            return {"wi": leaves.normal("wi", (n, d, ff)),
                    "bi": leaves.fill("bi", (n, ff)),
                    "wo": leaves.normal("wo", (n, ff, d)),
                    "bo": leaves.fill("bo", (n, d))}
        return {"wi_gate": leaves.normal("wi_gate", (n, d, ff)),
                "wi_up": leaves.normal("wi_up", (n, d, ff)),
                "wo": leaves.normal("wo", (n, ff, d))}


def _init_segment(leaves: _Leaves, cfg: ArchConfig, kind: str, n: int
                  ) -> dict[str, Any]:
    """Parameters of ``n`` layers of one kind, stacked on a leading axis
    (reference ``_init_layer``): an ``enc`` layer's norms are LayerNorms,
    ``{"scale", "bias"}``, every other kind's RMSNorm scales."""
    d, ad, kd = cfg.d_model, cfg.attn_dim, cfg.n_kv_heads * cfg.head_dim

    def norm(key):
        return (leaves.layer_norm(key, (n, d)) if kind == "enc"
                else leaves.fill(key, (n, d)))

    if kind == "ssm":   # norm1 → mixer → residual; no norm2, no MLP
        return {"norm1": norm("norm1"), "ssm": _init_ssm(leaves, cfg, n)}
    with leaves.at("attn"):
        attn = {
            "wq": leaves.normal("wq", (n, d, ad)),
            "wk": leaves.normal("wk", (n, d, kd)),
            "wv": leaves.normal("wv", (n, d, kd)),
            "wo": leaves.normal("wo", (n, ad, d)),
        }
        if cfg.qk_norm:
            attn["q_norm"] = leaves.fill("q_norm", (n, cfg.head_dim))
            attn["k_norm"] = leaves.fill("k_norm", (n, cfg.head_dim))
    if kind == "moe":   # the MoE FFN in place of the MLP
        return {"norm1": norm("norm1"), "norm2": norm("norm2"), "attn": attn,
                "moe": _init_moe(leaves, cfg, n)}
    p = {"norm1": norm("norm1"), "norm2": norm("norm2"), "attn": attn,
         "mlp": _init_mlp(leaves, cfg, n)}
    if kind in HYBRID_KINDS:   # the SSM branch beside the attention
        p.update(ssm=_init_ssm(leaves, cfg, n),
                 branch_norm_attn=norm("branch_norm_attn"),
                 branch_norm_ssm=norm("branch_norm_ssm"))
    return p


def _init_tree(cfg: ArchConfig, leaves: _Leaves) -> dict[str, Any]:
    """The parameter tree in the reference's layout (reference
    ``init_params``): ``frontend_proj`` for the ``embeds`` and ``mixed``
    input modes (``embed`` is kept in ``embeds`` mode, where nothing reads
    it, so both packages name the same leaves), a LayerNorm final norm when
    the first layer is ``enc``."""
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": leaves.normal("embed", (cfg.padded_vocab, d))}
    if cfg.input_mode in ("embeds", "mixed"):
        params["frontend_proj"] = leaves.normal("frontend_proj", (d, d))
    params["segments"] = []
    for i, (kind, count) in enumerate(cfg.segments()):
        with leaves.at("segments", f"[{i}]"):
            params["segments"].append(_init_segment(leaves, cfg, kind, count))
    params["final_norm"] = (leaves.layer_norm("final_norm", (d,))
                            if cfg.layer_types and cfg.layer_types[0] == "enc"
                            else leaves.fill("final_norm", (d,)))
    if not cfg.tie_embeddings:
        params["lm_head"] = leaves.normal("lm_head", (d, cfg.padded_vocab))
    return params


def init_params(cfg: ArchConfig, generator: torch.Generator,
                place: Any = None) -> dict[str, Any]:
    """Random parameters on the generator's device, in the reference's
    layout and ``param_dtype`` (the values differ: jax.random cannot be
    reproduced).

    With ``place``, each leaf goes to ``place(path, leaf)`` (its path as
    :func:`repro_torch.bridge.flatten` keys it) as soon as it is made, and
    the tree holds what that returns: a caller that keeps a rank's slice
    holds one drawn leaf whole at a time, not the tree.  The draws, and so
    the values, are the same."""
    return _init_tree(cfg, _Leaves(cfg, generator, place=place))


def init_abstract_params(cfg: ArchConfig) -> dict[str, Any]:
    """The parameter tree's paths, shapes and dtypes as meta tensors:
    nothing is drawn or allocated (the reference's ``eval_shape`` of
    ``init_params``)."""
    return _init_tree(cfg, _Leaves(cfg, None))


def init_serving_params(cfg: ArchConfig, generator: torch.Generator
                        ) -> dict[str, Any]:
    """A serving tree made directly: the paths, shapes and dtypes of
    ``compute_copy(cfg, init_params(cfg, generator))`` without the fp32
    tree.  Each leaf that ``compute_copy`` casts is allocated in the
    compute dtype and filled from fp32 draws of at most ``_DRAW_ELEMENTS``
    (one layer of a stacked leaf, a block of the embedding's or the head's
    rows), so the peak is the tree plus one draw: internvl2-26b's 39.8 GB
    of bf16 where the fp32 init alone would be 79.6 GB.  The values are
    other draws from the same distributions as ``init_params``'s."""
    return _init_tree(cfg, _Leaves(cfg, generator, serving=True))


def compute_copy(cfg: ArchConfig, params: dict[str, Any]) -> dict[str, Any]:
    """The parameters with every leaf that the reference casts at each use
    held in the compute dtype already.  A cast gives the same values once
    as at every use, so serving from this copy changes no result and saves
    re-casting the weights on every step; a leaf already in the compute
    dtype (a tree from :func:`init_serving_params`) is kept, not copied.
    For serving only: training casts at each use, as the reference does,
    so that the fp32 leaves get fp32 gradients."""
    def walk(node: Any, key: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        return cast(node, cfg.compute_dtype) if key in _CAST_ON_USE else node

    return walk(params, "")


def _layers(seg: Any, count: int, axis: int = 0) -> list[Any]:
    """The ``count`` layers of a stacked segment (layer axis ``axis``: 1
    behind a gang's member axis), as views: one ``torch.unbind`` of each
    stacked leaf, whose backward is one ``stack`` (indexing each layer would
    fill a zero tensor the size of the whole stack, per layer, in the
    backward)."""
    if isinstance(seg, dict):
        per_key = {k: _layers(v, count, axis) for k, v in seg.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(count)]
    return list(torch.unbind(seg, dim=axis))


def _zero_aux(device: torch.device | str, shape: tuple[int, ...] = ()
              ) -> dict[str, torch.Tensor]:
    """Zero aux losses: the sum's start, and a model without MoE layers'
    (``shape`` (M,) for a gang's members, each summing its own)."""
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("load_balance", "router_z", "dropped")}


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

#: a layer's leaves that act on the residual stream itself: with
#: sequence-parallel activations they see this rank's shard of the tokens
_STREAM_LEAVES = ("norm1", "norm2", "branch_norm_attn", "branch_norm_ssm")


def _on_shard(lp: dict[str, Any], seq: bool) -> dict[str, Any]:
    """A layer's parameters with the leaves that act on the residual
    stream entering through f where the stream is this rank's sequence
    shard (``seq``): each rank's tokens give them a part of their
    gradient, summed over ``model``."""
    if not seq:
        return lp
    return {k: (tree_map(mesh_ctx.model_copy, v) if k in _STREAM_LEAVES else v)
            for k, v in lp.items()}


def _norm(x: torch.Tensor, p: Any, eps: float) -> torch.Tensor:
    """LayerNorm for a ``{"scale", "bias"}`` dict (an ``enc`` layer's),
    RMSNorm for a scale (reference ``_norm``)."""
    if isinstance(p, dict):
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p, eps)


def _attn_sublayer(cfg: ArchConfig, kind: str, h: torch.Tensor,
                   lp: dict[str, Any], positions: torch.Tensor,
                   cache: dict | None, seq: bool = False
                   ) -> tuple[torch.Tensor, dict | None]:
    attn_kind = _ATTN_KIND.get(kind, kind)
    return attn_block(
        h, lp["attn"],
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, kind=attn_kind, window=cfg.window,
        positions=positions,
        rope_theta=(cfg.rope_theta_global if attn_kind == "attn"
                    else cfg.rope_theta),
        q_chunk=cfg.attn_q_chunk, softcap=cfg.logit_softcap,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
        compute_dtype=cfg.compute_dtype, use_kernels=cfg.use_kernels,
        cache=cache, seq=seq)


def _ssm_sublayer(cfg: ArchConfig, h: torch.Tensor, lp: dict[str, Any],
                  cache: dict | None, seq: bool = False
                  ) -> tuple[torch.Tensor, dict | None]:
    return mamba2_block(
        h, lp["ssm"], d_inner=cfg.d_inner, state_dim=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
        conv_width=cfg.ssm_conv, chunk=cfg.ssm_chunk,
        compute_dtype=cfg.compute_dtype, cache=cache,
        use_kernels=cfg.use_kernels, seq=seq)


def layer_body(cfg: ArchConfig, kind: str, x: torch.Tensor,
               lp: dict[str, Any], positions: torch.Tensor,
               cache: dict | None = None, moe_groups: int = 1,
               seq: bool = False
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None, dict | None]:
    """One layer: returns (x, aux, new_cache).  ``aux`` is None for a layer
    without an MoE FFN, whose aux losses are zero (the reference returns
    zeros; here serving then allocates nothing for them).  A hybrid
    layer's cache is ``{"attn": {k, v, pos}, "ssm": {conv, ssm, pos}}``.
    ``seq``: x is this ``model`` rank's sequence shard (``positions``
    stay the whole sequence's)."""
    eps = cfg.norm_eps
    aux = None
    lp = _on_shard(lp, seq)
    h = _norm(x, lp["norm1"], eps)
    if kind == "ssm":
        y, new_cache = _ssm_sublayer(cfg, h, lp, cache, seq)
        return x + y.to(x.dtype), aux, new_cache
    if kind in HYBRID_KINDS:
        a_out, attn_cache = _attn_sublayer(
            cfg, kind, h, lp, positions, None if cache is None else cache["attn"],
            seq)
        s_out, ssm_cache = _ssm_sublayer(
            cfg, h, lp, None if cache is None else cache["ssm"], seq)
        # hymba's fusion: the mean of the branches' normed outputs, the SSM
        # branch's cast to the attention's dtype before its norm
        y = 0.5 * (rms_norm(a_out, lp["branch_norm_attn"], eps)
                   + rms_norm(s_out.to(a_out.dtype), lp["branch_norm_ssm"], eps))
        x = x + y.to(x.dtype)
        new_cache = (None if cache is None
                     else {"attn": attn_cache, "ssm": ssm_cache})
    else:
        a_out, new_cache = _attn_sublayer(cfg, kind, h, lp, positions, cache, seq)
        x = x + a_out.to(x.dtype)
    h2 = _norm(x, lp["norm2"], eps)
    if kind == "moe":
        f_out, aux = moe_block(
            h2, lp["moe"], n_experts=cfg.n_experts,
            n_shared=cfg.n_shared_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
            router_renorm=cfg.router_renorm, dispatch=cfg.moe_dispatch,
            groups=moe_groups, compute_dtype=cfg.compute_dtype,
            moe_d_ff=cfg.moe_d_ff, d_ff=cfg.d_ff, seq=seq)
    else:
        f_out = mlp(h2, lp["mlp"], cfg.mlp_act, cfg.compute_dtype, d_ff=cfg.d_ff,
                    seq=seq)
    return x + f_out.to(x.dtype), aux, new_cache


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params: dict[str, Any],
                  batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """The input rows (B, S, d) in the compute dtype (reference
    ``_embed_inputs``): the token embeddings; frame embeddings times
    ``frontend_proj`` (``embeds``); or patch embeddings times
    ``frontend_proj`` followed by the token embeddings on the sequence axis
    (``mixed``: the patches take the first positions)."""
    cd = cfg.compute_dtype
    layout = _vocab_view(cfg)["embed"]
    if cfg.input_mode == "tokens":
        return embed_tokens(batch["tokens"], params["embed"], cfg.embed_scale, cd,
                            layout)
    if cfg.input_mode == "embeds":
        return cast(batch["embeds"], cd) @ cast(params["frontend_proj"], cd)
    patches = cast(batch["patch_embeds"], cd) @ cast(params["frontend_proj"], cd)
    tokens = embed_tokens(batch["tokens"], params["embed"], cfg.embed_scale, cd,
                          layout)
    return torch.cat([patches, tokens], dim=-2)


def _vocab_view(cfg: ArchConfig) -> dict[str, str]:
    """How this rank holds the embedding and the head (the rules' layout
    on the ambient ``model`` axis)."""
    return shd.vocab_view(cfg, mesh_ctx.axis_size("model"))


def _save_dots(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    """remat="dots": keep the matrix products without batch dims (the
    projections and MLP products, ``aten.mm``), recompute the rest, as
    ``checkpoint_dots_with_no_batch_dims`` does in the reference."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn):
    """``fn`` run bare (``"none"``), under ``torch.utils.checkpoint``
    (``"full"``: everything inside is recomputed in the backward) or
    checkpointed with the matrix products saved (``"dots"``)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kwargs: dict[str, Any] = {"use_reentrant": False}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, **kwargs)


def _over_members(fn, members: bool, out_dims: Any = 0):
    """``fn``, or for a gang ``fn`` under ``torch.func.vmap`` over the
    leading member axis of every argument."""
    return torch.func.vmap(fn, out_dims=out_dims) if members else fn


def seq_parallel(seq_spec: Any) -> bool:
    """Whether ``seq_spec`` shards the residual stream's sequence: a spec
    given, under a mesh with more than one ``model`` rank."""
    return seq_spec is not None and mesh_ctx.axis_size("model") > 1


def backbone(cfg: ArchConfig, params: dict[str, Any],
             batch: dict[str, torch.Tensor], moe_groups: int = 1,
             members: bool = False, seq_spec: Any = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Embeddings → layers → final norm.  Returns (x (B,S,d), aux losses
    summed over the layers, each (M,) for a gang).  With ``seq_spec``
    under a ``model`` axis of M > 1, x is this rank's (B, S/M, d) shard of
    the sequence (module docstring); S must divide by M.

    With ``members`` the parameters and tokens of a gang carry a leading
    member axis and x is (M,B,S,d): every piece (the embedding, each layer
    inside its checkpoint, the final norm) runs under ``torch.func.vmap``,
    so one pass serves all members (the kernels' vmap rules fold the members
    into their batch)."""
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    tables = {k: params[k] for k in ("embed", "frontend_proj") if k in params}
    x = _over_members(lambda b, p: _embed_inputs(cfg, p, b),
                      members)(inputs, tables)
    b, s = x.shape[-3], x.shape[-2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    seq = seq_parallel(seq_spec)
    if seq:
        mesh_ctx.check_seq(s)
        x = mesh_ctx.leave_replicated(x, seq)
    aux_total = _zero_aux(x.device, x.shape[:-3])
    for (kind, count), seg in zip(cfg.segments(), params["segments"]):
        def body(xc, lp, _kind=kind):
            xn, aux, _ = layer_body(cfg, _kind, xc, lp, positions,
                                    moe_groups=moe_groups, seq=seq)
            return xn, aux

        # an MoE layer's aux losses come back per member; other kinds have
        # none (None)
        run = _remat(cfg, _over_members(
            body, members, out_dims=(0, 0 if kind == "moe" else None)))
        for lp in _layers(seg, count, axis=int(members)):
            x, aux = run(x, lp)
            if aux is not None:
                aux_total = {k: v + aux[k] for k, v in aux_total.items()}
    final = _over_members(lambda xf, w: _norm(xf, w, cfg.norm_eps), members)
    final_norm = params["final_norm"]
    if seq:
        final_norm = tree_map(mesh_ctx.model_copy, final_norm)
    return final(x, final_norm), aux_total


def _head(cfg: ArchConfig, params: dict[str, Any]) -> torch.Tensor:
    return (params["lm_head"] if not cfg.tie_embeddings
            else params["embed"].mT)


def _partial_logits(x: torch.Tensor, head: torch.Tensor,
                    compute_dtype: str | torch.dtype) -> torch.Tensor:
    """Logits (fp32) from this rank's block of d rows of the head: the
    product of x's matching columns (after f), summed over ``model``."""
    rows = head.shape[-2]
    xs = mesh_ctx.model_copy(x).narrow(-1, mesh_ctx.model_rank() * rows, rows)
    return mesh_ctx.model_sum(unembed(xs, head, compute_dtype).float())


def forward(cfg: ArchConfig, params: dict[str, Any],
            batch: dict[str, torch.Tensor], moe_groups: int = 1,
            seq_spec: Any = None, gather: bool = True) -> torch.Tensor:
    """Full forward pass → logits (B,S,V), sliced to ``vocab_size``.  (The
    reference also returns the MoE aux losses; here ``loss_fn`` reads them
    from ``backbone``, and serving needs only the logits.)  Under a
    ``model`` axis of M > 1 every rank returns the whole logits, or with
    ``gather`` False its own columns of a vocab-sharded head
    (:func:`sharded_logits`, as the reference's prefill leaves them);
    ``moe_groups`` and ``seq_spec`` as in :func:`backbone`."""
    x, _ = backbone(cfg, params, batch, moe_groups, seq_spec=seq_spec)
    head = _head(cfg, params)
    kind = _vocab_view(cfg)["head"]
    seq = seq_parallel(seq_spec)
    if kind == "vocab":
        local = unembed(mesh_ctx.enter(x, seq), head, cfg.compute_dtype)
        if not gather:
            return _own_columns(cfg, local)
        logits = mesh_ctx.model_gather(local, -1, summed=False)
    elif kind == "d":
        logits = _partial_logits(mesh_ctx.enter_replicated(x, seq), head,
                                 cfg.compute_dtype).to(as_dtype(cfg.compute_dtype))
    else:
        logits = unembed(mesh_ctx.enter_replicated(x, seq), head, cfg.compute_dtype)
    return logits[..., :cfg.vocab_size]


def _own_columns(cfg: ArchConfig, local: torch.Tensor) -> torch.Tensor:
    """This ``model`` rank's block of the padded vocabulary's logits, the
    columns below ``vocab_size``."""
    cols = local.shape[-1]
    keep = max(0, min(cols, cfg.vocab_size - mesh_ctx.model_rank() * cols))
    return local[..., :keep]


def _ce_terms(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              compute_dtype: str | torch.dtype, vocab_size: int,
              kind: str = "whole") -> torch.Tensor:
    """Summed masked NLL for one (B, C, d) slice.  Pad-vocab columns (>=
    ``vocab_size``) are masked out of the softmax; labels < 0 are ignored.
    ``kind`` is how this rank holds the head (:func:`_vocab_view`)."""
    if kind == "vocab":
        return _ce_terms_vocab(x, head, labels, compute_dtype, vocab_size)
    logits = (_partial_logits(x, head, compute_dtype) if kind == "d"
              else unembed(x, head, compute_dtype).float())
    if logits.shape[-1] > vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def _ce_terms_vocab(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                    compute_dtype: str | torch.dtype, vocab_size: int
                    ) -> torch.Tensor:
    """:func:`_ce_terms` on this ``model`` rank's block of the vocabulary's
    columns (vocab-parallel): the max over ``model`` (no gradient), the sum
    of ``exp`` over ``model`` and the gold logit from the rank whose block
    holds the label; pad columns masked by their global index."""
    logits = unembed(x, head, compute_dtype).float()
    cols = logits.shape[-1]
    first = mesh_ctx.model_rank() * cols
    if first + cols > vocab_size:
        col = first + torch.arange(cols, device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    top = mesh_ctx.model_max(logits.detach().amax(dim=-1))
    lse = top + torch.log(mesh_ctx.model_sum(
        torch.exp(logits - top[..., None]).sum(dim=-1)))
    local = labels - first
    mine = (local >= 0) & (local < cols)
    gold = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    gold = mesh_ctx.model_sum(torch.where(mine, gold, 0.0))
    return ((lse - gold) * (labels >= 0).float()).sum()


def loss_fn(cfg: ArchConfig, params: dict[str, Any],
            batch: dict[str, torch.Tensor], moe_groups: int = 1,
            members: bool = False, seq_spec: Any = None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked causal-LM cross entropy (+ MoE aux).  labels < 0 ignored.

    With ``cfg.loss_chunk`` the CE is computed over sequence chunks, each
    checkpointed, so the (B,S,V) logits are never resident at once.
    Returns (loss, {"ce", "loss", load_balance, router_z, dropped}).  With
    ``members`` (a gang, see :func:`backbone`) the loss and the CE are per
    member, (M,), each CE chunk under ``torch.func.vmap``.

    Over a data axis of D > 1 (the ambient mesh) the batch is this rank's
    block of the global batch and every returned value is this rank's
    share: its NLL over the global count of labels >= 0, and the MoE aux
    shares (:mod:`repro_torch.models.moe`), so the sum over the data ranks
    of the values and of their gradients is the single program's on the
    global batch.  Over a ``model`` axis every ``model`` rank returns the
    same values (``seq_spec``: see :func:`backbone`; the head's input is
    all-gathered over the sequence again)."""
    x, aux = backbone(cfg, params, batch, moe_groups, members, seq_spec)
    labels = batch["labels"]
    head = _head(cfg, params)
    kind = _vocab_view(cfg)["head"]
    seq = seq_parallel(seq_spec)
    x = (mesh_ctx.enter(x, seq) if kind == "vocab"
         else mesh_ctx.enter_replicated(x, seq))
    s = x.shape[-2]
    chunk = cfg.loss_chunk
    ce_terms = _over_members(
        functools.partial(_ce_terms, compute_dtype=cfg.compute_dtype,
                          vocab_size=cfg.vocab_size, kind=kind), members)
    if chunk and s > chunk and s % chunk == 0:
        nll_sum = torch.zeros(x.shape[:-3], dtype=torch.float32, device=x.device)
        for start in range(0, s, chunk):
            args = (x[..., start:start + chunk, :], head,
                    labels[..., start:start + chunk])
            nll_sum = nll_sum + (
                ckpt.checkpoint(ce_terms, *args, use_reentrant=False)
                if torch.is_grad_enabled() else ce_terms(*args))
    else:
        nll_sum = ce_terms(x, head, labels)
    count = (labels >= 0).flatten(-2).sum(-1)
    if mesh_ctx.dp_size() > 1:
        # this rank's share: its NLL over the global batch's label count
        count = mesh_ctx.dp_all_reduce(count)
    ce = nll_sum / count.clamp_min(1).float()
    loss = ce + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
    return loss, {"ce": ce, "loss": loss, **aux}


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------

def _kv_cache(cfg: ArchConfig, kind: str, count: int, batch: int,
              max_len: int, dtype: str | torch.dtype,
              device: torch.device | str) -> dict[str, torch.Tensor]:
    """K and V of ``count`` layers, stacked: ``max_len`` entries, or a ring
    of ``min(window, max_len)`` for a windowed kind."""
    windowed = _ATTN_KIND.get(kind, kind) == "swa" and cfg.window
    t = min(cfg.window, max_len) if windowed else max_len
    shape = (count, batch, t, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=as_dtype(dtype), device=device),
            "v": torch.zeros(shape, dtype=as_dtype(dtype), device=device)}


def _ssm_cache(cfg: ArchConfig, count: int, batch: int,
               dtype: str | torch.dtype,
               device: torch.device | str) -> dict[str, torch.Tensor]:
    """Conv state (in ``dtype``) and SSM state (fp32) of ``count`` layers,
    stacked."""
    c = init_ssm_cache(batch, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
                       cfg.ssm_groups, cfg.ssm_conv, dtype, device)
    return {k: v[None].repeat(count, *([1] * v.dim()))
            for k, v in c.items() if k != "pos"}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: str | torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda", mesh: Any = None
               ) -> dict[str, Any]:
    """Per-segment stacked caches: KV for attention and moe layers (swa
    segments hold a ring of ``min(window, max_len)`` entries), conv state
    in ``dtype`` and SSM state in fp32 for ssm, and both, nested as
    ``{"attn": {k, v}, "ssm": {conv, ssm}}``, for a hybrid segment (a
    ``hyb_l`` ring as swa's).  ``pos`` is one Python int shared by every
    slot, as in the reference, and by both halves of a hybrid cache.  An
    encoder-only config has no decode step, hence no cache: it raises.

    With a ``DeviceMesh`` (``batch`` the global batch) each leaf is
    allocated as this rank's shard by the cache's sharding
    (:func:`repro_torch.distributed.sharding.cache_shardings`): its rows
    of the batch, its KV heads or slice of the head dim, its SSM heads and
    conv channels; nothing else."""
    if not cfg.has_decode():
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    if mesh is not None:
        whole = init_cache(cfg, batch, max_len, dtype, "meta")
        specs = shd.cache_shardings(whole, mesh)

        def shard(leaf, spec):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            sl = shd.local_slices(spec, leaf.shape, mesh)
            return torch.zeros([s.stop - s.start for s in sl], dtype=leaf.dtype,
                               device=device)

        return tree_map(shard, whole, specs)
    segments = []
    for kind, count in cfg.segments():
        if kind == "ssm":
            seg = _ssm_cache(cfg, count, batch, dtype, device)
        elif kind in HYBRID_KINDS:
            seg = {"attn": _kv_cache(cfg, kind, count, batch, max_len, dtype, device),
                   "ssm": _ssm_cache(cfg, count, batch, dtype, device)}
        else:
            seg = _kv_cache(cfg, kind, count, batch, max_len, dtype, device)
        segments.append(seg)
    return {"pos": 0, "segments": segments}


def _layer_cache(kind: str, seg_cache: dict[str, Any], i: int, pos: int
                 ) -> dict[str, Any]:
    """Layer ``i``'s views of a segment's stacked cache, with ``pos``."""
    def view(c):
        return {**{k: v[i] for k, v in c.items()}, "pos": pos}

    if kind in HYBRID_KINDS:
        return {"attn": view(seg_cache["attn"]), "ssm": view(seg_cache["ssm"])}
    return view(seg_cache)


def sharded_logits(cfg: ArchConfig, x: torch.Tensor, params: dict[str, Any]
                   ) -> torch.Tensor:
    """The logits of the final-normed (B, S, d) ``x`` as this ``model`` rank
    holds the head: the whole (B, S, vocab_size); with the head
    vocab-sharded, this rank's block of the padded vocabulary's columns,
    those below ``vocab_size`` (the reference leaves its decode logits
    sharded over ``model``); for a tied table split over d, the product
    summed over ``model``."""
    head = _head(cfg, params)
    kind = _vocab_view(cfg)["head"]
    if kind == "vocab":
        return _own_columns(cfg, unembed(x, head, cfg.compute_dtype))
    if kind == "d":
        logits = _partial_logits(x, head, cfg.compute_dtype).to(
            as_dtype(cfg.compute_dtype))
    else:
        logits = unembed(x, head, cfg.compute_dtype)
    return logits[..., :cfg.vocab_size]


def decode_step(cfg: ArchConfig, params: dict[str, Any], cache: dict[str, Any],
                token: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
    """One autoregressive step → (logits (B,V), cache).  token: (B, 1).

    The cache tensors are updated in place; the returned cache holds the
    same tensors and ``pos + 1``.  The conv state of an ssm or hybrid
    segment takes the dtype the reference's concatenation gives it (cache
    and compute dtype promoted): a bf16 conv cache under fp32 compute
    becomes fp32 at the first step, as the reference's returned cache
    does.

    Under a ``model`` axis of M > 1 (the ambient mesh) the parameters and
    the cache are this rank's shards (``init_cache`` with the mesh), token
    this rank's rows of the batch; each block computes what the rank's
    cache shard holds (:func:`repro_torch.distributed.sharding.cache_view`)
    and the logits are this rank's columns (:func:`sharded_logits`)."""
    if not cfg.has_decode():
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    pos = cache["pos"]
    b = token.shape[0]
    x = embed_tokens(token, params["embed"], cfg.embed_scale, cfg.compute_dtype,
                     _vocab_view(cfg)["embed"])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for (kind, count), seg, seg_cache in zip(
            cfg.segments(), params["segments"], cache["segments"]):
        hybrid = kind in HYBRID_KINDS
        # the SSM states, which the mixer returns anew (the KV cache is
        # written in place by the attention)
        ssm = seg_cache["ssm"] if hybrid else seg_cache if kind == "ssm" else None
        if ssm is not None:
            ssm["conv"] = ssm["conv"].to(
                torch.promote_types(ssm["conv"].dtype, x.dtype))
        for i, lp in enumerate(_layers(seg, count)):
            x, _, nc = layer_body(cfg, kind, x, lp, positions,
                                  cache=_layer_cache(kind, seg_cache, i, pos))
            if ssm is not None:
                nc = nc["ssm"] if hybrid else nc
                ssm["conv"][i] = nc["conv"]
                ssm["ssm"][i] = nc["ssm"]
    x = _norm(x, params["final_norm"], cfg.norm_eps)
    logits = sharded_logits(cfg, x, params)[:, 0]
    return logits, {"pos": pos + 1, "segments": cache["segments"]}
