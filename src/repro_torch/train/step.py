"""Train-step factory: loss → grads → AdamW, with microbatching and the
optional int8 round trip of the gradients (port of ``repro.train.step``).

The state is ``{"params", "opt", "step"}`` as in the reference.  The step
writes the new parameters, optimizer state and step count into the state's
tensors, every leaf keeping its storage, and returns the state (the
reference's loop donates it).  The batch's inputs follow the config's input
mode (tokens, frame embeddings, or patch embeddings then tokens); the step
passes them through as they are.

**Compiled.** The reference jits the step with the state donated
(``jax.jit(step_fn, donate_argnums=(0,))``), on whatever mesh it runs.
:class:`GraphedTrainStep` is the port's form of it on a CUDA device: the
step captured once as a CUDA graph over the state and static batch
buffers, and replayed every step (:class:`CapturedStep`, which the gang's
step is too); on a mesh whose collectives run over NCCL, the mesh step
with its collectives, on every rank.

**On a device mesh** (``(data, model)`` or ``(pod, data, model)``).  A
state whose leaves are DTensors (:func:`init_train_state` or
:func:`distribute_state` with a mesh, placed by
:func:`repro_torch.distributed.sharding.state_shardings`: each parameter
as the rules store it over ``model``, m, v and master also sharded over
the data-parallel axes by ZeRO-1) takes the mesh step, one process a
device.  Each rank's batch is its data-parallel block of the global batch
(every ``model`` rank of a block gets the same rows).  The compute runs
on local tensors: the model computes each block's ``model`` slice
(tensor parallelism, :mod:`repro_torch.models.transformer`), and the loss
is this rank's share (its NLL over the global label count, the MoE aux
shares), so the sum over the data-parallel axes of the shares' gradients
is the single program's gradient on the global batch.  The step sums the
gradients over the data-parallel axes only (a leaf kept whole over
``model`` has the same gradient on every ``model`` rank), applies the int8
round trip to the sums (each leaf's scale from its whole), clips by the
global norm (the squares of ``model``-sharded leaves summed over
``model``, a whole leaf's counted once), updates each rank's ZeRO-1 shard
of m, v and master from the matching slice of its gradients, and
all-gathers the new parameters over the data-parallel axes within each
``model`` slice.  With one ``model`` rank these are the data-parallel
step's numbers, bit for bit.  ``seq_spec`` (or ``cfg.seq_shard``) shards
the residual stream's sequence over ``model`` between blocks.

With ``n_micro`` = n > 1 over D > 1 data ranks, microbatch i is block i of
the global batch of B rows, as in the reference, not a block of each
rank's rows: each rank first takes its share of every microbatch, the
global rows ``i·B/n + r·B/(n·D) + [0, B/(n·D))``, by an all-to-all over
the data-parallel axes (:func:`repro_torch.distributed.context.dp_microbatches`;
B must divide by n·D).  Each microbatch is then a data-parallel step of
its own on the ranks' shares (the label count, the MoE statistics, the
dispatch groups and capacity drops are the microbatch's), and the metrics
are the reference's: the mean loss, the last microbatch's aux.  With one
data rank, or n = 1, nothing moves.

:func:`train_memory_gb` reckons what a train state and one step need on
each device of a (data, model) mesh: the parameters and their gradients
by ``param_dtype``, AdamW's state, its update's temporaries, and the
activations from the step's tokens, the layers, the vocabulary,
``loss_chunk`` and ``seq_shard``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.bridge import flatten
from repro_torch.capture import CapturedStep
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import as_dtype
from repro_torch.models.transformer import (
    HYBRID_KINDS, init_abstract_params, init_params, loss_fn,
)
from repro_torch.optim.adamw import (
    AdamW, accumulate_grads, compress_int8, decompress_int8,
    value_and_grad,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1              # gradient-accumulation microbatches
    moe_groups: int = 1           # GShard dispatch groups
    compress_grads: bool = False  # int8 round trip of the summed gradients
    #: sequence-parallel activations: a Spec (dp, "model", None) of the
    #: (B, S, d) residual stream (the reference's NamedSharding), or None
    seq_spec: Any = None


def _check_seq_spec(spec: Any) -> None:
    """Raises unless ``spec`` shards a (B, S, d) activation's sequence over
    ``model`` and nothing else over it: (None | "data" | ("pod", "data"),
    "model", None)."""
    entries = tuple(spec) if isinstance(spec, (shd.Spec, tuple, list)) else None
    dp = (None, "data", ("pod", "data"), ["pod", "data"])
    if (entries is None or len(entries) != 3 or entries[0] not in dp
            or entries[1] != "model" or entries[2] is not None):
        raise NotImplementedError(
            f"seq_spec {spec!r}: sequence-parallel activations are ported as "
            "the sequence over the model axis, (dp, 'model', None)")


def make_train_step(cfg: ArchConfig, opt: AdamW,
                    step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.  Batch
    leaves have the batch dim first; with ``n_micro`` > 1 the batch is split
    on it and the grads are averaged over the pieces.  A state of DTensors
    takes the data-parallel step (module docstring); its metrics are the
    global batch's."""
    seq_spec = step_cfg.seq_spec
    if seq_spec is None and cfg.seq_shard:
        seq_spec = shd.Spec((("pod", "data"), "model", None))
    if seq_spec is not None:
        _check_seq_spec(seq_spec)

    def _loss(params, batch):
        return loss_fn(cfg, params, batch, step_cfg.moe_groups, seq_spec=seq_spec)

    def grads_of(params, batch):
        if step_cfg.n_micro > 1:
            n = step_cfg.n_micro
            # under a mesh each rank's share of every microbatch; else a
            # reshape (and with one data rank, the same reshape)
            micro = {k: mesh_ctx.dp_microbatches(v, n) for k, v in batch.items()}
            grads, loss, aux = accumulate_grads(_loss, params, micro, n)
            return (loss, aux), grads
        return value_and_grad(_loss, params, batch)

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]
                   ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        if isinstance(state["step"], DTensor):
            return _dp_step(state, batch)
        params = state["params"]
        (loss, aux), grads = grads_of(params, batch)
        if step_cfg.compress_grads:
            grads = decompress_int8(compress_int8(grads))
        _, _, opt_metrics = opt.update(grads, state["opt"], params)
        state["step"].add_(1)
        return state, {"loss": loss, **aux, **opt_metrics}

    def _dp_step(state, batch):
        mesh = state["step"].device_mesh
        batch = tree_map(shd.local, batch)
        n, d = step_cfg.n_micro, mesh_ctx.dp_size(mesh)
        rows = d * next(iter(batch.values())).shape[0]
        if n > 1 and rows % (n * d):
            raise ValueError(
                f"a global batch of {rows} rows does not split into n_micro={n} "
                f"microbatches over {d} data ranks: it must divide by n_micro x "
                f"data ranks = {n * d}")
        with mesh_ctx.set_mesh(mesh):
            params = tree_map(shd.local, state["params"])
            (loss, aux), grads = grads_of(params, batch)
            for g in tree_leaves(grads):
                mesh_ctx.dp_all_reduce(g)
            shares = {"loss": loss, **aux}
            total = mesh_ctx.dp_all_reduce(torch.stack(
                [v.float() for v in shares.values()]))
            metrics = dict(zip(shares, total.unbind(0)))
            tp = mesh_ctx.axis_size("model", mesh) > 1
            split = tree_map(
                lambda p: tp and shd.sharded_over(shd.spec_of(p), "model"),
                state["params"])
            if step_cfg.compress_grads:
                grads = _int8_round_trip(grads, split)
            gnorm = _tp_global_norm(grads, split)
            opt_state = state["opt"]
            # ZeRO-1's data-parallel slices of this rank's model shards
            specs = tree_map(lambda m: shd.without_axis(shd.spec_of(m), "model"),
                             opt_state["master"])
            slices = tree_map(lambda p, spec: shd.local_slices(spec, p.shape, mesh),
                              params, specs)
            _, _, opt_metrics = opt.update(
                tree_map(lambda g, sl: g[sl], grads, slices),
                {"m": tree_map(shd.local, opt_state["m"]),
                 "v": tree_map(shd.local, opt_state["v"]),
                 "master": tree_map(shd.local, opt_state["master"]),
                 "count": shd.local(opt_state["count"])},
                tree_map(lambda p, sl: p[sl], params, slices),
                grad_norm=gnorm)
            tree_map(lambda p, spec: shd.gather_shards(p, spec, mesh),
                     params, specs)
            shd.local(state["step"]).add_(1)
        return state, {**metrics, **opt_metrics}

    return train_step


class GraphedTrainStep(CapturedStep):
    """``step_fn`` (from :func:`make_train_step`) as a :class:`CapturedStep`,
    the state updated in place: the reference's ``jax.jit(step_fn,
    donate_argnums=(0,))``.  On a card the run's first step is the warm-up
    (a real step: the state is neither copied nor rolled back), and every
    step after it one replay of the captured graph.  A state of DTensors
    takes the mesh step, captured on every rank (each rank's own batch):
    on a card its mesh must run every collective over NCCL, and on one that
    does not (gloo over more than one rank) this raises, naming the
    backend; after the capture the ranks agree that every rank captured
    (:class:`repro_torch.capture.CapturedStep`).

    Called as ``step(state, batch) -> (state, metrics)``, always with the
    state it was built with.  Each call first copies the batch (host arrays
    or tensors of ``example_batch``'s shapes and dtypes) into static
    buffers on the state's device; a host batch goes through pinned memory
    without a synchronisation (the host waits only until the previous
    step's copy has left the pinned buffer).  A replay's metrics are the
    graph's output buffers, overwritten by the next replay."""

    what = "train step"

    def __init__(self, step_fn: Callable, state: dict[str, Any],
                 example_batch: dict[str, Any]) -> None:
        super().__init__(shd.local(state["step"]).device,
                         state["step"].device_mesh
                         if isinstance(state["step"], DTensor) else None)
        self._step_fn = step_fn
        self.state = state
        host = {k: torch.as_tensor(v) for k, v in example_batch.items()}
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                      for k, v in host.items()}
        if self.device.type == "cuda":
            self._pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                            for k, v in host.items()}
            #: recorded after each copy out of the pinned buffers
            self._copied = torch.cuda.Event()

    def __call__(self, state: dict[str, Any], batch: dict[str, Any]
                 ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        if state is not self.state:
            raise ValueError("a graphed train step runs on the state it was "
                             "built with, which each step updates in place")
        self._load(batch)
        return self.state, self._run_step()[1]

    def _eager_step(self) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        return self._step_fn(self.state, self.batch)

    def _load(self, batch: dict[str, Any]) -> None:
        """The batch copied into the static buffers, on the current stream."""
        if set(batch) != set(self.batch):
            raise ValueError(f"batch keys {sorted(batch)}, want {sorted(self.batch)}")
        values = {k: torch.as_tensor(v) for k, v in batch.items()}
        for k, v in values.items():
            if v.shape != self.batch[k].shape or v.dtype != self.batch[k].dtype:
                raise ValueError(f"batch {k!r}: {v.dtype} {tuple(v.shape)}, want "
                                 f"{self.batch[k].dtype} {tuple(self.batch[k].shape)}")
        on_host = self.device.type == "cuda" and all(
            v.device.type == "cpu" for v in values.values())
        if on_host:
            self._copied.synchronize()
            for k, v in values.items():
                self._pinned[k].copy_(v)
            values = self._pinned
        for k, v in values.items():
            self.batch[k].copy_(v, non_blocking=on_host)
        if on_host:
            self._copied.record()


def _tp_global_norm(grads: Any, split: Any) -> torch.Tensor:
    """The global norm of gradients held as ``model`` shards (``split``
    True) or whole on every ``model`` rank: the shards' squares summed over
    ``model``, a whole leaf's counted once. With no leaf split it is
    ``global_norm``, bit for bit (the same sum in the same order)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    flags = tree_leaves(split)
    sharded = sum((q for q, f in zip(sq, flags) if f), torch.zeros_like(sq[0]))
    whole = sum((q for q, f in zip(sq, flags) if not f), torch.zeros_like(sq[0]))
    return torch.sqrt(mesh_ctx.model_sum(sharded) + whole)


def _int8_round_trip(grads: Any, split: Any) -> Any:
    """``decompress_int8(compress_int8(grads))`` with each leaf's scale from
    its whole: a ``model`` shard's largest magnitude is the maximum over
    ``model``. With no leaf split it is that round trip, bit for bit (the
    same operations in the same order)."""
    def one(g, sharded):
        amax = torch.max(torch.abs(g))
        if sharded:
            amax = mesh_ctx.model_max(amax)
        scale = (amax + 1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.to(torch.float32) * scale.to(torch.float32)
    return tree_map(one, grads, split)


def init_train_state(cfg: ArchConfig, opt: AdamW, generator: torch.Generator,
                     mesh: Any = None) -> dict[str, Any]:
    """Random parameters on the generator's device, their optimizer state
    and step 0.  With a ``DeviceMesh``, the state is stored as DTensors by
    the sharding rules: each parameter (drawn whole, the same on every rank
    from the same generator, one leaf at a time) keeps this rank's slice as
    the rules store it, and each rank makes only its ZeRO-1 shard of m, v
    and master (as ``AdamW.init``: zeros, and the parameters in fp32), so
    a rank holds its shards and one drawn leaf, never the whole tree."""
    zero = torch.zeros((), dtype=torch.int32, device=generator.device)
    if mesh is None:
        params = init_params(cfg, generator)
        return {"params": params, "opt": opt.init(params), "step": zero}
    whole = init_abstract_params(cfg)
    specs = shd.state_shardings(
        {"params": whole, "opt": {"m": whole, "v": whole, "master": whole,
                                  "count": zero}}, mesh)
    param_specs, master_specs = flatten(specs["params"]), flatten(specs["opt"]["master"])
    masters = {}

    def place(path, leaf):
        sl = shd.local_slices(master_specs[path], leaf.shape, mesh)
        masters[path] = leaf[sl].detach().to(torch.float32, copy=True)
        return shd.distribute(leaf, param_specs[path], mesh)

    params = init_params(cfg, generator, place)
    paths = tree_unflatten(params, list(flatten(params)))

    def opt_part(key):
        def one(p, spec, path):
            local = (masters[path] if key == "master"
                     else torch.zeros_like(masters[path]))
            return shd.from_local(local, p.shape, spec, mesh)
        return tree_map(one, params, specs["opt"][key], paths)

    return {"params": params,
            "opt": {"m": opt_part("m"), "v": opt_part("v"),
                    "master": opt_part("master"),
                    "count": shd.distribute(zero.clone(), shd.Spec(), mesh)},
            "step": shd.distribute(zero.clone(), shd.Spec(), mesh)}


def distribute_state(state: dict[str, Any], mesh: Any) -> dict[str, Any]:
    """A whole train state (the same on every rank) stored as DTensors by
    the sharding rules; each rank keeps its slices."""
    return tree_map(lambda leaf, spec: shd.distribute(leaf, spec, mesh),
                    state, shd.state_shardings(state, mesh))


def abstract_train_state(cfg: ArchConfig, opt: AdamW) -> dict[str, Any]:
    """The train state's paths, shapes and dtypes as meta tensors (the
    reference's ``eval_shape``): nothing is drawn or allocated."""
    params = init_abstract_params(cfg)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


#: bytes a parameter holds in AdamW's state (fp32 master, m and v),
#: sharded over the data ranks by ZeRO-1.  The parameter and its gradient
#: are in ``param_dtype`` on every device (:func:`replicated_bytes`):
#: AdamW keeps its own fp32 master, so bf16 parameters hold 4 bytes, fp32 8
SHARDED_BYTES = 12
#: fp32 temporaries of one leaf that AdamW's update holds at once, one leaf
#: at a time (the clipped gradient, m̂, v̂, the step and the expressions
#: between them): counted against the largest leaf's shard
UPDATE_TEMPORARIES = 7
#: fp32-sized copies of one CE chunk's logits alive at once in the
#: backward: the product in the compute dtype and its fp32 cast, the
#: softmax's exponentials, the gradient and its cast back; and of a
#: vocab-parallel head's block (its max taken without a gradient, its
#: exponentials summed over ``model``)
LOGIT_COPIES = {"whole": 5, "d": 5, "vocab": 2}
#: what a card holds beyond the step's tensors: the CUDA libraries'
#: workspaces, the batch and the caching allocator's rounding (the card's
#: peaks read 0.1-2.3 GB over the dry run's count of the same step's
#: tensors: ``launch.dryrun``'s counter on meta tensors)
WORKSPACE_GB = 3.0
#: bytes a parameter holds in ``accumulate_grads``' fp32 sum of the
#: microbatches' gradients, beside each microbatch's (``n_micro`` > 1)
ACCUMULATOR_BYTES = 4
#: the step's tokens on a data rank that :func:`train_memory_gb` reckons
#: by default: the 4 x 2048 batch every one-card train path runs
ROWS, SEQ = 4, 2048


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


def params_per_device(cfg: ArchConfig, model: int = 1) -> float:
    """Parameters a device holds with ``model`` ranks on the ``model`` axis:
    each leaf the sharding rules split over ``model`` a 1/model share, the
    others whole (the rules on the tree's shapes; nothing allocated)."""
    if model == 1:
        return float(cfg.param_count())
    params = init_abstract_params(cfg)
    specs = shd.params_shardings(params, shd.AxisSizes({"data": 1, "model": model}))
    return float(sum(leaf.numel() / (model if shd.sharded_over(spec, "model") else 1)
                     for leaf, spec in zip(tree_leaves(params), shd.spec_leaves(specs))))


def replicated_bytes(cfg: ArchConfig) -> int:
    """Bytes a parameter and its gradient hold on every device that holds
    it: two of ``param_dtype``'s (fp32: 8; bf16: 4)."""
    return 2 * as_dtype(cfg.param_dtype).itemsize


def layer_width(cfg: ArchConfig, model: int = 1) -> float:
    """Elements a token holds in one layer's recompute and backward on a
    ``model`` rank, the widest of the config's layer kinds: its input
    (d_model), the attention's queries, keys, values and output (this
    rank's heads), the MLP's gate, up and their product (this rank's
    hidden units), an MoE layer's K copies of the token and of its
    expert's output (fp32: twice) and the experts' gate, up and product
    at this rank's f, the Mamba2 mixer's in_proj output and its scan's
    input and output (this rank's share)."""
    d, widths = cfg.d_model, []
    for kind in set(cfg.layer_types):
        width = d
        if kind != "ssm":
            width += 2 * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim / model
        if kind == "ssm" or kind in HYBRID_KINDS:
            gn = cfg.ssm_groups * cfg.ssm_state
            width += (3 * cfg.d_inner + 2 * gn + cfg.ssm_heads) / model
        if kind == "moe":
            width += cfg.top_k * (3 * d + 3 * cfg.moe_d_ff / model)
        elif kind != "ssm":
            width += 3 * cfg.d_ff / model
        widths.append(width)
    return max(widths)


def activation_gb(cfg: ArchConfig, model: int = 1, rows: int = ROWS,
                  seq: int = SEQ) -> dict[str, float]:
    """GB of a step's activations on a ``model`` rank for ``rows`` x
    ``seq`` tokens (a data rank's, or a microbatch's share of them), with
    full remat: the residual stream saved at every layer's checkpoint in
    the compute dtype (a 1/model share of the sequence where ``seq_shard``
    splits it), one layer's recompute (:func:`layer_width`), and
    LOGIT_COPIES fp32 copies of the logits of one CE chunk (``loss_chunk``
    positions where the CE is chunked, else the sequence) over this rank's
    vocabulary (a 1/model share where the head is vocab-parallel:
    ``sharding.vocab_view``)."""
    cb = as_dtype(cfg.compute_dtype).itemsize
    tokens = rows * seq
    split = model if cfg.seq_shard and model > 1 else 1
    chunk = cfg.loss_chunk
    chunk = chunk if chunk and seq > chunk and seq % chunk == 0 else seq
    head = shd.vocab_view(cfg, model)["head"]
    vocab = cfg.padded_vocab / (model if head == "vocab" else 1)
    return {"residual_gb": cfg.n_layers * tokens * cfg.d_model * cb / split / 1e9,
            "layer_gb": tokens * layer_width(cfg, model) * cb / 1e9,
            "logits_gb": LOGIT_COPIES[head] * rows * chunk * vocab * 4 / 1e9}


def train_memory_gb(cfg: ArchConfig, data: int = 1, model: int = 1,
                    n_micro: int = 1, rows: int = ROWS, seq: int = SEQ
                    ) -> dict[str, float]:
    """GB that training ``cfg`` on a (``data``, ``model``) mesh needs on each
    device, ``rows`` x ``seq`` tokens a data rank, reckoned before anything
    is allocated: the state (:func:`replicated_bytes` a parameter the
    device holds, plus SHARDED_BYTES of each over ``data``); AdamW's fp32
    temporaries of the largest leaf's shard; the activations of a
    microbatch's ``rows / n_micro`` rows (:func:`activation_gb`); with
    ``n_micro`` > 1 the gradients' fp32 sum (ACCUMULATOR_BYTES a parameter
    the device holds); WORKSPACE_GB; and their total, which counts the
    larger of the update's temporaries and the activations only (the
    update runs after the backward has freed them).  ``replicated_gb`` is
    the part no data size divides."""
    n = params_per_device(cfg, model)
    per = replicated_bytes(cfg)
    replicated = (per + (ACCUMULATOR_BYTES if n_micro > 1 else 0)) * n / 1e9
    acts = activation_gb(cfg, model, max(1, rows // n_micro), seq)
    out = {"state_gb": per * n / 1e9 + SHARDED_BYTES * n / data / 1e9,
           "update_gb": (UPDATE_TEMPORARIES * 4 * largest_leaf(cfg)
                         / data / model / 1e9),
           "activation_gb": sum(acts.values()),
           "accumulator_gb": ACCUMULATOR_BYTES * n / 1e9 if n_micro > 1 else 0.0,
           "workspace_gb": WORKSPACE_GB}
    total = (out["state_gb"] + max(out["update_gb"], out["activation_gb"])
             + out["accumulator_gb"] + WORKSPACE_GB)
    return {**out, **acts, "total_gb": total, "replicated_gb": replicated}
