"""Per-architecture sharding rules (port of ``repro.distributed.sharding``).

Layout (the reference's baseline):

* batch dims → ``("pod", "data")`` (data parallel across pods too);
* tensor parallel over ``model``: attention heads (wq/wk/wv out-dim, wo
  in-dim), the MLP hidden size, each MoE expert's hidden size, SSD
  ``d_inner`` and the vocabulary (embedding rows, logits);
* a stacked segment's leading layer axis is never sharded;
* ZeRO-1: the optimizer's m, v and master also shard their largest free
  axis over the data-parallel axes (leaves of 1 MiB or more).

Two layers:

* **the rules**, pure functions of (path, shape, mesh shape) returning a
  :class:`Spec`: one entry per leading dim, each ``None``, an axis name or
  a tuple of names (the entries of the reference's ``PartitionSpec``; a
  spec may be shorter than the leaf's rank).  A
  "mesh" here is anything with axis sizes: a ``DeviceMesh``, or an object
  whose ``shape`` maps axis names to sizes and that has ``axis_names`` (the
  reference's meshes and the tests' stubs), so the rules run with no
  device at all.  ``*_shardings`` return trees of specs in the tree's
  nesting;
* **placements**: :func:`placements` turns a spec into ``DTensor``
  placements on a ``DeviceMesh`` (a dim sharded over ``("pod", "data")``
  is ``Shard(dim)`` on both mesh dims, major to minor as JAX orders them),
  :func:`local_slices` says which slice of the full leaf a rank holds, and
  :func:`from_local` and :func:`distribute` store a rank's slice, or a
  full leaf, as a DTensor by its spec;
* **compute views** (tensor parallelism): which heads, hidden units and
  columns a ``model`` rank computes with, pure functions of (config,
  ``model`` size, rank): :func:`head_split` (query heads by whole KV
  groups, SSM heads by B/C groups), :func:`attn_view`, :func:`ssm_view`,
  :func:`hidden_view` and :func:`vocab_view`.  A rank's stored shard (the
  rules' contiguous block) is its view where the two agree; elsewhere the
  model gathers it (``repro_torch.distributed.context.model_view``).

Path names are :func:`repro_torch.bridge.flatten`'s segments
(``segments/[0]/attn/wq``), as the reference's ``_path_names`` gives them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.bridge import SEP, flatten
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed.context import DP_AXES
from repro_torch.tree import tree_map

ZERO1_MIN_BYTES = 1 << 20

Entry = Any          # None | str | tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Spec:
    """The entries of a ``PartitionSpec``, one a leading dim: None, an axis
    name or a tuple of names.  A leaf of the port's trees (not a tuple, so
    :mod:`repro_torch.tree` does not walk into it); ``tuple(spec)`` gives
    the entries."""

    entries: tuple = ()

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> Entry:
        return self.entries[i]


# ---------------------------------------------------------------------------
# Meshes as axis sizes
# ---------------------------------------------------------------------------

def axis_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh-like object with a
    ``shape`` mapping (the reference's ``Mesh``, a stub)."""
    if isinstance(mesh, DeviceMesh):
        return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def _dp_axes(sizes: dict[str, int]) -> tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in sizes)


def _dp_entry(sizes: dict[str, int]) -> Entry:
    """The batch dim's entry: ``("pod", "data")``, ``"data"`` or None."""
    dp = _dp_axes(sizes)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def _entry_size(sizes: dict[str, int], entry: Entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


@dataclasses.dataclass(frozen=True)
class AxisSizes:
    """A mesh as its axis sizes alone (what the rules read), e.g.
    ``AxisSizes({"data": 2, "model": 4})``: reckoning with no device."""

    shape: dict

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def param_spec(names: Sequence[str], ndim: int) -> Spec:
    """The spec of one parameter leaf, by its path names and rank."""
    name = names[-1]
    parents = set(names[:-1])
    routed = "moe" in parents and "shared" not in parents

    def lead(base):               # a stacked segment's layer axis
        return (None,) * (ndim - base)

    if name == "embed":
        return Spec(("model", None))
    if name == "lm_head":
        return Spec((None, "model"))
    if name == "frontend_proj":
        return Spec((None, None))
    if name in ("wq", "wk", "wv", "in_proj"):
        return Spec((*lead(2), None, "model"))
    if name in ("wi", "wi_gate", "wi_up"):
        if routed:
            return Spec((*lead(3), None, None, "model"))  # (E, d, ffm)
        return Spec((*lead(2), None, "model"))
    if name == "wo":
        if routed:
            return Spec((*lead(3), None, "model", None))  # (E, ffm, d)
        return Spec((*lead(2), "model", None))
    if name == "out_proj":
        return Spec((*lead(2), "model", None))
    if name == "conv_w":
        return Spec((*lead(2), None, "model"))
    if name in ("conv_b", "bi"):
        return Spec((*lead(1), "model"))
    if name == "norm" and "ssm" in parents:               # (d_inner,) gated norm
        return Spec((*lead(1), "model"))
    if name in ("router", "gate"):
        return Spec((*lead(2), None, None))
    # norms, biases, A_log, D, dt_bias, q_norm/k_norm, scalars
    return Spec((None,) * ndim)


def zero1_spec(spec: Spec, shape: Sequence[int], mesh: Any) -> Spec:
    """``spec`` with the data-parallel axes on the leaf's largest unsharded
    axis that has at least as many elements as data-parallel ranks (ZeRO-1);
    unchanged for a leaf under ZERO1_MIN_BYTES in fp32."""
    numel = 1
    for s in shape:
        numel *= s
    if numel * 4 < ZERO1_MIN_BYTES:
        return spec
    sizes = axis_sizes(mesh)
    dp = _dp_axes(sizes)
    if not dp:
        return spec
    n_dp = _entry_size(sizes, dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = -1, 0
    for i, (e, size) in enumerate(zip(entries, shape)):
        if e is None and size > best_size and size >= n_dp:
            best, best_size = i, size
    if best < 0:
        return spec
    entries[best] = dp if len(dp) > 1 else dp[0]
    return Spec(tuple(entries))


def fit_spec(spec: Spec, shape: Sequence[int], mesh: Any) -> Spec:
    """Drop the sharding of each dim its axes do not divide; an odd-vocab
    (V, d) table whose row sharding was dropped shards d over ``model``
    instead."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is not None and dim % _entry_size(sizes, entry) != 0:
            entry = None
        out.append(entry)
    if (len(shape) == 2 and out[0] is None and out[1] is None
            and spec and spec[0] == "model"
            and shape[1] % _entry_size(sizes, "model") == 0):
        out[1] = "model"
    return Spec(tuple(out))


def batch_spec(mesh: Any) -> Spec:
    return Spec((_dp_entry(axis_sizes(mesh)),))


def _names(key: str) -> list[str]:
    return key.split(SEP)


def _map_with_path(fn, tree: Any) -> Any:
    """``fn(path names, leaf)`` over a tree's leaves, in its nesting."""
    flat = flatten(tree)
    keys = iter(flat)
    return tree_map(lambda leaf: fn(_names(next(keys)), leaf), tree)


def params_shardings(params: Any, mesh: Any) -> Any:
    """The spec of every parameter leaf, fitted to its shape."""
    return _map_with_path(
        lambda names, leaf: fit_spec(param_spec(names, leaf.dim()), leaf.shape, mesh),
        params)


def opt_shardings(opt: Any, mesh: Any) -> Any:
    """m, v and master follow the parameters, plus ZeRO-1; count is
    replicated."""
    def one(names, leaf):
        if names[0] == "count":
            return Spec()
        spec = fit_spec(param_spec(names[1:], leaf.dim()), leaf.shape, mesh)
        return fit_spec(zero1_spec(spec, leaf.shape, mesh), leaf.shape, mesh)
    return _map_with_path(one, opt)


def state_shardings(state: dict[str, Any], mesh: Any) -> dict[str, Any]:
    return {"params": params_shardings(state["params"], mesh),
            "opt": opt_shardings(state["opt"], mesh),
            "step": Spec()}


def batch_shardings(batch: Any, mesh: Any) -> Any:
    dp = _dp_entry(axis_sizes(mesh))
    return tree_map(lambda leaf: fit_spec(Spec((dp,) + (None,) * (leaf.dim() - 1)),
                                          leaf.shape, mesh), batch)


def cache_leaf_spec(name: str, shape: Sequence[int], mesh: Any) -> Spec:
    """The spec of one decode-cache leaf by its name (``k``, ``v``, ``ssm``,
    ``conv``, ``pos``) and shape: batch over the data-parallel axes; KV
    heads over ``model``, or the head dim where they do not divide; SSM
    heads and conv channels over ``model``; fitted to the shape."""
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dp = _dp_entry(sizes)
    nd = len(shape)
    if name == "pos":
        return Spec()
    if name in ("k", "v"):               # (R, B, T, Hkv, D)
        lead = (None,) * (nd - 4)
        if shape[-2] % msize == 0:
            return fit_spec(Spec((*lead, dp, None, "model", None)), shape, mesh)
        return fit_spec(Spec((*lead, dp, None, None, "model")), shape, mesh)
    if name == "ssm":                    # (R, B, H, P, N)
        return fit_spec(Spec((None,) * (nd - 4) + (dp, "model", None, None)),
                        shape, mesh)
    if name == "conv":                   # (R, B, K-1, C)
        return fit_spec(Spec((None,) * (nd - 3) + (dp, None, "model")), shape, mesh)
    return Spec((None,) * nd)


def cache_shardings(cache: Any, mesh: Any) -> Any:
    """Decode caches: batch over the data-parallel axes; KV heads (or the
    head dim where they do not divide) and SSM heads over ``model``; ``pos``
    replicated."""
    return _map_with_path(
        lambda names, leaf: cache_leaf_spec(names[-1], getattr(leaf, "shape", ()), mesh),
        cache)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def _entry_axes(entry: Entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def sharded_over(spec: Spec, axis: str) -> bool:
    """Whether ``spec`` shards a dim over ``axis``."""
    return any(axis in _entry_axes(e) for e in spec)


def without_axis(spec: Spec, axis: str) -> Spec:
    """``spec`` with ``axis`` taken out of every entry (a ``model`` shard's
    own slicing over the other axes)."""
    def drop(entry):
        axes = tuple(a for a in _entry_axes(entry) if a != axis)
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return Spec(tuple(drop(e) for e in spec))


def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(dim)`` on
    each mesh dim whose axis shards tensor dim ``dim``, ``Replicate()`` on
    the others.  A dim over several axes must name them in mesh order
    (major first), which is how DTensor nests shards."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def local_slices(spec: Spec, shape: Sequence[int], mesh: DeviceMesh
                 ) -> tuple[slice, ...]:
    """The slice of the full leaf this rank holds under ``spec`` (every
    sharded dim divisible by its axes, as :func:`fit_spec` leaves it)."""
    out = []
    for dim, size in enumerate(shape):
        lo, hi = 0, size
        entry = spec[dim] if dim < len(spec) else None
        for a in _entry_axes(entry):          # major to minor
            n = mesh.size(mesh.mesh_dim_names.index(a))
            step = (hi - lo) // n
            lo += mesh.get_local_rank(a) * step
            hi = lo + step
        out.append(slice(lo, hi))
    return tuple(out)


def spec_of(leaf: DTensor) -> Spec:
    """The spec a DTensor's placements stand for (the inverse of
    :func:`placements`)."""
    names = leaf.device_mesh.mesh_dim_names
    entries: list[list[str]] = [[] for _ in range(leaf.dim())]
    for i, pl in enumerate(leaf.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(names[i])
    return Spec(tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                      for e in entries))


#: elements of one block that :func:`gather_shards` gathers at a time
_GATHER_ELEMENTS = 1 << 26


def _gather_dim(region: torch.Tensor, dim: int, n: int, index: int,
                group: dist.ProcessGroup, axis: str) -> None:
    """``region`` holds n equal parts along ``dim``, this rank's at
    ``index``: fill the others from the group's ranks, in place, a block
    of at most _GATHER_ELEMENTS at a time (a block of rows along dim 0
    when ``dim`` > 0)."""
    k = region.shape[dim] // n
    if dim == 0:
        part = region.narrow(0, index * k, k).clone()
        mesh_ctx.all_gather(region, part, group, axis)
        return
    rows = max(1, _GATHER_ELEMENTS // max(1, region[0].numel()))
    for r0 in range(0, region.shape[0], rows):
        block = region[r0:r0 + rows]
        part = block.narrow(dim, index * k, k).contiguous()
        buf = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
        mesh_ctx.all_gather(buf, part, group, axis)
        block.copy_(buf.view((n,) + tuple(part.shape)).movedim(0, dim)
                    .reshape(block.shape))


@torch.no_grad()
def gather_shards(full_leaf: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> None:
    """Each rank has written its :func:`local_slices` of ``full_leaf`` (a
    replicated tensor, contiguous): fill in the other ranks' slices, in
    place (ZeRO-1's all-gather of the updated parameters; a dim over
    several axes gathers its minor axis first)."""
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if mesh.size(names.index(a)) > 1]
        if not axes:
            continue
        # the region this rank's slice lies in, widened one axis at a time
        sl = list(local_slices(spec, full_leaf.shape, mesh))
        extent = sl[dim].stop - sl[dim].start
        for a in reversed(axes):
            n = mesh.size(names.index(a))
            idx = mesh.get_local_rank(a)
            lo = sl[dim].start - idx * extent
            sl[dim] = slice(lo, lo + n * extent)
            region = full_leaf[tuple(slice(None) if i != dim else sl[dim]
                                     for i in range(full_leaf.dim()))]
            _gather_dim(region, dim, n, idx, mesh.get_group(a), a)
            extent *= n


def from_local(local: torch.Tensor, shape: Sequence[int], spec: Spec,
               mesh: DeviceMesh) -> DTensor:
    """This rank's slice ``local`` (its :func:`local_slices`) of a leaf of
    ``shape`` as a DTensor placed by ``spec``; no collective."""
    return DTensor.from_local(
        local, mesh, placements(spec, mesh), run_check=False,
        shape=torch.Size(shape), stride=torch.empty(shape, device="meta").stride())


def distribute(leaf: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> DTensor:
    """A full leaf (the same on every rank) as a DTensor by ``spec``: each
    rank keeps a copy of its slice (a view where the slice is the whole
    leaf), no collective."""
    sl = local_slices(spec, leaf.shape, mesh)
    local = leaf[sl]
    if local.numel() < leaf.numel():
        local = local.contiguous().clone()
    return from_local(local, leaf.shape, spec, mesh)


def spec_leaves(specs: Any) -> list[Spec]:
    """The Specs of a spec tree, in leaf order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


@torch.no_grad()
def local(leaf: Any) -> Any:
    """A DTensor's local tensor (a plain tensor as it is), detached: the
    port's compute runs on local tensors.  (Without grad mode ``to_local``
    hands the tensor over without an autograd node: a step reads ~400.)"""
    if isinstance(leaf, DTensor):
        return leaf.to_local().detach()
    return leaf


def is_distributed(tree: Any) -> bool:
    """Whether a tree holds DTensors."""
    return any(isinstance(leaf, DTensor) for leaf in flatten(tree).values())


def full(leaf: Any) -> torch.Tensor:
    """A DTensor gathered into the full tensor on every rank (a plain tensor
    as it is)."""
    if isinstance(leaf, DTensor):
        return leaf.full_tensor()
    return leaf


# ---------------------------------------------------------------------------
# Compute views: what each ``model`` rank computes with
# ---------------------------------------------------------------------------

Range = tuple[int, int]


def split_range(n: int, m: int, j: int) -> Range:
    """Rank ``j``'s block of ``n`` items over ``m`` ranks, contiguous, the
    first ``n % m`` blocks one longer (``numpy.array_split``)."""
    k, extra = divmod(n, m)
    lo = j * k + min(j, extra)
    return lo, lo + k + (j < extra)


def head_split(n_heads: int, n_groups: int, m: int, j: int
               ) -> tuple[Range, Range] | None:
    """(heads, groups) that ``model`` rank ``j`` of ``m`` computes, for
    ``n_heads`` heads in ``n_groups`` groups of consecutive heads (GQA's
    query heads over KV heads; an SSM's heads over its B/C groups).

    * ``n_groups`` >= m: whole groups, as evenly as they go (hymba's 5 KV
      heads over 2 ranks: 3 and 2 groups, 15 and 10 query heads);
    * fewer groups, ``m`` a multiple of them: each group's heads split over
      m / n_groups ranks, and a rank reads its one group, computed
      whole (gemma3-1b's 4 query heads over 1 KV head at 2 ranks: 2 each);
    * otherwise None: the block runs whole on every rank."""
    if m == 1:
        return (0, n_heads), (0, n_groups)
    per = n_heads // n_groups
    if n_groups >= m:
        g0, g1 = split_range(n_groups, m, j)
        return (g0 * per, g1 * per), (g0, g1)
    r = m // n_groups
    if m % n_groups or per < r:
        return None
    g = j // r
    a, b = split_range(per, r, j % r)
    return (g * per + a, g * per + b), (g, g + 1)


def attn_view(n_heads: int, n_kv_heads: int, head_dim: int, m: int, j: int
              ) -> dict[str, Any] | None:
    """Attention's view on rank ``j`` of ``m``: its query and KV heads and
    the column ranges of ``wq``, ``wk``, ``wv`` and row ranges of ``wo``;
    None where the heads do not split (the block runs whole)."""
    split = head_split(n_heads, n_kv_heads, m, j)
    if split is None:
        return None
    (h0, h1), (k0, k1) = split
    d = head_dim
    q, kv = ((h0 * d, h1 * d),), ((k0 * d, k1 * d),)
    return {"heads": (h0, h1), "kv_heads": (k0, k1),
            "wq": q, "wk": kv, "wv": kv, "wo": q}


def ssm_view(d_inner: int, head_dim: int, state_dim: int, n_groups: int,
             m: int, j: int) -> dict[str, Any] | None:
    """The Mamba2 mixer's view on rank ``j`` of ``m``: its heads, its B/C
    groups (with one group, the group every head reads), and the ranges
    of the packed leaves: ``in_proj``'s columns [z | x | B | C | dt],
    ``conv_w``'s and ``conv_b``'s [x | B | C], and ``inner``, the d_inner
    range of z, y, the gated norm's scale and ``out_proj``'s rows; None
    where the heads do not split."""
    split = head_split(d_inner // head_dim, n_groups, m, j)
    if split is None:
        return None
    (h0, h1), (g0, g1) = split
    di, p, n = d_inner, head_dim, state_dim
    gn = n_groups * n
    x = (h0 * p, h1 * p)
    bc = (g0 * n, g1 * n)

    def at(base, r):
        return (base + r[0], base + r[1])

    return {"heads": (h0, h1), "groups": (g0, g1), "inner": (x,),
            "in_proj": (x, at(di, x), at(2 * di, bc), at(2 * di + gn, bc),
                        at(2 * di + 2 * gn, (h0, h1))),
            "conv": (x, at(di, bc), at(di + gn, bc))}


def hidden_view(n: int, m: int, j: int) -> tuple[Range]:
    """The hidden units (an MLP's, an expert's) rank ``j`` of ``m``
    computes: its block of ``n``, which is its stored shard where ``m``
    divides ``n``."""
    return (split_range(n, m, j),)


def vocab_view(cfg: Any, m: int) -> dict[str, str]:
    """How the rules store the embedding (``"embed"``) and the head
    (``"head"``) on ``m`` model ranks, and so how they are computed:
    ``"vocab"`` (rows of ``embed``, columns of ``lm_head``: a masked lookup
    and a vocab-parallel cross entropy), ``"d"`` (the odd-vocab fallback:
    ``embed``'s d columns; a gathered lookup, and for a tied head logits
    summed over ``model``) or ``"whole"`` (computed whole on every rank;
    both, with one rank)."""
    if m == 1:
        return {"embed": "whole", "head": "whole"}
    sizes = AxisSizes({"model": m})
    v, d = cfg.padded_vocab, cfg.d_model
    embed = fit_spec(param_spec(["embed"], 2), (v, d), sizes)
    kinds = {"embed": "vocab" if embed[0] == "model" else
             "d" if embed[1] == "model" else "whole"}
    if cfg.tie_embeddings:
        kinds["head"] = kinds["embed"]
    else:
        head = fit_spec(param_spec(["lm_head"], 2), (d, v), sizes)
        kinds["head"] = "vocab" if head[1] == "model" else "whole"
    return kinds


# ---------------------------------------------------------------------------
# Cache views: what each ``model`` rank stores of a decode cache, and so
# what it computes at decode
# ---------------------------------------------------------------------------

def _stored(n: int, split: bool, m: int, j: int) -> Range:
    """Rank ``j``'s block of ``n`` where the spec splits the dim over ``m``
    ranks, else the whole."""
    return (j * (n // m), (j + 1) * (n // m)) if split else (0, n)


def attn_cache_view(n_heads: int, n_kv_heads: int, head_dim: int, m: int,
                    j: int) -> dict[str, Any]:
    """The attention part of :func:`cache_view`."""
    g = n_heads // n_kv_heads
    spec = cache_leaf_spec("k", (1, 1, 1, n_kv_heads, head_dim), AxisSizes({"model": m}))
    split = "heads" if spec[3] == "model" else "d" if spec[4] == "model" else "whole"
    kv = _stored(n_kv_heads, split == "heads", m, j)
    return {"split": split, "kv_heads": kv, "q_heads": (kv[0] * g, kv[1] * g),
            "d": _stored(head_dim, split == "d", m, j)}


def ssm_cache_view(d_inner: int, head_dim: int, state_dim: int, n_groups: int,
                   m: int, j: int) -> dict[str, Any]:
    """The SSM part of :func:`cache_view`."""
    sizes = AxisSizes({"model": m})
    h = d_inner // head_dim
    conv_ch = d_inner + 2 * n_groups * state_dim
    heads_split = cache_leaf_spec("ssm", (1, 1, h, 1, 1), sizes)[2] == "model"
    conv_split = cache_leaf_spec("conv", (1, 1, 1, conv_ch), sizes)[3] == "model"
    return {"heads": _stored(h, heads_split, m, j), "whole": not heads_split,
            "conv": _stored(conv_ch, conv_split, m, j), "conv_split": conv_split}


def cache_view(cfg: Any, m: int, j: int) -> dict[str, Any]:
    """What ``model`` rank ``j`` of ``m`` stores of each decode-cache leaf
    (:func:`cache_leaf_spec`: the same for every segment of a kind) and the
    work that implies, a pure function of (config, ``model`` size, rank).

    ``"attn"`` (configs with attention): ``split`` is ``"heads"`` (the
    rank stores whole KV heads ``kv_heads`` and computes them and their
    query groups ``q_heads``, from its stored columns of wq/wk/wv and rows
    of wo), ``"d"`` (every KV head, the head-dim range ``d``: q, k and v
    are formed whole, with RoPE and ``qk_norm``, then sliced to ``d``; the
    scores over the slice are partial sums, summed over ``model``; p·v
    gives the rank's slice of every head's output) or ``"whole"`` (the
    block runs whole on every rank).

    ``"ssm"`` (configs with SSM layers): ``heads`` the SSM heads whose state
    the rank stores (all of them, ``whole``, where the heads do not
    divide: every rank steps every head, identically), ``conv`` the conv
    channels it stores (and convolves), with ``conv_split``."""
    out: dict[str, Any] = {}
    if cfg.n_heads:
        out["attn"] = attn_cache_view(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, m, j)
    if cfg.ssm_state:
        out["ssm"] = ssm_cache_view(cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state,
                                    cfg.ssm_groups, m, j)
    return out


def leaf_block(n: int, stored: int, m: int, j: int) -> Range:
    """The block of a dim of ``n`` entries that rank ``j`` of ``m`` holds
    when it stores ``stored`` of them: its 1/m block, or the whole."""
    return (0, n) if stored == n else (j * stored, (j + 1) * stored)
