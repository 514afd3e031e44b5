"""The ambient device mesh and the collectives the port runs on it.

Counterpart of ``repro.jax_compat``'s ``set_mesh``, ``get_abstract_mesh``
and ``mesh_axis_names``: :func:`set_mesh` is a context manager that makes a
``torch.distributed.device_mesh.DeviceMesh`` the current one; with none
set, :func:`mesh_axis_names` is ``()``.  The stack is process-wide, not
per thread: autograd runs the backward (and a checkpoint's recompute) on
a thread of its own, which must see the mesh the forward saw.

The mesh's axes are the reference's names: ``("data", "model")`` or
``("pod", "data", "model")``.  One process drives one device (SPMD, as
``shard_map`` writes it), so every collective here is called by every rank
of the group in the same order.  The data-parallel axes are ``pod`` and
``data`` where present; a rank's data-parallel index runs pod-major, as
JAX orders a ``("pod", "data")`` sharding.

* :func:`dp_all_reduce` and :func:`dp_all_gather`: a sum, and a stack in
  rank order, over the data-parallel axes (no gradient);
* :func:`dp_microbatches`: this rank's share of each microbatch of the
  global batch (the reference's microbatch is a block of the global batch,
  which spans ranks), by an all-to-all over each data-parallel axis;
* :func:`model_copy` and :func:`model_sum`: Megatron's f and g over the
  ``model`` axis, differentiable: f is the identity whose backward sums
  the gradient over ``model``; g sums over ``model`` and its backward is
  the identity;
* :func:`model_gather` (an all-gather along a dim; its backward is a
  reduce-scatter where each rank's work on the whole differs, a slice
  where every rank does the same work), :func:`model_reduce_scatter`,
  :func:`model_slice`, :func:`model_stat_sum` (a statistic that sliced
  work reads: summed both ways) and :func:`model_max` (no gradient);
* :func:`enter`, :func:`leave`, :func:`enter_replicated` and
  :func:`leave_replicated`: where the residual stream meets a block's
  work, without and with sequence-parallel activations (``seq``: each
  ``model`` rank holds ``(B, S/M, d)`` between blocks; f becomes an
  all-gather over the sequence and g a reduce-scatter);
* :func:`model_view`: a block's compute view of a parameter stored whole
  or as this rank's ``model`` shard, the one place that chooses the
  gather's backward;
* :func:`decode_gather` and :func:`decode_sum`: decode's small activation
  gathers over ``model`` (a row of a projection's columns, conv outputs,
  each head's output slice) and its sums (the partial scores over a head
  dim split, a statistic), no gradient.

Every one is the identity where ``model`` has one rank.

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather`, :func:`reduce_scatter` or :func:`all_to_all`, which
report the kind, the axis and the payload bytes (the result's, as the
reference's dry run reads them from the HLO; an all-to-all's, the rows
that leave the rank) as a :data:`repro_torch.events.COLLECTIVE` event, to
a cost counter that is off unless one listens.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import events

_MESHES: list[DeviceMesh] = []

DP_AXES = ("pod", "data")

_INSIDE = threading.local()


def inside_collective() -> bool:
    """Whether this thread is inside one of the collectives below: the ops
    a backend dispatches to carry one out (gloo stages a CUDA tensor's
    reduce-scatter through copies) are the collective's, not the model's."""
    return getattr(_INSIDE, "depth", 0) > 0


@contextlib.contextmanager
def _collective(kind: str, axis: str, nbytes: int) -> Iterator[None]:
    # kind: all-reduce, all-gather, reduce-scatter or all-to-all; axis: the
    # mesh axis the group spans
    if events.active():
        events.report(events.COLLECTIVE, kind, axis, nbytes)
    _INSIDE.depth = getattr(_INSIDE, "depth", 0) + 1
    try:
        yield
    finally:
        _INSIDE.depth -= 1


#: ``reduce_scatter_single`` where this torch has it (the newer name),
#: else ``reduce_scatter_tensor``; the same arguments
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce(t: torch.Tensor, group: dist.ProcessGroup, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (the ranks of
    mesh axis ``axis``), reported."""
    with _collective("all-reduce", axis, _nbytes(t)):
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(out: torch.Tensor, t: torch.Tensor, group: dist.ProcessGroup,
               axis: str) -> torch.Tensor:
    """``dist.all_gather_into_tensor`` of ``t`` into ``out``, reported."""
    with _collective("all-gather", axis, _nbytes(out)):
        dist.all_gather_into_tensor(out, t, group=group)
    return out


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group: dist.ProcessGroup,
                   axis: str) -> torch.Tensor:
    """The group's ``t`` summed, this rank's part into ``out``, reported."""
    with _collective("reduce-scatter", axis, _nbytes(out)):
        _reduce_scatter(out, t, group=group)
    return out


def all_to_all(out: torch.Tensor, t: torch.Tensor, out_rows: list[int],
               in_rows: list[int], group: dist.ProcessGroup, axis: str,
               sent: int) -> torch.Tensor:
    """``dist.all_to_all_single``: ``in_rows[k]`` leading rows of ``t``
    (in order) to the group's rank k, ``out_rows[k]`` from it into ``out``;
    reported with ``sent``, the bytes that leave this rank."""
    with _collective("all-to-all", axis, sent):
        dist.all_to_all_single(out, t, out_rows, in_rows, group=group)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def get_mesh() -> DeviceMesh | None:
    """The ambient mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_axis_names(mesh: DeviceMesh | None = None) -> tuple[str, ...]:
    """The axis names of ``mesh`` (default: the ambient one); ``()`` with
    no mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(name: str, mesh: DeviceMesh | None = None) -> int:
    """Ranks along axis ``name``; 1 for an axis the mesh does not have."""
    mesh = mesh if mesh is not None else get_mesh()
    if name not in mesh_axis_names(mesh):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def dp_axes(mesh: DeviceMesh | None = None) -> tuple[str, ...]:
    """The data-parallel axes the mesh has, major first."""
    names = mesh_axis_names(mesh)
    return tuple(a for a in DP_AXES if a in names)


def dp_size(mesh: DeviceMesh | None = None) -> int:
    """Ranks a batch is split over: the product of the data-parallel axes
    (1 with no mesh)."""
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(a, mesh)
    return n


def dp_index(mesh: DeviceMesh | None = None) -> int:
    """This rank's block of the batch, pod-major (0 with no mesh)."""
    mesh = mesh if mesh is not None else get_mesh()
    index = 0
    for a in dp_axes(mesh):
        index = index * axis_size(a, mesh) + mesh.get_local_rank(a)
    return index


def mesh_device(mesh: DeviceMesh | None = None) -> torch.device:
    """The device this rank drives: its current CUDA device, or the CPU."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _group(name: str, mesh: DeviceMesh | None = None) -> dist.ProcessGroup:
    mesh = mesh if mesh is not None else get_mesh()
    return mesh.get_group(name)


@torch.no_grad()
def dp_all_reduce(t: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """``t`` summed over the data-parallel axes, in place (one all-reduce
    an axis of more than one rank: a sum over pod of sums over data is the
    sum over both, and a sum over one rank is the value)."""
    for a in dp_axes(mesh):
        if axis_size(a, mesh) > 1:
            all_reduce(t, _group(a, mesh), a)
    return t


@torch.no_grad()
def dp_all_gather(t: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Every data-parallel rank's ``t`` stacked on a new leading axis, in
    data-parallel index order: ``(dp_size, *t.shape)``."""
    out = t.contiguous()[None]
    for a in reversed(dp_axes(mesh)):        # minor axis first
        n = axis_size(a, mesh)
        buf = out.new_empty((n * out.shape[0],) + tuple(out.shape[1:]))
        all_gather(buf, out.contiguous(), _group(a, mesh), a)
        out = buf
    return out


def _coords(index: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    """The coordinates of data-parallel index ``index`` (pod-major) on axes
    of ``sizes``."""
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return tuple(reversed(out))


@torch.no_grad()
def dp_microbatches(t: torch.Tensor, n: int, mesh: DeviceMesh | None = None
                    ) -> torch.Tensor:
    """This rank's share of each of the ``n`` microbatches of the global
    batch, whose data-parallel block ``t`` is (rows on dim 0): ``(n,
    B/(n·D), ...)``, where its i-th entry holds the global rows ``i·B/n +
    r·B/(n·D) + [0, B/(n·D))``, r this rank's data-parallel index.  The
    reference's microbatch i is block i of the global batch (a reshape),
    so with n ≤ D it lies on the first ranks; each rank gets its exact
    share of it, the rows every rank of a microbatch would hold in a
    data-parallel step on that microbatch alone.  The rows move by one
    all-to-all over each data-parallel axis on which any moves (minor
    first), each rank sending only the rows it does not keep: no rank
    gathers the batch.  With one data rank, or n = 1, it is the reshape."""
    d = dp_size(mesh)
    b = t.shape[0]
    if b % n:
        raise ValueError(f"a data-parallel block of {b} rows does not split into "
                         f"{n} microbatches")
    c = b // n
    rest = tuple(t.shape[1:])
    if d == 1:
        return t.reshape((n, c) + rest)
    axes = dp_axes(mesh)
    sizes = tuple(axis_size(a, mesh) for a in axes)
    row = _nbytes(t) // b
    me = dp_index(mesh)
    # the pieces of c rows by their global index q (the global rows q·c +
    # [0, c)): rank r holds r·n + [0, n) to start with, and piece q is the
    # share of rank q % D in microbatch q // D
    held = [list(range(r * n, (r + 1) * n)) for r in range(d)]
    x = t.contiguous()
    for k in reversed(range(len(axes))):          # minor axis first
        if sizes[k] == 1:
            continue
        stride = math.prod(sizes[k + 1:])
        to = [_coords(q % d, sizes)[k] for q in range(n * d)]

        def peers(r):
            """The ranks of r's group on axis k, in the axis's order."""
            at = _coords(r, sizes)[k]
            return [r + (a - at) * stride for a in range(sizes[k])]

        if all(to[q] == _coords(r, sizes)[k] for r in range(d) for q in held[r]):
            continue                              # no piece moves on this axis
        mine = _coords(me, sizes)[k]
        order = [j for a in range(sizes[k]) for j, q in enumerate(held[me]) if to[q] == a]
        in_rows = [c * sum(to[q] == a for q in held[me]) for a in range(sizes[k])]
        out_rows = [c * sum(to[q] == mine for q in held[p]) for p in peers(me)]
        out = x.new_empty((sum(out_rows),) + rest)
        all_to_all(out, _pieces(x, c, order), out_rows, in_rows, _group(axes[k], mesh),
                   axes[k], (sum(in_rows) - in_rows[mine]) * row)
        held = [[q for p in peers(r) for q in held[p] if to[q] == _coords(r, sizes)[k]]
                for r in range(d)]
        x = out
    order = sorted(range(len(held[me])), key=held[me].__getitem__)
    return _pieces(x, c, order).view((n, c) + rest)


def _pieces(x: torch.Tensor, c: int, order: list[int]) -> torch.Tensor:
    """``x``'s pieces of ``c`` rows in ``order`` (``x`` itself where that is
    their order)."""
    if order == list(range(len(order))):
        return x
    return torch.cat([x.narrow(0, j * c, c) for j in order])


class _ModelCopy(torch.autograd.Function):
    """f: identity forward; the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), ctx.group, "model"), None


class _ModelSum(torch.autograd.Function):
    """g: the sum over ``model``; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group, "model")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def model_copy(x: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Megatron's f: ``x`` unchanged, its gradient summed over the ``model``
    axis (where a value replicated over ``model`` enters work that each
    model rank does on its own slice of the weights)."""
    if axis_size("model", mesh) == 1:
        return x
    return _ModelCopy.apply(x, _group("model", mesh))


def model_sum(x: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Megatron's g: ``x`` summed over the ``model`` axis, its gradient
    passed through unchanged."""
    if axis_size("model", mesh) == 1:
        return x
    return _ModelSum.apply(x, _group("model", mesh))


# ---------------------------------------------------------------------------
# Tensor parallelism over ``model``
# ---------------------------------------------------------------------------

def model_rank(mesh: DeviceMesh | None = None) -> int:
    """This rank's index on ``model`` (0 with no ``model`` axis)."""
    mesh = mesh if mesh is not None else get_mesh()
    if axis_size("model", mesh) == 1:
        return 0
    return mesh.get_local_rank("model")


def _gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup, n: int
            ) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order."""
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0],) + tuple(front.shape[1:]))
    all_gather(out, front, group, "model")
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, dim: int, group: dist.ProcessGroup, n: int
                 ) -> torch.Tensor:
    """The group's ``x`` summed, this rank's n-th part along ``dim``."""
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n,) + tuple(front.shape[1:]))
    reduce_scatter(out, front, group, "model")
    return out.movedim(0, dim)


def _own(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    k = x.shape[dim] // n
    return x.narrow(dim, rank * k, k).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward sums over the group and keeps
    this rank's part (``summed``) or keeps it alone."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, n, summed):
        ctx.args = (dim, group, rank, n, summed)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        dim, group, rank, n, summed = ctx.args
        dx = _scatter_sum(dy, dim, group, n) if summed else _own(dy, dim, rank, n)
        return dx, None, None, None, None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _scatter_sum(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        dim, group, n = ctx.args
        return _gather(dy, dim, group, n), None, None, None


class _Slice(torch.autograd.Function):
    """This rank's part along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.args = (dim, group, n)
        return _own(x, dim, rank, n)

    @staticmethod
    def backward(ctx, dy):
        dim, group, n = ctx.args
        return _gather(dy, dim, group, n), None, None, None, None


class _StatSum(torch.autograd.Function):
    """A sum over the group whose gradient is summed too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group, "model")

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), ctx.group, "model"), None


def _model(mesh: DeviceMesh | None) -> tuple[dist.ProcessGroup, int, int]:
    return _group("model", mesh), model_rank(mesh), axis_size("model", mesh)


def model_gather(x: torch.Tensor, dim: int, summed: bool,
                 mesh: DeviceMesh | None = None) -> torch.Tensor:
    """The ``model`` ranks' ``x`` concatenated along ``dim``.  Backward:
    with ``summed``, a reduce-scatter (each rank's work on the whole gave it
    a different gradient, whose sum is the whole's); without, this rank's
    part of the gradient (every rank did the same work)."""
    if axis_size("model", mesh) == 1:
        return x
    group, rank, n = _model(mesh)
    return _Gather.apply(x, dim % x.dim(), group, rank, n, summed)


def model_reduce_scatter(x: torch.Tensor, dim: int,
                         mesh: DeviceMesh | None = None) -> torch.Tensor:
    """``x`` summed over ``model``, this rank's part along ``dim``; the
    backward all-gathers (sequence-parallel g)."""
    if axis_size("model", mesh) == 1:
        return x
    group, _, n = _model(mesh)
    return _ScatterSum.apply(x, dim % x.dim(), group, n)


def model_slice(x: torch.Tensor, dim: int,
                mesh: DeviceMesh | None = None) -> torch.Tensor:
    """This rank's part of ``x`` (the same on every rank) along ``dim``;
    the backward all-gathers."""
    if axis_size("model", mesh) == 1:
        return x
    group, rank, n = _model(mesh)
    return _Slice.apply(x, dim % x.dim(), group, rank, n)


def model_stat_sum(x: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """A statistic of each rank's slice summed over ``model`` for that
    slice's work (the gated norm's sum of squares): forward and backward
    both sum, since every rank's slice reads the total."""
    if axis_size("model", mesh) == 1:
        return x
    return _StatSum.apply(x, _group("model", mesh))


@torch.no_grad()
def model_max(x: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """The elementwise maximum over ``model`` (no gradient)."""
    if axis_size("model", mesh) == 1:
        return x
    return all_reduce(x.contiguous().clone(), _group("model", mesh), "model",
                      op=dist.ReduceOp.MAX)


def check_seq(s: int, mesh: DeviceMesh | None = None) -> None:
    """Raises unless ``model``'s ranks divide a sequence of ``s`` positions
    (sequence-parallel shards are equal)."""
    m = axis_size("model", mesh)
    if s % m:
        raise ValueError(f"sequence-parallel activations: a sequence of {s} "
                         f"positions does not split over {m} model ranks")


def enter(x: torch.Tensor, seq: bool) -> torch.Tensor:
    """The residual stream (B, S, d), or its sequence shard with ``seq``,
    entering work that each ``model`` rank does on its own slice of the
    weights: f, or with ``seq`` an all-gather over the sequence whose
    backward is a reduce-scatter."""
    return model_gather(x, -2, summed=True) if seq else model_copy(x)


def leave(y: torch.Tensor, seq: bool) -> torch.Tensor:
    """Each rank's partial sum leaving sliced work: g, or with ``seq`` a
    reduce-scatter over the sequence."""
    return model_reduce_scatter(y, -2) if seq else model_sum(y)


def enter_replicated(x: torch.Tensor, seq: bool) -> torch.Tensor:
    """The residual stream entering work every ``model`` rank does whole:
    unchanged, or with ``seq`` all-gathered over the sequence (its
    backward keeps this rank's part)."""
    return model_gather(x, -2, summed=False) if seq else x


def leave_replicated(y: torch.Tensor, seq: bool) -> torch.Tensor:
    """Work every rank did whole leaving for the residual stream:
    unchanged, or with ``seq`` this rank's sequence shard."""
    return model_slice(y, -2) if seq else y


Ranges = tuple[tuple[int, int], ...]


def model_view(w: torch.Tensor, dim: int, ranges: Ranges, full: int, *,
               sliced: bool = True, mesh: DeviceMesh | None = None
               ) -> torch.Tensor:
    """A block's compute view of a parameter: the index ``ranges`` of its
    dim ``dim`` (of ``full`` entries in the whole leaf), concatenated.
    ``w`` is the stored leaf: whole, or this rank's 1/M of ``dim`` (the
    sharding rules' contiguous blocks).

    * a shard whose block is the view: ``w`` itself, no communication;
    * another shard: gathered over ``model``, then indexed; the gather's
      backward is a reduce-scatter for ``sliced`` work (each rank's part of
      the block gives the whole leaf a different gradient) and this rank's
      block for work every rank does whole;
    * a whole leaf: indexed, after f for ``sliced`` work (its gradient is
      summed over ``model``: a norm scale that every head reads, a slice of
      a leaf the rules keep whole).

    With one ``model`` rank the ranges must be the whole dim: ``w``."""
    m = axis_size("model", mesh)
    if m == 1:
        return w
    n = w.shape[dim]
    if n != full:
        lo = model_rank(mesh) * n
        if tuple(ranges) == ((lo, lo + n),):
            return w
        whole = model_gather(w, dim, summed=sliced, mesh=mesh)
    else:
        whole = model_copy(w, mesh) if sliced else w
    if tuple(ranges) == ((0, full),):
        return whole
    parts = [whole.narrow(dim, a, b - a) for a, b in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# Decode over ``model``: small activations move, never a cache leaf or a
# weight
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_gather(x: torch.Tensor, dim: int,
                  mesh: DeviceMesh | None = None) -> torch.Tensor:
    """The ``model`` ranks' ``x`` (equal shapes) concatenated along ``dim``
    in rank order (no gradient)."""
    if axis_size("model", mesh) == 1:
        return x
    group, _, n = _model(mesh)
    return _gather(x, dim % x.dim(), group, n)


@torch.no_grad()
def decode_sum(x: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """``x`` summed over ``model`` (no gradient): decode's partial scores
    over a head-dim slice, or a statistic of each rank's slice."""
    if axis_size("model", mesh) == 1:
        return x
    return all_reduce(x.contiguous().clone(), _group("model", mesh), "model")
