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
* :func:`model_copy` and :func:`model_sum`: Megatron's f and g over the
  ``model`` axis, differentiable: f is the identity whose backward sums
  the gradient over ``model``; g sums over ``model`` and its backward is
  the identity.  Both are the identity where ``model`` has one rank.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_MESHES: list[DeviceMesh] = []

DP_AXES = ("pod", "data")


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
            dist.all_reduce(t, group=_group(a, mesh))
    return t


@torch.no_grad()
def dp_all_gather(t: torch.Tensor, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Every data-parallel rank's ``t`` stacked on a new leading axis, in
    data-parallel index order: ``(dp_size, *t.shape)``."""
    out = t.contiguous()[None]
    for a in reversed(dp_axes(mesh)):        # minor axis first
        n = axis_size(a, mesh)
        buf = out.new_empty((n * out.shape[0],) + tuple(out.shape[1:]))
        dist.all_gather_into_tensor(buf, out.contiguous(), group=_group(a, mesh))
        out = buf
    return out


class _ModelCopy(torch.autograd.Function):
    """f: identity forward; the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ModelSum(torch.autograd.Function):
    """g: the sum over ``model``; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

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
