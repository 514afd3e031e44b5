"""Grouped (ragged) expert matmul and its gradient: the CUDA kernels'
wrappers, their plain versions and the autograd.Function over them.

Port of the TPU kernel ``repro.kernels.moe_gmm.grouped_matmul`` (and its
jit wrapper ``repro.kernels.ops.grouped_matmul``); its gradient, which the
reference gets by differentiating ``jax.lax.ragged_dot`` with XLA, is two
more kernels.  All three are in ``csrc/moe_gmm.cu``, CUDA C++ for sm_90a: a
persistent grid (one block an SM) walks 128 x 256 output tiles, each block
finding its tiles' experts from the device's group sizes; in a block one
warpgroup issues TMA loads into a 3-stage shared-memory ring and two
warpgroups multiply with wgmma, then stage the bf16 tile in shared memory
for TMA stores.  ``grouped_matmul_dx`` (w read K-major, no transposed
copy) and ``grouped_matmul_dw`` (one tile per (expert, d-tile, f-tile)
over that expert's rows) run as clusters of two blocks on two tiles that
share their larger operand, each block loading half of it into both by
TMA multicast, with 4-stage rings and each tile stored straight from
registers.  The source's header says what bounds them and what the
design does about that.

* A CPU tensor goes to the plain versions (``ref.grouped_matmul_ref``,
  ``grouped_matmul_dx_ref``, ``grouped_matmul_dw_ref``: one fp32 product per
  non-empty expert).
* A CUDA tensor goes to the kernels, or the wrappers raise: contiguous
  bfloat16 operands, d and f multiples of 8, at most :data:`MAX_EXPERTS`
  experts, group sizes a contiguous int32 tensor on the same device.  There
  is no fallback to the plain versions.  The wrappers never read the group
  sizes on the host, so a call does not synchronise.
* A meta tensor takes the kernels' route, never the plain versions: while a
  cost counter listens (a dry run) its meta route stands in for each
  launch (the same checks and outputs, the call's cost reported to
  :mod:`repro_torch.kernels.costs`, every expert counted as non-empty, no
  launch count); with none listening it raises at the device check.
* Under grad mode with an input that requires grad, or under
  ``torch.func.vmap``, :func:`grouped_matmul` goes through
  :class:`GroupedMatmul` (on either device): its backward launches dx and
  dw, and its vmap rule folds a gang's members into the expert axis, so
  one launch serves all members.

Shapes: x (T, d) rows sorted by expert; w (E, d, f); group_sizes (E,)
summing to T.  Returns y (T, f) in x's dtype, ``y[t] = x[t] @ w[e(t)]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, batched, costs, fold_members, needs_grad, unfold_members
from .ref import grouped_matmul_dw_ref, grouped_matmul_dx_ref, grouped_matmul_ref

#: the most experts the kernels take (``kMaxExperts`` in the CUDA source);
#: in a gang, members times experts
MAX_EXPERTS = 512

#: kernel launches since the last reset; each wrapper adds one per launch
launches = 0
dx_launches = 0
dw_launches = 0

#: the plain versions of the kernels' functions, for CPU tensors and for
#: holding the kernels against on the card
grouped_matmul_plain = grouped_matmul_ref
grouped_matmul_dx_plain = grouped_matmul_dx_ref
grouped_matmul_dw_plain = grouped_matmul_dw_ref


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points of a loaded build of ``moe_gmm.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits;
    # an older tree's build (scripts/kernel_against.py) has the forward only
    for name in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.library("moe_gmm"))


def _check(a: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
           a_cols: int, a_name: str = "x") -> None:
    """Raises on what the kernels do not take.  ``a`` (T, a_cols) is the
    row operand (x, or dy for dx); w (E, d, f)."""
    if a.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(f"want {a_name} (T,·), w (E,d,f), group_sizes (E,); got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    e, d, f = w.shape
    if a.shape[1] != a_cols or group_sizes.shape[0] != e:
        raise ValueError(f"{a_name} {tuple(a.shape)} / group_sizes "
                         f"{tuple(group_sizes.shape)} do not match w {tuple(w.shape)}")
    _check_kernel_inputs(e, d, f, group_sizes, a, **{a_name: a, "w": w})


def _check_kernel_inputs(e: int, d: int, f: int, group_sizes: torch.Tensor,
                         first: torch.Tensor, **operands: torch.Tensor) -> None:
    if first.device.type != "cuda" and not costs.meta_route(first):
        raise ValueError(f"no kernel for device {first.device}")
    if not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts: the kernel takes 1 to {MAX_EXPERTS}")
    if d % 8 or f % 8:
        raise ValueError(f"d={d} and f={f} must be multiples of 8 (16-byte rows)")
    for name, t in (*operands.items(), ("group_sizes", group_sizes)):
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the operands on {first.device}")
    for name, t in operands.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32; got {group_sizes.dtype}")
    if not group_sizes.is_contiguous():
        raise ValueError("group_sizes must be contiguous")


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor,
            group_sizes: torch.Tensor, out: torch.Tensor, t: int, d: int,
            f: int, e: int) -> bool:
    """One launch of ``entry``, its cost reported; on a meta tensor the
    report alone.  Returns whether it launched."""
    cost = ((costs.gmm_dw, t, d, f, e) if entry == "grouped_matmul_dw"
            else (costs.gmm, t, f, d, e) if entry == "grouped_matmul_dx"
            else (costs.gmm, t, d, f, e))
    if costs.meta_route(a):
        costs.report(entry, *cost)
        return False
    with torch.cuda.device(a.device):
        err = getattr(_library(), entry)(
            a.data_ptr(), b.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            t, d, f, e, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    costs.report(entry, *cost)
    return True


def _forward(x: torch.Tensor, w: torch.Tensor,
             group_sizes: torch.Tensor) -> torch.Tensor:
    """y by the kernel (plain version on a CPU tensor)."""
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes)
    _check(x, w, group_sizes, w.shape[1])
    t, d = x.shape
    e, _, f = w.shape
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    if _launch("grouped_matmul", x, w, group_sizes, y, t, d, f, e):
        launches += 1
    return y


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """dx (T, d) in dy's dtype, ``dx[t] = dy[t] @ w[e(t)]ᵀ``: the kernel, or
    its plain version on a CPU tensor.  dy (T, f) rows sorted by expert."""
    global dx_launches
    if dy.device.type == "cpu":
        return grouped_matmul_dx_plain(dy, w, group_sizes)
    _check(dy, w, group_sizes, w.shape[2], "dy")
    t = dy.shape[0]
    e, d, f = w.shape
    dx = torch.empty((t, d), dtype=dy.dtype, device=dy.device)
    if t == 0:
        return dx
    if _launch("grouped_matmul_dx", dy, w, group_sizes, dx, t, d, f, e):
        dx_launches += 1
    return dx


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor,
                      group_sizes: torch.Tensor, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """dw (E, d, f) in x's dtype, ``dw[e] = x_eᵀ @ dy_e`` over expert e's
    rows (an empty expert's slab exactly zero): the kernel, which writes
    every element, or its plain version on a CPU tensor.  ``out``, a
    contiguous (E, d, f) tensor, is written and returned in place of a new
    one (a check fills it with NaN first, so that an element the kernel
    skipped shows)."""
    global dw_launches
    if x.device.type == "cpu":
        dw = grouped_matmul_dw_plain(x, dy, group_sizes)
        return dw if out is None else out.copy_(dw)
    if x.dim() != 2 or dy.dim() != 2 or group_sizes.dim() != 1 or (
            dy.shape[0] != x.shape[0]):
        raise ValueError(f"want x (T,d), dy (T,f), group_sizes (E,); got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    (t, d), f, e = x.shape, dy.shape[1], group_sizes.shape[0]
    _check_kernel_inputs(e, d, f, group_sizes, x, x=x, dy=dy)
    dw = torch.empty((e, d, f), dtype=x.dtype, device=x.device) if out is None else out
    if dw.shape != (e, d, f) or dw.dtype != x.dtype or not dw.is_contiguous() or (
            dw.device != x.device):
        raise ValueError(f"out must be a contiguous {x.dtype} {(e, d, f)} tensor "
                         f"on {x.device}")
    if t == 0:   # no rows: nothing to launch, every slab is zero
        return dw.zero_()
    if _launch("grouped_matmul_dw", x, dy, group_sizes, dw, t, d, f, e):
        dw_launches += 1
    return dw


def _fold(m: int, in_dims, x, w, group_sizes):
    """A vmap rule's inputs with the member dim folded: x (M·T, d), w
    (M·E, d, f), group_sizes (M·E,).  Each member's rows are sorted by
    its experts, so the concatenation is sorted by (member, expert), the
    order of the folded groups."""
    e = w.shape[-3]
    if m * e > MAX_EXPERTS:
        raise ValueError(
            f"a gang of {m} members x {e} experts folds into {m * e} groups; "
            f"the grouped-GEMM kernels take at most {MAX_EXPERTS}")
    return [fold_members(t, dim, m) for t, dim in
            zip((x, w, group_sizes), in_dims)]


class _Gradient(torch.autograd.Function):
    """:class:`GroupedMatmul`'s backward as a Function of its own, so that
    it too has a vmap rule: under ``torch.func.vmap(torch.func.grad(...))``
    the backward runs on batched tensors.  (dx, dw); not differentiable."""

    @staticmethod
    def forward(dy, x, w, group_sizes):
        return (grouped_matmul_dx(dy, w, group_sizes),
                grouped_matmul_dw(x, dy, group_sizes))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ddx, ddw):
        raise RuntimeError("the grouped matmul has no second derivative")

    @staticmethod
    def vmap(info, in_dims, dy, x, w, group_sizes):
        m = info.batch_size
        x, w, sizes = _fold(m, in_dims[1:], x, w, group_sizes)
        dy = fold_members(dy, in_dims[0], m)
        dx, dw = _Gradient.apply(dy.contiguous(), x.contiguous(),
                                 w.contiguous(), sizes.contiguous())
        return (unfold_members(dx, m), unfold_members(dw, m)), (0, 0)


class GroupedMatmul(torch.autograd.Function):
    """The kernels under autograd: the forward launches ``grouped_matmul``
    and saves x, w and the group sizes; the backward launches
    ``grouped_matmul_dx`` and ``grouped_matmul_dw`` on dy made contiguous
    and returns dw in w's dtype (the cast to fp32 masters is the ``cast``
    before it).  Under ``torch.func.vmap`` the rule folds the members into
    the expert axis: x (M, T, d) → (M·T, d), w (M, E, d, f) → (M·E, d, f),
    group sizes (M, E) → (M·E,); one launch for all members, forward and
    backward.  On a CPU tensor the same steps take the plain versions."""

    @staticmethod
    def forward(x, w, group_sizes):
        return _forward(x, w, group_sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dx, dw = _Gradient.apply(dy.contiguous(), x, w, group_sizes)
        # group_sizes is an integer count: no gradient
        return dx, dw.to(w.dtype), None

    @staticmethod
    def vmap(info, in_dims, x, w, group_sizes):
        m = info.batch_size
        x, w, sizes = _fold(m, in_dims, x, w, group_sizes)
        y = GroupedMatmul.apply(x.contiguous(), w.contiguous(), sizes.contiguous())
        return unfold_members(y, m), 0


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Ragged grouped matmul → (T, f) in x's dtype.  Under grad mode with an
    input that requires grad, or under ``torch.func.vmap``, the call goes
    through :class:`GroupedMatmul`."""
    if needs_grad(x, w) or batched(x, w, group_sizes):
        return GroupedMatmul.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)
