"""Grouped (ragged) expert matmul: the CUDA kernel's wrapper and its plain
version.

Port of the TPU kernel ``repro.kernels.moe_gmm.grouped_matmul`` (and its
jit wrapper ``repro.kernels.ops.grouped_matmul``).  The kernel is
``csrc/moe_gmm.cu``, CUDA C++ for sm_90a: a persistent grid (one block an
SM) walks 128 x 256 output tiles, each block finding its tiles' experts
from the device's group sizes; in a block one warpgroup issues TMA loads
into a 3-stage shared-memory ring and two warpgroups multiply with wgmma,
then stage the bf16 tile in shared memory for TMA stores to y.  Its
header says what bounds it and what the design does about that.

* A CPU tensor goes to :func:`grouped_matmul_plain`, one fp32 product per
  non-empty expert (the oracle ``ref.grouped_matmul_ref``).
* A CUDA tensor goes to the kernel, or the wrapper raises: x (T, d) and
  w (E, d, f) contiguous bfloat16, d and f multiples of 8, at most
  :data:`MAX_EXPERTS` experts, group sizes a contiguous int32 tensor on
  the same device, no input that requires grad while grad mode is on
  (the kernel has no backward yet).  There is no fallback to the plain
  version.  The
  wrapper never reads the group sizes on the host, so a call does not
  synchronise.

Shapes: x (T, d) rows sorted by expert; w (E, d, f); group_sizes (E,)
summing to T.  Returns y (T, f) in x's dtype, ``y[t] = x[t] @ w[e(t)]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, refuse_grad
from .ref import grouped_matmul_ref

#: the most experts the kernel takes (``kMaxExperts`` in the CUDA source)
MAX_EXPERTS = 512

#: kernel launches since the last reset; the wrapper adds one per launch
launches = 0

#: the plain version of the kernel's function, for CPU tensors and for
#: holding the kernel against on the card
grouped_matmul_plain = grouped_matmul_ref


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point of a loaded build of ``moe_gmm.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.grouped_matmul.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.grouped_matmul.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.library("moe_gmm"))


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(f"want x (T,d), w (E,d,f), group_sizes (E,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    e, d, f = w.shape
    if x.shape[1] != d or group_sizes.shape[0] != e:
        raise ValueError(f"x {tuple(x.shape)} / group_sizes "
                         f"{tuple(group_sizes.shape)} do not match w {tuple(w.shape)}")
    if not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts: the kernel takes 1 to {MAX_EXPERTS}")
    if d % 8 or f % 8:
        raise ValueError(f"d={d} and f={f} must be multiples of 8 (16-byte rows)")
    for name, t in (("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Ragged grouped matmul → (T, f) in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes)
    refuse_grad("grouped_matmul", x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w, group_sizes)
    t, d = x.shape
    e, _, f = w.shape
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    with torch.cuda.device(x.device):
        err = _library().grouped_matmul(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
            t, d, f, e, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return y
