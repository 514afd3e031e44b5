"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of the TPU kernel ``repro.kernels.flash_attention`` and its padding
wrapper ``repro.kernels.ops.flash_attention``.  The kernel is
``csrc/flash_attention.cu``, CUDA C++ for sm_90a: a block of three
warpgroups serves 128 query rows of one (batch, head); one warpgroup
issues TMA loads of Q and of a 2-stage K/V ring, two multiply with wgmma
(QK^T from shared memory, PV with P from registers) and run the online
softmax between the products.  Its header says what bounds it, how it is
built and what the design does about it.

* A CPU tensor goes to :func:`flash_attention_plain`, a dense masked
  softmax in fp32 (the oracle ``ref.flash_attention_ref``).
* A CUDA tensor goes to the kernel, or the wrapper raises: bf16 only,
  head dims in :data:`HEAD_DIMS`, contiguous (B, S, H, D) layout, no
  input that requires grad while grad mode is on (the kernel has no
  backward yet).  There is no fallback to the plain version.

Shapes: q (B, S, Hq, D); k, v (B, S, Hkv, D) with Hq a multiple of Hkv.
Masks: ``causal`` and ``window`` (allowed iff 0 <= q - k < window when
causal; q - k < window otherwise), as in the Pallas kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, refuse_grad
from .ref import flash_attention_ref

#: head dims the CUDA source is compiled for (its ``switch`` in
#: ``flash_attention_fwd``); 16 is the MoE smoke configs', 64 hymba-1.5b's
HEAD_DIMS = (16, 32, 64, 80, 128, 256)

#: kernel launches since the last reset; the wrapper adds one per launch
launches = 0

#: the plain version of the kernel's function, for CPU tensors and for
#: holding the kernel against on the card
flash_attention_plain = flash_attention_ref


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry point of a loaded build of ``flash_attention.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.library("flash_attention"))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,Hq,D), k = v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel; "
                         f"supported: {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Exact attention, output (B, S, Hq, D) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    refuse_grad("flash_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, k.shape[2], d, int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
