"""Mamba2 SSD chunked scan: the CUDA kernels' wrapper and its plain version.

Port of the TPU kernels ``repro.kernels.ssd_scan`` (``_intra_kernel``, the
host ``associative_scan`` over chunk states, ``_inter_kernel``).  The
kernels are ``csrc/ssd_scan.cu`` (CUDA C++ for sm_90a: TMA loads and wgmma
products; its header says what bounds them and how the work is split
between them):

* ``ssd_chunk_state`` — every chunk's state ``Σ_j exp(total − cum_j)
  x_j ⊗ B_j`` (fp32), handed along the chunks from block to block (the
  state entering each chunk) and the final state; plain version
  :func:`chunk_state_plain`;
* ``ssd_chunk_scan``  — y, intra- and inter-chunk terms together; plain
  version :func:`chunk_scan_plain`.

A CPU tensor goes to the plain versions, which compute what the two Pallas
kernels compute (scores and the intra-chunk output in fp32).  A CUDA
tensor goes to the kernels, or the wrapper raises: x, B and C bf16 and
log_a fp32; each of them with its last dim contiguous, rows 16-byte
aligned (any other strides are read in place); (P, N) in
:data:`HEAD_STATE_DIMS`; Q = min(chunk, S) at most 256 and dividing S; no
input that requires grad while grad mode is on (the kernels have no
backward yet).  There is no fallback to the plain version.

Shapes: x (B,S,H,P) dt-scaled inputs; log_a (B,S,H); b_mat, c_mat
(B,S,G,N) with H a multiple of G; initial_state (B,H,P,N).  Returns
(y (B,S,H,P), final_state (B,H,P,N)), both in x's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, refuse_grad

#: (head dim P, state dim N) pairs the CUDA source is compiled for (its
#: ``SSD_DISPATCH``)
HEAD_STATE_DIMS = ((64, 128), (64, 64), (64, 16), (16, 16))

#: the longest chunk the kernels take (Q rows of one chunk in one block)
MAX_CHUNK = 256

#: kernel launches since the last reset; each wrapper adds one per launch
state_launches = 0
scan_launches = 0


def _check_divides(s: int, q: int) -> None:
    """The reference asserts it (``ssd_scan.py:90``); here it raises."""
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")


def _chunk_cumsum(log_a: torch.Tensor, g: int, q: int) -> torch.Tensor:
    """Inclusive cumsum of log_a within each chunk: (B, C, Q, G, R) fp32."""
    bsz, s, h = log_a.shape
    return log_a.float().reshape(bsz, s // q, q, g, h // g).cumsum(dim=2)


def chunk_state_plain(x: torch.Tensor, log_a: torch.Tensor,
                      b_mat: torch.Tensor, q: int,
                      initial_state: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``ssd_chunk_state``: each chunk's state
    ``Σ_j exp(total − cum_j) x_j ⊗ B_j``, passed along the chunks in order
    (``prev_0`` = the initial state or 0, ``prev_c+1 = prev_c exp(total_c)
    + state_c``).  Returns (prev (B, H, C, P, N) fp32, the state entering
    each chunk; the final state (B, H, P, N) in x's dtype)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    c, rep = s // q, h // g
    cum = _chunk_cumsum(log_a, g, q)                       # (B,C,Q,G,R)
    w = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bcqgrp,bcqgn,bcqgr->bgrcpn",
                          x.float().reshape(bsz, c, q, g, rep, p),
                          b_mat.float().reshape(bsz, c, q, g, n), w)
    seg = cum[:, :, -1].exp().permute(0, 2, 3, 1)          # (B,G,R,C)
    run = (initial_state.float().reshape(bsz, g, rep, p, n)
           if initial_state is not None
           else torch.zeros((bsz, g, rep, p, n), dtype=torch.float32,
                            device=x.device))
    prev = []
    for ci in range(c):
        prev.append(run)
        run = run * seg[..., ci, None, None] + states[:, :, :, ci]
    prev = torch.stack(prev, dim=3)                        # (B,G,R,C,P,N)
    return prev.reshape(bsz, h, c, p, n), run.reshape(bsz, h, p, n).to(x.dtype)


def chunk_scan_plain(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                     c_mat: torch.Tensor, prev: torch.Tensor, q: int
                     ) -> torch.Tensor:
    """Plain version of ``ssd_chunk_scan``: y = y_intra + (C·prevᵀ) ∘
    exp(cum), with the decay masked before exp and the scores and y_intra in
    fp32, cast once to x's dtype; ``prev`` from :func:`chunk_state_plain`."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    c, rep = s // q, h // g
    xq = x.float().reshape(bsz, c, q, g, rep, p)
    bq = b_mat.float().reshape(bsz, c, q, g, n)
    cq = c_mat.float().reshape(bsz, c, q, g, n)
    cum = _chunk_cumsum(log_a, g, q)                       # (B,C,Q,G,R)

    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, None, :, :, None, None]              # [i, j]
    # the masked (j > i) entries have positive exponents: mask before exp
    delta = torch.where(mask, cum[:, :, :, None] - cum[:, :, None], 0.0)
    decay = torch.where(mask, delta.exp(), 0.0)            # (B,C,Qi,Qj,G,R)
    scores = torch.einsum("bcign,bcjgn->bcijg", cq, bq)[..., None] * decay
    y_intra = torch.einsum("bcijgr,bcjgrp->bcigrp", scores, xq)
    y_inter = torch.einsum("bcign,bgrcpn->bcigrp", cq,
                           prev.reshape(bsz, g, rep, c, p, n)) * cum.exp()[..., None]
    return (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype)


def ssd_scan_plain(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, *, chunk: int = 256,
                   initial_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """What the Pallas kernels compute, in plain torch: the two kernels'
    plain versions in turn."""
    q = min(chunk, x.shape[1])
    _check_divides(x.shape[1], q)
    prev, final = chunk_state_plain(x, log_a, b_mat, q, initial_state)
    return chunk_scan_plain(x, log_a, b_mat, c_mat, prev, q), final


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the two C entry points of a loaded build of ``ssd_scan.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.ssd_chunk_state.argtypes = [ctypes.c_void_p] * 10
    lib.ssd_chunk_state.restype = ctypes.c_int
    lib.ssd_chunk_scan.argtypes = [ctypes.c_void_p] * 8
    lib.ssd_chunk_scan.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.library("ssd_scan"))


def _check(x, log_a, b_mat, c_mat, chunk, initial_state) -> int:
    """Raises on what the kernels do not take; returns Q."""
    if x.dim() != 4 or b_mat.dim() != 4 or c_mat.shape != b_mat.shape:
        raise ValueError(f"want x (B,S,H,P), b = c (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(b_mat.shape)}, "
                         f"{tuple(c_mat.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if tuple(log_a.shape) != (bsz, s, h) or tuple(b_mat.shape[:2]) != (bsz, s):
        raise ValueError(f"log_a {tuple(log_a.shape)} / b {tuple(b_mat.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    q = min(chunk, s)
    _check_divides(s, q)
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} > {MAX_CHUNK}: not supported by the kernel")
    if (p, n) not in HEAD_STATE_DIMS:
        raise ValueError(f"(head dim, state dim) {(p, n)} not supported by the "
                         f"kernel; supported: {HEAD_STATE_DIMS}")
    if initial_state is not None and tuple(initial_state.shape) != (bsz, h, p, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)}, "
                         f"want {(bsz, h, p, n)}")
    for name, t, dtype in (("x", x, torch.bfloat16), ("b_mat", b_mat, torch.bfloat16),
                           ("c_mat", c_mat, torch.bfloat16),
                           ("log_a", log_a, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"the kernel takes {dtype} {name}; got {t.dtype}")
        if dtype == torch.bfloat16 and (
                t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"{name} must be contiguous in its last dim with "
                             f"16-byte aligned rows; strides {t.stride()}")
    return q


def _dims(x, log_a, b_mat, c_mat, q) -> ctypes.Array:
    bsz, s, h, p = x.shape
    vals = [bsz, s, h, b_mat.shape[2], p, b_mat.shape[3], q,
            *x.stride()[:3], *log_a.stride(), *b_mat.stride()[:3],
            *c_mat.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version); True for a CUDA one;
    raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def chunk_state(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor, *,
                chunk: int = 256, initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(prev (B, H, C, P, N) fp32: the state entering each chunk, the
    final state (B, H, P, N) in x's dtype) — ``ssd_chunk_state``."""
    global state_launches
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_state_plain(x, log_a, b_mat, q, initial_state)
    refuse_grad("ssd_chunk_state", x, log_a, b_mat, initial_state)
    _check(x, log_a, b_mat, b_mat, chunk, initial_state)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    prev = torch.empty((bsz, h, s // q, p, n), dtype=torch.float32,
                       device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=x.dtype, device=x.device)
    # the hand-off's flags, one a chunk, then its ticket: zeroed every call
    # (B x H ints after the flags, not one: a build of the kernel from
    # before the hand-off takes them as its per-(b, h) counters)
    work = torch.zeros(bsz * h * (s // q + 1), dtype=torch.int32,
                       device=x.device)
    init = (initial_state.to(torch.float32).contiguous()
            if initial_state is not None else None)
    dims = _dims(x, log_a, b_mat, b_mat, q)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_state(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(),
            init.data_ptr() if init is not None else None, prev.data_ptr(),
            final.data_ptr(), work.data_ptr(),
            work.data_ptr() + 4 * bsz * h * (s // q),
            ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_state")
    state_launches += 1
    return prev, final


def chunk_scan(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, prev: torch.Tensor, *, chunk: int = 256
               ) -> torch.Tensor:
    """y (B, S, H, P) in x's dtype (``ssd_chunk_scan``); ``prev`` from
    :func:`chunk_state`."""
    global scan_launches
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_scan_plain(x, log_a, b_mat, c_mat, prev, q)
    refuse_grad("ssd_chunk_scan", x, log_a, b_mat, c_mat, prev)
    _check(x, log_a, b_mat, c_mat, chunk, None)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    if (tuple(prev.shape) != (bsz, h, s // q, p, n)
            or prev.dtype != torch.float32 or not prev.is_contiguous()
            or prev.device != x.device):
        raise ValueError(f"prev {tuple(prev.shape)} {prev.dtype}: want "
                         f"contiguous fp32 {(bsz, h, s // q, p, n)} on {x.device}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    dims = _dims(x, log_a, b_mat, c_mat, q)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_scan(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            prev.data_ptr(), y.data_ptr(), ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_scan")
    scan_launches += 1
    return y


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD scan → (y (B,S,H,P), final_state (B,H,P,N)), x's dtype:
    :func:`chunk_state`, then :func:`chunk_scan`."""
    prev, final = chunk_state(x, log_a, b_mat, chunk=chunk,
                              initial_state=initial_state)
    return chunk_scan(x, log_a, b_mat, c_mat, prev, chunk=chunk), final
