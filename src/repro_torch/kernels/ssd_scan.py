"""Mamba2 SSD chunked scan: the CUDA kernels' wrappers and their plain versions.

Port of the TPU kernels ``repro.kernels.ssd_scan`` (``_intra_kernel``, the
host ``associative_scan`` over chunk states, ``_inter_kernel``), and a
backward that the Pallas kernels never had (the reference differentiates
its plain SSD with XLA).  The kernels are ``csrc/ssd_scan.cu`` (CUDA C++
for sm_90a; its notes say what bounds them and how the work is split):

* ``ssd_chunk_state`` — every chunk's state ``Σ_j exp(total − cum_j)
  x_j ⊗ B_j`` (fp32), handed along the chunks from block to block (the
  state entering each chunk) and the final state; plain version
  :func:`chunk_state_plain`;
* ``ssd_chunk_scan``  — y, intra- and inter-chunk terms together; plain
  version :func:`chunk_scan_plain`;
* ``ssd_chunk_state_bwd`` — the backward's state pass, in reverse: the
  gradient of the state leaving each chunk (fp32), the initial state's and
  each chunk's dT term; plain version :func:`chunk_state_bwd_plain`;
* ``ssd_chunk_scan_bwd`` — the rest of the gradient in final form: dx,
  dlog_a, and dB and dC summed over each block's heads (fp32 slices);
  plain version :func:`chunk_scan_bwd_plain`.  The glue after them
  (:func:`_bwd_finish`: the slices of each group added) is torch.

A CPU tensor goes to the plain versions, which compute what the two Pallas
kernels compute (scores and the intra-chunk output in fp32).  A CUDA
tensor goes to the kernels, or the wrapper raises: x, B and C bf16 and
log_a fp32; each of them with its last dim contiguous, rows 16-byte
aligned (any other strides are read in place); (P, N) in
:data:`HEAD_STATE_DIMS`; Q = min(chunk, S) at most 256 and dividing S.
A meta tensor takes the kernels' route, never the plain version: while a
cost counter listens (a dry run) its meta route stands in for each launch
(the same checks and allocations, the call's cost reported to
:mod:`repro_torch.kernels.costs`, no launch count); with none listening it
raises, as for any device without a kernel.
Under grad mode with an input that requires grad, or under
``torch.func.vmap``, :func:`ssd_scan` goes through :class:`SSDScan`;
:func:`chunk_state` and :func:`chunk_scan` alone refuse a gradient (they
have no backward of their own).  There is no fallback to the plain version.

Shapes: x (B,S,H,P) dt-scaled inputs; log_a (B,S,H); b_mat, c_mat
(B,S,G,N) with H a multiple of G; initial_state (B,H,P,N).  Returns
(y (B,S,H,P), final_state (B,H,P,N)), both in x's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (
    _build, batched, costs, fold_members, needs_grad, refuse_grad, unfold_members,
)

#: (head dim P, state dim N) pairs the CUDA source is compiled for (its
#: ``SSD_DISPATCH``)
HEAD_STATE_DIMS = ((64, 128), (64, 64), (64, 16), (16, 16), (16, 8))

#: the longest chunk the kernels take (Q rows of one chunk in one block)
MAX_CHUNK = 256

#: the most heads a block of ``ssd_chunk_scan_bwd`` walks (its kMaxRep)
MAX_BWD_HEADS = 12

#: kernel launches since the last reset; each wrapper adds one per launch
state_launches = 0
scan_launches = 0
state_bwd_launches = 0
scan_bwd_launches = 0


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


def chunk_state_bwd_plain(dy: torch.Tensor, log_a: torch.Tensor,
                          c_mat: torch.Tensor, prev: torch.Tensor, q: int,
                          dfinal: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, ...]:
    """Plain version of ``ssd_chunk_state_bwd``: the state pass in reverse.
    With dprev_c = Σ_i e^{cum_i} dy_i ⊗ C_i (the gradient of the inter term
    through prev_c), G_C = dfinal (or 0) and G_c = dprev_c + e^{T_c} G_c+1
    (T the chunk's total log decay).  Returns (gnext (B,H,C,P,N): G_c+1, the
    gradient of the state leaving chunk c; dinit (B,H,P,N): G_0, the initial
    state's; dT (B,H,C): e^{T_c} ⟨prev_c, G_c+1⟩), all fp32."""
    bsz, s, h, p = dy.shape
    g, n = c_mat.shape[2], c_mat.shape[3]
    c, rep = s // q, h // g
    dyq = dy.float().reshape(bsz, c, q, g, rep, p)
    cq = c_mat.float().reshape(bsz, c, q, g, n)
    cum = _chunk_cumsum(log_a, g, q)                       # (B,C,Q,G,R)
    dprev = torch.einsum("bcigrp,bcign,bcigr->bgrcpn", dyq, cq, cum.exp())
    seg = cum[:, :, -1].exp().permute(0, 2, 3, 1)          # (B,G,R,C)
    run = (dfinal.float().reshape(bsz, g, rep, p, n) if dfinal is not None
           else torch.zeros((bsz, g, rep, p, n), dtype=torch.float32,
                            device=dy.device))
    gnext = [None] * c
    for ci in reversed(range(c)):
        gnext[ci] = run
        run = dprev[:, :, :, ci] + seg[..., ci, None, None] * run
    gnext = torch.stack(gnext, dim=3)                      # (B,G,R,C,P,N)
    d_total = seg * torch.einsum("bgrcpn,bgrcpn->bgrc",
                                 prev.reshape(bsz, g, rep, c, p, n), gnext)
    return (gnext.reshape(bsz, h, c, p, n), run.reshape(bsz, h, p, n),
            d_total.reshape(bsz, h, c).contiguous())


def chunk_scan_bwd_plain(x: torch.Tensor, log_a: torch.Tensor,
                         b_mat: torch.Tensor, c_mat: torch.Tensor,
                         prev: torch.Tensor, dy: torch.Tensor,
                         gnext: torch.Tensor, d_total: torch.Tensor, q: int
                         ) -> tuple[torch.Tensor, ...]:
    """Plain version of ``ssd_chunk_scan_bwd``: the rest of the gradient,
    from :func:`chunk_state_bwd_plain`'s G_c+1 (``gnext``) and dT.  Per
    chunk, with S_ij = (C_i·B_j) e^{cum_i − cum_j} for j ≤ i (masked before
    exp), dS_ij = dy_i·x_j, A_ij = dS_ij e^{cum_i − cum_j}, R = S ∘ dS,
    w_j = e^{T − cum_j} and G = G_c+1:

    * dx_j = Σ_i S_ij dy_i + w_j G B_j;
    * dB_j = Σ_i A_ij C_i + w_j Gᵀ x_j, dC_i = Σ_j A_ij B_j + e^{cum_i}
      prev_cᵀ dy_i, each summed over a group's heads;
    * dcum_i = Σ_j R_ij − Σ_i' R_i'i + e^{cum_i} dy_i·(prev_c C_i) − w_i
      x_iᵀ G B_i, and at the chunk's last step also dT + Σ_j w_j x_jᵀ G B_j;
      dlog_a is its reverse cumsum within the chunk.

    Returns (dx in x's dtype, dlog_a (B,S,H) fp32, dB and dC as (B,S,G,1,N)
    fp32: one slice of each group's heads, as the kernel's slices)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    c, rep = s // q, h // g
    xq = x.float().reshape(bsz, c, q, g, rep, p)
    dyq = dy.float().reshape(bsz, c, q, g, rep, p)
    bq = b_mat.float().reshape(bsz, c, q, g, n)
    cq = c_mat.float().reshape(bsz, c, q, g, n)
    cum = _chunk_cumsum(log_a, g, q)                       # (B,C,Q,G,R)

    dc = torch.einsum("bgrcpn,bcigrp->bcigrn",
                      prev.reshape(bsz, g, rep, c, p, n), dyq) * cum.exp()[..., None]
    dcum = torch.einsum("bcigrn,bcign->bcigr", dc, cq)

    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, None, :, :, None, None]              # [i, j]
    delta = torch.where(mask, cum[:, :, :, None] - cum[:, :, None], 0.0)
    decay = torch.where(mask, delta.exp(), 0.0)            # (B,C,Qi,Qj,G,R)
    scores = torch.einsum("bcign,bcjgn->bcijg", cq, bq)[..., None] * decay
    ds = torch.einsum("bcigrp,bcjgrp->bcijgr", dyq, xq)
    dx = torch.einsum("bcijgr,bcigrp->bcjgrp", scores, dyq)
    dscore = ds * decay
    dc = dc + torch.einsum("bcijgr,bcjgn->bcigrn", dscore, bq)
    db = torch.einsum("bcijgr,bcign->bcjgrn", dscore, cq)
    r = scores * ds
    dcum = dcum + r.sum(3) - r.sum(2)

    w = torch.exp(cum[:, :, -1:] - cum)                    # (B,C,Q,G,R)
    gn = gnext.reshape(bsz, g, rep, c, p, n)
    gb = torch.einsum("bgrcpn,bcjgn->bcjgrp", gn, bq)
    gx = torch.einsum("bgrcpn,bcjgrp->bcjgrn", gn, xq)
    t = torch.einsum("bcjgrp,bcjgrp->bcjgr", xq, gb) * w
    dx = dx + gb * w[..., None]
    db = db + gx * w[..., None]
    dcum = dcum - t
    dcum[:, :, -1] += t.sum(2) + d_total.reshape(bsz, g, rep, c).permute(0, 3, 1, 2)
    dla = dcum.flip(2).cumsum(2).flip(2)
    return (dx.reshape(bsz, s, h, p).to(x.dtype), dla.reshape(bsz, s, h),
            db.sum(4).reshape(bsz, s, g, 1, n), dc.sum(4).reshape(bsz, s, g, 1, n))


def _bwd_finish(dx, dla, db, dc, dinit, log_a, b_mat, c_mat,
                init_dtype: torch.dtype | None):
    """The backward's glue after the two kernels (or their plain versions):
    dB and dC are the sums of their slices (B, S, G, k, N), added in a fixed
    order (elementwise: the same bits whatever the batch), each cast to its
    input's dtype; the initial state's gradient is G_0."""
    def total(slices):
        out = slices[:, :, :, 0]
        for k in range(1, slices.shape[3]):
            out = out + slices[:, :, :, k]
        return out

    return (dx, dla.to(log_a.dtype), total(db).to(b_mat.dtype),
            total(dc).to(c_mat.dtype),
            dinit.to(init_dtype) if init_dtype is not None else None)


def ssd_scan_bwd_plain(x: torch.Tensor, log_a: torch.Tensor,
                       b_mat: torch.Tensor, c_mat: torch.Tensor,
                       prev: torch.Tensor, dy: torch.Tensor, q: int,
                       dfinal: torch.Tensor | None = None,
                       initial_state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor | None, ...]:
    """The SSD scan's gradient in the kernels' decomposition (not autograd
    of :func:`ssd_scan_plain`), from ``dy``, an optional ``dfinal`` and
    ``prev`` (the states entering each chunk, from the forward): (dx,
    dlog_a, dB, dC, dinitial_state), each in its input's dtype (dinitial_state
    None without an initial state)."""
    gnext, dinit, d_total = chunk_state_bwd_plain(dy, log_a, c_mat, prev, q, dfinal)
    dx, dla, db, dc = chunk_scan_bwd_plain(x, log_a, b_mat, c_mat, prev, dy,
                                           gnext, d_total, q)
    return _bwd_finish(dx, dla, db, dc, dinit, log_a, b_mat, c_mat,
                       initial_state.dtype if initial_state is not None else None)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the four C entry points of a loaded build of ``ssd_scan.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.ssd_chunk_state.argtypes = [ctypes.c_void_p] * 10
    lib.ssd_chunk_state.restype = ctypes.c_int
    lib.ssd_chunk_scan.argtypes = [ctypes.c_void_p] * 8
    lib.ssd_chunk_scan.restype = ctypes.c_int
    lib.ssd_chunk_scan_bwd.argtypes = [ctypes.c_void_p] * 14
    lib.ssd_chunk_scan_bwd.restype = ctypes.c_int
    lib.ssd_chunk_state_bwd.argtypes = [ctypes.c_void_p] * 12
    lib.ssd_chunk_state_bwd.restype = ctypes.c_int
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


def _dims(x, log_a, b_mat, c_mat, q, *extra: int) -> ctypes.Array:
    bsz, s, h, p = x.shape
    vals = [bsz, s, h, b_mat.shape[2], p, b_mat.shape[3], q,
            *x.stride()[:3], *log_a.stride(), *b_mat.stride()[:3],
            *c_mat.stride()[:3], *extra]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version); True for a CUDA one and
    for a meta one under a cost counter (the kernels' route; a dry run's
    stand-in); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda" and not costs.meta_route(x):
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _dims_of(x, b_mat, q):
    bsz, s, h, p = x.shape
    return bsz, s, h, p, b_mat.shape[2], b_mat.shape[3], q


def chunk_state(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor, *,
                chunk: int = 256, initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(prev (B, H, C, P, N) fp32: the state entering each chunk, the
    final state (B, H, P, N) in x's dtype) — ``ssd_chunk_state``."""
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_state_plain(x, log_a, b_mat, q, initial_state)
    refuse_grad("ssd_chunk_state", x, log_a, b_mat, initial_state)
    return _state_launch(x, log_a, b_mat, chunk, initial_state)


def _state_launch(x, log_a, b_mat, chunk, initial_state):
    """One launch of ``ssd_chunk_state`` (checked first; no autograd)."""
    global state_launches
    q = _check(x, log_a, b_mat, b_mat, chunk, initial_state)
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
    cost = (costs.ssd, *_dims_of(x, b_mat, q), "chunk_state", 4 if init is not None else 0)
    if costs.meta_route(x):
        costs.report("ssd_chunk_state", *cost)
        return prev, final
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
    costs.report("ssd_chunk_state", *cost)
    return prev, final


def chunk_scan(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, prev: torch.Tensor, *, chunk: int = 256
               ) -> torch.Tensor:
    """y (B, S, H, P) in x's dtype (``ssd_chunk_scan``); ``prev`` from
    :func:`chunk_state`."""
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_scan_plain(x, log_a, b_mat, c_mat, prev, q)
    refuse_grad("ssd_chunk_scan", x, log_a, b_mat, c_mat, prev)
    return _scan_launch(x, log_a, b_mat, c_mat, prev, chunk)


def _check_fp32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if (tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                         f"contiguous fp32 {shape} on {device}")


def _scan_launch(x, log_a, b_mat, c_mat, prev, chunk):
    """One launch of ``ssd_chunk_scan`` (checked first; no autograd)."""
    global scan_launches
    q = _check(x, log_a, b_mat, c_mat, chunk, None)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    _check_fp32("prev", prev, (bsz, h, s // q, p, n), x.device)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    cost = (costs.ssd, *_dims_of(x, b_mat, q), "chunk_scan")
    if costs.meta_route(x):
        costs.report("ssd_chunk_scan", *cost)
        return y
    dims = _dims(x, log_a, b_mat, c_mat, q)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_scan(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            prev.data_ptr(), y.data_ptr(), ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_scan")
    scan_launches += 1
    costs.report("ssd_chunk_scan", *cost)
    return y


def bwd_heads_per_block(h: int, g: int) -> int:
    """Heads a block of ``ssd_chunk_scan_bwd`` walks (its ``rep``): the
    largest divisor of a group's heads up to :data:`MAX_BWD_HEADS`.  The
    kernel sums dB and dC over them on chip and writes one fp32 slice of
    each a block; it does not depend on the batch, so a gang member's
    gradient has the same bits alone and in the gang."""
    per_group = h // g
    return max(d for d in range(1, min(per_group, MAX_BWD_HEADS) + 1)
               if per_group % d == 0)


def chunk_state_bwd(dy: torch.Tensor, log_a: torch.Tensor, c_mat: torch.Tensor,
                    prev: torch.Tensor, *, chunk: int = 256,
                    dfinal: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, ...]:
    """``ssd_chunk_state_bwd`` (the plain version on a CPU tensor): (gnext,
    dinit, dT), fp32, as :func:`chunk_state_bwd_plain` gives them.  ``dy``
    (B, S, H, P) in x's dtype; ``prev`` the forward's states."""
    q = min(chunk, dy.shape[1])
    if not _on_card(dy):
        _check_divides(dy.shape[1], q)
        return chunk_state_bwd_plain(dy, log_a, c_mat, prev, q, dfinal)
    return _state_bwd_launch(dy, log_a, c_mat, prev, dfinal, chunk)


def _state_bwd_launch(dy, log_a, c_mat, prev, dfinal, chunk):
    """One launch of ``ssd_chunk_state_bwd`` (checked first)."""
    global state_bwd_launches
    dy = dy.contiguous()
    q = _check(dy, log_a, c_mat, c_mat, chunk, None)
    bsz, s, h, p = dy.shape
    n = c_mat.shape[3]
    _check_fp32("prev", prev, (bsz, h, s // q, p, n), dy.device)
    if dfinal is not None:
        if tuple(dfinal.shape) != (bsz, h, p, n):
            raise ValueError(f"dfinal {tuple(dfinal.shape)}, want {(bsz, h, p, n)}")
        dfinal = dfinal.to(torch.float32).contiguous()
    f32 = {"dtype": torch.float32, "device": dy.device}
    gnext = torch.empty((bsz, h, s // q, p, n), **f32)
    dinit = torch.empty((bsz, h, p, n), **f32)
    d_total = torch.empty((bsz, h, s // q), **f32)
    # the hand-off's flags, one a chunk, then its ticket: zeroed every call
    work = torch.zeros(bsz * h * (s // q) + 1, dtype=torch.int32, device=dy.device)
    cost = (costs.ssd_bwd, *_dims_of(dy, c_mat, q), "chunk_state_bwd", dfinal is not None)
    if costs.meta_route(dy):
        costs.report("ssd_chunk_state_bwd", *cost)
        return gnext, dinit, d_total
    dims = _dims(dy, log_a, c_mat, c_mat, q)
    with torch.cuda.device(dy.device):
        _raise_on(_library().ssd_chunk_state_bwd(
            dy.data_ptr(), log_a.data_ptr(), c_mat.data_ptr(), prev.data_ptr(),
            dfinal.data_ptr() if dfinal is not None else None, gnext.data_ptr(),
            dinit.data_ptr(), d_total.data_ptr(), work.data_ptr(),
            work.data_ptr() + 4 * bsz * h * (s // q), ctypes.addressof(dims),
            torch.cuda.current_stream(dy.device).cuda_stream), "ssd_chunk_state_bwd")
    state_bwd_launches += 1
    costs.report("ssd_chunk_state_bwd", *cost)
    return gnext, dinit, d_total


def chunk_scan_bwd(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, prev: torch.Tensor, dy: torch.Tensor,
                   gnext: torch.Tensor, d_total: torch.Tensor, *,
                   chunk: int = 256) -> tuple[torch.Tensor, ...]:
    """``ssd_chunk_scan_bwd`` (the plain version on a CPU tensor): (dx in
    x's dtype, dlog_a (B, S, H) fp32, dB and dC as (B, S, G, k, N) fp32
    slices, k per group), as :func:`chunk_scan_bwd_plain` gives them (k 1
    there); ``gnext`` and ``d_total`` from :func:`chunk_state_bwd`."""
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_scan_bwd_plain(x, log_a, b_mat, c_mat, prev, dy, gnext,
                                    d_total, q)
    return _scan_bwd_launch(x, log_a, b_mat, c_mat, prev, dy, gnext, d_total, chunk)


def _scan_bwd_launch(x, log_a, b_mat, c_mat, prev, dy, gnext, d_total, chunk):
    """One launch of ``ssd_chunk_scan_bwd`` (checked first)."""
    global scan_bwd_launches
    q = _check(x, log_a, b_mat, c_mat, chunk, None)
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    for name, t, shape in (("prev", prev, (bsz, h, s // q, p, n)),
                           ("gnext", gnext, (bsz, h, s // q, p, n)),
                           ("d_total", d_total, (bsz, h, s // q))):
        _check_fp32(name, t, shape, x.device)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device}: "
                         f"want x's {tuple(x.shape)} {x.dtype} on {x.device}")
    dy = dy.contiguous()
    rep = bwd_heads_per_block(h, g)
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    dla = torch.empty((bsz, s, h), **f32)
    db = torch.empty((bsz, s, h // rep, n), **f32)
    dc = torch.empty((bsz, s, h // rep, n), **f32)
    k = h // rep // g
    cost = (costs.ssd_bwd, *_dims_of(x, b_mat, q), "chunk_scan_bwd")
    if costs.meta_route(x):
        costs.report("ssd_chunk_scan_bwd", *cost, slices=k)
        return dx, dla, db.view(bsz, s, g, k, n), dc.view(bsz, s, g, k, n)
    dims = _dims(x, log_a, b_mat, c_mat, q, rep)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_scan_bwd(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            dy.data_ptr(), prev.data_ptr(), gnext.data_ptr(), d_total.data_ptr(),
            dx.data_ptr(), dla.data_ptr(), db.data_ptr(), dc.data_ptr(),
            ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_scan_bwd")
    scan_bwd_launches += 1
    costs.report("ssd_chunk_scan_bwd", *cost, slices=k)
    return dx, dla, db.view(bsz, s, g, k, n), dc.view(bsz, s, g, k, n)


def ssd_scan_bwd(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                 c_mat: torch.Tensor, prev: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 256, dfinal: torch.Tensor | None = None,
                 init_dtype: torch.dtype | None = None
                 ) -> tuple[torch.Tensor | None, ...]:
    """The SSD scan's gradient as :class:`SSDScan`'s backward runs it:
    :func:`chunk_state_bwd`, :func:`chunk_scan_bwd`, then the glue (the
    plain versions on a CPU tensor).  (dx, dlog_a, dB, dC, dinitial_state
    in ``init_dtype``, or None)."""
    gnext, dinit, d_total = chunk_state_bwd(dy, log_a, c_mat, prev, chunk=chunk,
                                            dfinal=dfinal)
    dx, dla, db, dc = chunk_scan_bwd(x, log_a, b_mat, c_mat, prev, dy, gnext,
                                     d_total, chunk=chunk)
    return _bwd_finish(dx, dla, db, dc, dinit, log_a, b_mat, c_mat, init_dtype)


class SSDScan(torch.autograd.Function):
    """The kernels under autograd: the forward launches ``ssd_chunk_state``
    and ``ssd_chunk_scan`` and saves x, log_a, B, C and the states entering
    each chunk (fp32); the backward launches ``ssd_chunk_state_bwd`` (the
    state pass in reverse), then ``ssd_chunk_scan_bwd`` (dx, dlog_a, and dB
    and dC summed over each block's heads), and adds the dB and dC slices
    of each group (torch glue).  Under ``torch.func.vmap`` the rule
    folds the member dim into the batch: one launch of each kernel for all
    members, forward and backward.  Outputs: y, the final state, and the
    states (not differentiable)."""

    @staticmethod
    def forward(x, log_a, b_mat, c_mat, initial_state, chunk):
        prev, final = _state_launch(x, log_a, b_mat, chunk, initial_state)
        return _scan_launch(x, log_a, b_mat, c_mat, prev, chunk), final, prev

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, log_a, b_mat, c_mat, initial_state, chunk = inputs
        ctx.save_for_backward(x, log_a, b_mat, c_mat, output[2])
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.init_dtype = initial_state.dtype if initial_state is not None else None

    @staticmethod
    def backward(ctx, dy, dfinal, _):
        x, log_a, b_mat, c_mat, prev = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        return ssd_scan_bwd(x, log_a, b_mat, c_mat, prev, dy, chunk=ctx.chunk,
                            dfinal=dfinal, init_dtype=ctx.init_dtype) + (None,)

    @staticmethod
    def vmap(info, in_dims, x, log_a, b_mat, c_mat, initial_state, chunk):
        m = info.batch_size
        folded = [fold_members(t, d, m) for t, d in
                  zip((x, log_a, b_mat, c_mat, initial_state), in_dims[:5])]
        outs = SSDScan.apply(*folded, chunk)
        return tuple(unfold_members(t, m) for t in outs), (0, 0, 0)


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD scan → (y (B,S,H,P), final_state (B,H,P,N)), x's dtype:
    :func:`chunk_state`, then :func:`chunk_scan`.  On the card, under grad
    mode with an input that requires grad, or under ``torch.func.vmap``, the
    call goes through :class:`SSDScan`."""
    if _on_card(x) and (needs_grad(x, log_a, b_mat, c_mat, initial_state)
                        or batched(x, log_a, b_mat, c_mat, initial_state)):
        y, final, _ = SSDScan.apply(x, log_a, b_mat, c_mat, initial_state, chunk)
        return y, final
    prev, final = chunk_state(x, log_a, b_mat, chunk=chunk,
                              initial_state=initial_state)
    return chunk_scan(x, log_a, b_mat, c_mat, prev, chunk=chunk), final
