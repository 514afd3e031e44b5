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
* ``ssd_chunk_scan_bwd`` — the gradient of the scan's y: the intra term's
  dx, dB and dC per head, each chunk's dprev and dcum; plain version
  :func:`chunk_scan_bwd_plain`;
* ``ssd_chunk_state_bwd`` — the state pass in reverse and the chunk-state
  term; plain version :func:`chunk_state_bwd_plain`.  The glue between
  them and the inputs' gradients (:func:`_bwd_finish`) is torch.

A CPU tensor goes to the plain versions, which compute what the two Pallas
kernels compute (scores and the intra-chunk output in fp32).  A CUDA
tensor goes to the kernels, or the wrapper raises: x, B and C bf16 and
log_a fp32; each of them with its last dim contiguous, rows 16-byte
aligned (any other strides are read in place); (P, N) in
:data:`HEAD_STATE_DIMS`; Q = min(chunk, S) at most 256 and dividing S.
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
    _build, batched, fold_members, needs_grad, refuse_grad, unfold_members,
)

#: (head dim P, state dim N) pairs the CUDA source is compiled for (its
#: ``SSD_DISPATCH``)
HEAD_STATE_DIMS = ((64, 128), (64, 64), (64, 16), (16, 16))

#: the longest chunk the kernels take (Q rows of one chunk in one block)
MAX_CHUNK = 256

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


def chunk_scan_bwd_plain(x: torch.Tensor, log_a: torch.Tensor,
                         b_mat: torch.Tensor, c_mat: torch.Tensor,
                         prev: torch.Tensor, dy: torch.Tensor, q: int
                         ) -> tuple[torch.Tensor, ...]:
    """Plain version of ``ssd_chunk_scan_bwd``: the gradient of
    :func:`chunk_scan_plain`'s y, all fp32.  Per chunk, with S_ij =
    (C_i·B_j) exp(cum_i − cum_j) for j ≤ i (masked before exp):

    * inter term: dprev_c = Σ_i e^{cum_i} dy_i ⊗ C_i, dC_i += e^{cum_i}
      prev_cᵀ dy_i, dcum_i += e^{cum_i} dy_i·(prev_c C_i);
    * intra term: dx_j = Σ_i S_ij dy_i; with dS_ij = dy_i·x_j, dC_i +=
      Σ_j dS_ij e^{cum_i−cum_j} B_j, dB_j = Σ_i dS_ij e^{cum_i−cum_j} C_i,
      dcum_i += Σ_j S_ij dS_ij and dcum_j −= Σ_i S_ij dS_ij.

    Returns (dx (B,S,H,P), dB and dC per head (B,S,H,N), dprev (B,H,C,P,N),
    dcum (B,S,H))."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    c, rep = s // q, h // g
    xq = x.float().reshape(bsz, c, q, g, rep, p)
    dyq = dy.float().reshape(bsz, c, q, g, rep, p)
    bq = b_mat.float().reshape(bsz, c, q, g, n)
    cq = c_mat.float().reshape(bsz, c, q, g, n)
    cum = _chunk_cumsum(log_a, g, q)                       # (B,C,Q,G,R)
    ecum = cum.exp()

    dprev = torch.einsum("bcigrp,bcign,bcigr->bgrcpn", dyq, cq, ecum)
    dc = torch.einsum("bgrcpn,bcigrp->bcigrn",
                      prev.reshape(bsz, g, rep, c, p, n), dyq) * ecum[..., None]
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
    return (dx.reshape(bsz, s, h, p), db.reshape(bsz, s, h, n),
            dc.reshape(bsz, s, h, n), dprev.reshape(bsz, h, c, p, n),
            dcum.reshape(bsz, s, h))


def chunk_state_bwd_plain(x: torch.Tensor, log_a: torch.Tensor,
                          b_mat: torch.Tensor, prev: torch.Tensor,
                          dprev: torch.Tensor, dx: torch.Tensor,
                          db: torch.Tensor, dcum: torch.Tensor, q: int,
                          dfinal: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, ...]:
    """Plain version of ``ssd_chunk_state_bwd``: the state pass in reverse
    and the chunk-state term, added to what :func:`chunk_scan_bwd_plain`
    gave.  With G_C = dfinal (or 0) and G_c = dprev_c + e^{T_c} G_c+1 (T the
    chunk's total log decay), dT_c = e^{T_c} ⟨prev_c, G_c+1⟩; then with
    w_j = e^{T − cum_j}: dx_j += w_j G_c+1 B_j, dB_j += w_j G_c+1ᵀ x_j,
    dT += Σ_j w_j x_jᵀ G_c+1 B_j and dcum_j −= the same term; dT is added
    to the chunk's last dcum.  Returns (dx, dB per head, dcum, G (B,H,C,P,N):
    G_c, the gradient of the state entering chunk c; G_0 is the initial
    state's)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    c, rep = s // q, h // g
    xq = x.float().reshape(bsz, c, q, g, rep, p)
    bq = b_mat.float().reshape(bsz, c, q, g, n)
    cum = _chunk_cumsum(log_a, g, q)                       # (B,C,Q,G,R)
    total = cum[:, :, -1]                                  # (B,C,G,R)
    seg = total.exp().permute(0, 2, 3, 1)                  # (B,G,R,C)
    dprev = dprev.reshape(bsz, g, rep, c, p, n)
    run = (dfinal.float().reshape(bsz, g, rep, p, n) if dfinal is not None
           else torch.zeros((bsz, g, rep, p, n), dtype=torch.float32,
                            device=x.device))
    g_next, g_tot = [None] * c, [None] * c
    for ci in reversed(range(c)):
        g_next[ci] = run
        run = dprev[:, :, :, ci] + seg[..., ci, None, None] * run
        g_tot[ci] = run
    g_next = torch.stack(g_next, dim=3)                    # (B,G,R,C,P,N)
    d_total = seg * torch.einsum("bgrcpn,bgrcpn->bgrc",
                                 prev.reshape(bsz, g, rep, c, p, n), g_next)
    w = torch.exp(total[:, :, None] - cum)                 # (B,C,Q,G,R)
    gb = torch.einsum("bgrcpn,bcjgn->bcjgrp", g_next, bq)
    gx = torch.einsum("bgrcpn,bcjgrp->bcjgrn", g_next, xq)
    t = torch.einsum("bcjgrp,bcjgrp->bcjgr", xq, gb) * w
    d_total = d_total.permute(0, 3, 1, 2) + t.sum(2)       # (B,C,G,R)
    dcum_add = -t
    dcum_add[:, :, -1] += d_total
    return (dx + (gb * w[..., None]).reshape(bsz, s, h, p),
            db + (gx * w[..., None]).reshape(bsz, s, h, n),
            dcum + dcum_add.reshape(bsz, s, h),
            torch.stack(g_tot, dim=3).reshape(bsz, h, c, p, n))


def _bwd_finish(dx, db, dc, dcum, g_tot, x, log_a, b_mat, c_mat, q,
                init_dtype: torch.dtype | None):
    """The backward's glue after the two kernels (or their plain versions):
    dlog_a is the reverse cumsum of dcum within each chunk, dB and dC are
    summed over the heads of a group (the forward reads a group's B and C
    for each of its heads), the initial state's gradient is G_0."""
    bsz, s, h, _ = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    dla = dcum.reshape(bsz, s // q, q, h).flip(2).cumsum(2).flip(2)
    return (dx.to(x.dtype), dla.reshape(bsz, s, h).to(log_a.dtype),
            db.reshape(bsz, s, g, h // g, n).sum(3).to(b_mat.dtype),
            dc.reshape(bsz, s, g, h // g, n).sum(3).to(c_mat.dtype),
            g_tot[:, :, 0].to(init_dtype) if init_dtype is not None else None)


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
    dx, db, dc, dprev, dcum = chunk_scan_bwd_plain(x, log_a, b_mat, c_mat,
                                                   prev, dy, q)
    dx, db, dcum, g_tot = chunk_state_bwd_plain(x, log_a, b_mat, prev, dprev,
                                                dx, db, dcum, q, dfinal)
    return _bwd_finish(dx, db, dc, dcum, g_tot, x, log_a, b_mat, c_mat, q,
                       initial_state.dtype if initial_state is not None else None)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the two C entry points of a loaded build of ``ssd_scan.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.ssd_chunk_state.argtypes = [ctypes.c_void_p] * 10
    lib.ssd_chunk_state.restype = ctypes.c_int
    lib.ssd_chunk_scan.argtypes = [ctypes.c_void_p] * 8
    lib.ssd_chunk_scan.restype = ctypes.c_int
    lib.ssd_chunk_scan_bwd.argtypes = [ctypes.c_void_p] * 13
    lib.ssd_chunk_scan_bwd.restype = ctypes.c_int
    lib.ssd_chunk_state_bwd.argtypes = [ctypes.c_void_p] * 13
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
    dims = _dims(x, log_a, b_mat, c_mat, q)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_scan(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            prev.data_ptr(), y.data_ptr(), ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_scan")
    scan_launches += 1
    return y


def chunk_scan_bwd(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, prev: torch.Tensor, dy: torch.Tensor,
                   *, chunk: int = 256) -> tuple[torch.Tensor, ...]:
    """``ssd_chunk_scan_bwd`` (the plain version on a CPU tensor): (dx, dB
    and dC per head, dprev, dcum), fp32, as :func:`chunk_scan_bwd_plain`
    gives them.  ``dy`` (B, S, H, P) in x's dtype."""
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_scan_bwd_plain(x, log_a, b_mat, c_mat, prev, dy, q)
    return _scan_bwd_launch(x, log_a, b_mat, c_mat, prev, dy, chunk)


def _scan_bwd_launch(x, log_a, b_mat, c_mat, prev, dy, chunk):
    """One launch of ``ssd_chunk_scan_bwd`` (checked first)."""
    global scan_bwd_launches
    q = _check(x, log_a, b_mat, c_mat, chunk, None)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    _check_fp32("prev", prev, (bsz, h, s // q, p, n), x.device)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device}: "
                         f"want x's {tuple(x.shape)} {x.dtype} on {x.device}")
    dy = dy.contiguous()
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty((bsz, s, h, p), **f32)
    db = torch.empty((bsz, s, h, n), **f32)
    dc = torch.empty((bsz, s, h, n), **f32)
    dprev = torch.empty((bsz, h, s // q, p, n), **f32)
    dcum = torch.empty((bsz, s, h), **f32)
    dims = _dims(x, log_a, b_mat, c_mat, q)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_scan_bwd(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            prev.data_ptr(), dy.data_ptr(), dx.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dprev.data_ptr(), dcum.data_ptr(),
            ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_scan_bwd")
    scan_bwd_launches += 1
    return dx, db, dc, dprev, dcum


def chunk_state_bwd(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                    prev: torch.Tensor, dprev: torch.Tensor, dx: torch.Tensor,
                    db: torch.Tensor, dcum: torch.Tensor, *, chunk: int = 256,
                    dfinal: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, ...]:
    """``ssd_chunk_state_bwd`` (the plain version on a CPU tensor): (dx, dB
    per head, dcum, G), as :func:`chunk_state_bwd_plain` gives them.  On the
    card it adds to ``dx``, ``db`` and ``dcum`` in place and turns ``dprev``
    into G in place (the tensors returned are those given)."""
    q = min(chunk, x.shape[1])
    if not _on_card(x):
        _check_divides(x.shape[1], q)
        return chunk_state_bwd_plain(x, log_a, b_mat, prev, dprev, dx, db,
                                     dcum, q, dfinal)
    return _state_bwd_launch(x, log_a, b_mat, prev, dprev, dx, db, dcum, chunk,
                             dfinal)


def _state_bwd_launch(x, log_a, b_mat, prev, dprev, dx, db, dcum, chunk, dfinal):
    """One launch of ``ssd_chunk_state_bwd`` (checked first)."""
    global state_bwd_launches
    q = _check(x, log_a, b_mat, b_mat, chunk, None)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    for name, t, shape in (("prev", prev, (bsz, h, s // q, p, n)),
                           ("dprev", dprev, (bsz, h, s // q, p, n)),
                           ("dx", dx, (bsz, s, h, p)), ("db", db, (bsz, s, h, n)),
                           ("dcum", dcum, (bsz, s, h))):
        _check_fp32(name, t, shape, x.device)
    if dfinal is not None:
        if tuple(dfinal.shape) != (bsz, h, p, n):
            raise ValueError(f"dfinal {tuple(dfinal.shape)}, want {(bsz, h, p, n)}")
        dfinal = dfinal.to(torch.float32).contiguous()
    # the hand-off's flags, one a chunk, then its ticket: zeroed every call
    work = torch.zeros(bsz * h * (s // q) + 1, dtype=torch.int32, device=x.device)
    dims = _dims(x, log_a, b_mat, b_mat, q)
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_chunk_state_bwd(
            x.data_ptr(), log_a.data_ptr(), b_mat.data_ptr(), prev.data_ptr(),
            dfinal.data_ptr() if dfinal is not None else None, dprev.data_ptr(),
            dx.data_ptr(), db.data_ptr(), dcum.data_ptr(), work.data_ptr(),
            work.data_ptr() + 4 * bsz * h * (s // q), ctypes.addressof(dims),
            torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunk_state_bwd")
    state_bwd_launches += 1
    return dx, db, dcum, dprev


class SSDScan(torch.autograd.Function):
    """The kernels under autograd: the forward launches ``ssd_chunk_state``
    and ``ssd_chunk_scan`` and saves x, log_a, B, C and the states entering
    each chunk (fp32); the backward launches ``ssd_chunk_scan_bwd`` and
    ``ssd_chunk_state_bwd``, then sums dB and dC over each group's heads and
    turns dcum into dlog_a (torch glue).  Under ``torch.func.vmap`` the rule
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
        if dy is None:
            dy = torch.zeros_like(x)
        dx, db, dc, dprev, dcum = _scan_bwd_launch(
            x, log_a, b_mat, c_mat, prev, dy.to(x.dtype), ctx.chunk)
        dx, db, dcum, g_tot = _state_bwd_launch(
            x, log_a, b_mat, prev, dprev, dx, db, dcum, ctx.chunk, dfinal)
        dx, dla, dbm, dcm, dinit = _bwd_finish(
            dx, db, dc, dcum, g_tot, x, log_a, b_mat, c_mat,
            min(ctx.chunk, x.shape[1]), ctx.init_dtype)
        return dx, dla, dbm, dcm, dinit, None

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
