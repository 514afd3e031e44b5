"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Port of the TPU kernel ``repro.kernels.flash_attention`` and its padding
wrapper ``repro.kernels.ops.flash_attention``.  The kernels are in
``csrc/flash_attention.cu``, CUDA C++ for sm_90a:

* the forward: a block of three warpgroups serves 128 query rows of one
  (batch, head); one warpgroup issues TMA loads of Q and of a 2-stage K/V
  ring, two multiply with wgmma (QK^T from shared memory, PV with P from
  registers) and run the online softmax between the products.  It can also
  write each row's log-sum-exp (LSE), which the backward reads;
* the backward, which the Pallas kernel never had (the reference
  differentiates its plain attention with XLA): a prep kernel (delta =
  rowsum(dO∘O), the LSE in base 2), then one wgmma + TMA kernel whose
  block owns a tile of key rows of one (batch, KV head), walks the query
  heads of its KV group (or a part of them, when one group's block would
  run far longer than the rest) and computes S and dP once per tile pair:
  dK and dV stay in its registers, dQ's parts are added to an fp32
  accumulator by bulk copies in ascending key-tile order (a chained
  hand-off: deterministic); then a pass that rounds dQ to bf16.  The
  wrapper allocates the kernels' fp32 workspace (:func:`_bwd_workspace_bytes`).

The source's header says what bounds each and what its design does about it.

* A CPU tensor goes to :func:`flash_attention_plain`, a dense masked
  softmax in fp32 (the oracle ``ref.flash_attention_ref``), which
  differentiates by autograd.
* A CUDA tensor goes to the kernels, or the wrapper raises: bf16 only, head
  dims in :data:`HEAD_DIMS`, contiguous (B, S, H, D) layout.
* A meta tensor takes the kernels' route and never the plain version.  While
  a cost counter listens (a dry run, :func:`repro_torch.events.counting`)
  its meta route stands in for the launch: the same checks, the same
  outputs and scratch allocated on the meta device, and the call's cost
  reported; no launch count.  With none listening it raises at the device
  check, as for any device without a kernel.  Under grad
  mode with an input that requires grad, or under ``torch.func.vmap``, the
  call goes through :class:`FlashAttention`, whose forward saves the LSE,
  whose backward launches the backward kernels and whose vmap rule folds
  the member dim into the batch.  There is no fallback to the plain version.

Shapes: q (B, S, Hq, D); k, v (B, S, Hkv, D) with Hq a multiple of Hkv.
Masks: ``causal`` and ``window`` (allowed iff 0 <= q - k < window when
causal; q - k < window otherwise), as in the Pallas kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, batched, costs, fold_members, needs_grad, unfold_members
from .ref import flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref

#: head dims the CUDA source is compiled for (its ``switch`` in
#: ``flash_attention_fwd`` and ``flash_attention_bwd``); 16 is the MoE smoke
#: configs', 64 hymba-1.5b's
HEAD_DIMS = (16, 32, 64, 80, 128, 256)

#: forward kernel launches since the last reset; the wrapper adds one per
#: launch
launches = 0
#: backward launches (its prep, main and dQ-convert kernels) since the last
#: reset; the wrapper adds one per call of ``flash_attention_bwd`` in C
bwd_launches = 0

#: the plain versions of the kernels' functions, for CPU tensors and for
#: holding the kernels against on the card
flash_attention_plain = flash_attention_ref
flash_attention_lse_plain = flash_attention_lse_ref
flash_attention_bwd_plain = flash_attention_bwd_ref


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points of a loaded build of ``flash_attention.cu``."""
    # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.library("flash_attention"))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *like_q: torch.Tensor) -> None:
    if q.device.type != "cuda" and not costs.meta_route(q):
        raise ValueError(f"no kernel for device {q.device}")
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
    for t in like_q:
        if t.shape != q.shape:
            raise ValueError(f"want {tuple(q.shape)}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v),
                    *((f"q-shaped input {i}", t) for i, t in enumerate(like_q))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int, with_lse: bool
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the forward kernel: (O, the rows' LSE or None)."""
    global launches
    _check(q, k, v)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    cost = (costs.attention, b, s, hq, k.shape[2], d, causal, window)
    if costs.meta_route(q):
        costs.report("flash_attention", *cost)
        return out, lse
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            b, s, hq, k.shape[2], d, int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    costs.report("flash_attention", *cost)
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, causal: bool = True, window: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's output and its rows' LSE, (B, Hq, S) fp32 (no
    autograd); the plain versions for a CPU tensor."""
    if q.device.type == "cpu":
        return (flash_attention_plain(q, k, v, causal=causal, window=window),
                flash_attention_lse_plain(q, k, causal=causal, window=window))
    return _forward(q, k, v, causal, window, with_lse=True)


def _bwd_workspace_bytes(b: int, s: int, hq: int, hkv: int, d: int) -> int:
    """Bytes of the backward kernels' fp32 scratch (``bwd::carve`` in the
    source), with S and D rounded up to 64: the dQ accumulator, B·Hq·S_pad·
    D_pad floats; the rows' base-2 LSE and delta, B·Hq·S_pad each; under GQA
    the dK/dV partial sums of blocks that split a KV group's heads,
    2·B·Hkv·S_128·D_pad floats (S rounded up to 128); the dQ hand-off's
    B·Hq·S_pad/64 counters, under GQA the partial sums' B·Hkv·S_pad/64, and
    one ticket."""
    n_qt, d_pad = -(-s // 64), -(-d // 64) * 64
    rows = b * hq * n_qt * 64
    gqa = hq > hkv
    kv_rows = b * hkv * -(-s // 128) * 128 if gqa else 0
    flags = b * hkv * n_qt if gqa else 0
    return 4 * (rows * (d_pad + 2) + 2 * kv_rows * d_pad + b * hq * n_qt + flags + 1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention from the forward's output ``o`` and LSE and
    the output's gradient ``do``; the backward kernels on a CUDA tensor, the
    plain backward on a CPU tensor."""
    global bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    _check(q, k, v, o, do)
    b, s, hq, d = q.shape
    if (lse.shape != (b, hq, s) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be contiguous fp32 {(b, hq, s)} on "
                         f"{q.device}; got {lse.dtype} {tuple(lse.shape)} "
                         f"on {lse.device}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    work = torch.empty(_bwd_workspace_bytes(b, s, hq, k.shape[2], d) // 4,
                       dtype=torch.float32,
                       device=q.device)
    cost = (costs.attention_bwd, b, s, hq, k.shape[2], d, causal, window)
    if costs.meta_route(q):
        costs.report("flash_attention_bwd", *cost)
        return dq, dk, dv
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), work.data_ptr(), b, s, hq, k.shape[2], d,
            int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    costs.report("flash_attention_bwd", *cost)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves q, k, v, O and the LSE;
    the backward launches the backward kernels on dO made contiguous.  Under
    ``torch.func.vmap`` the rule folds the member dim into the batch: one
    launch for all members, forward and backward.  Outputs: O and the LSE
    (not differentiable)."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: int):
        return _forward(q, k, v, causal, window, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, dout, _):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        m = info.batch_size
        # the kernels take contiguous (B, S, H, D) tensors
        folded = [fold_members(t, d, m).contiguous()
                  for t, d in zip((q, k, v), in_dims[:3])]
        out, lse = FlashAttention.apply(*folded, causal, window)
        return (unfold_members(out, m), unfold_members(lse, m)), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Exact attention, output (B, S, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if needs_grad(q, k, v) or batched(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)[0]
    return _forward(q, k, v, causal, window, with_lse=False)[0]
