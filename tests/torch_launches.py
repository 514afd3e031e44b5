"""The kernels' launches on the CPU, for the tests that hold a step as a
CUDA graph would capture it: every launch of flash attention, the SSD
scan and the grouped GEMM replaced by its plain version on the CPU tensors
it is given (the wrappers then take their card's branches), and a trace of
a step's aten ops in which each launch is one op.  Imports torch and the
port only (no jax), so the mesh tests' rank workers use it too.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map as pytree_map

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import ssd_scan as kssd

#: ops that read a device value on the host (``.item()`` reaches a dispatch
#: mode as ``aten.item``), or make a tensor from host data
FORBIDDEN = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.item", "aten.nonzero")
#: each kernel's launch, by the attribute the wrappers call it through
LAUNCHES = ((fa, "_forward"), (fa, "flash_attention_bwd"), (moe_gmm, "_forward"),
            (moe_gmm, "grouped_matmul_dx"), (moe_gmm, "grouped_matmul_dw"),
            (kssd, "_state_launch"), (kssd, "_scan_launch"),
            (kssd, "_state_bwd_launch"), (kssd, "_scan_bwd_launch"))


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("T", x.dtype, tuple(x.shape))
    if isinstance(x, torch.ScriptObject):     # a c10d op's process group or op
        return ("S", str(x._type()))
    return x


class Trace(TorchDispatchMode):
    """Each aten op: its name, and its arguments with every tensor as its
    (dtype, shape) and every other value as it is.  Nothing is recorded
    while ``paused``."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.ops.append((str(func), pytree_map(_sig, args), pytree_map(_sig, kwargs)))
        return func(*args, **kwargs)


def record_launches(monkeypatch, trace):
    """The wrappers take their card's branches on CPU tensors with the
    plain versions as launches (``patch_plain_launches``); each launch is
    recorded as one op with its arguments, its plain version unrecorded
    (the grouped GEMM's reads the group sizes on the host, which the kernel
    reads on the device)."""
    patch_plain_launches(monkeypatch)
    for module, name in LAUNCHES:
        plain = getattr(module, name)

        def launch(*args, _plain=plain, _name=name, **kwargs):
            trace.ops.append((f"{_name} kernel", pytree_map(_sig, args),
                              pytree_map(_sig, kwargs)))
            trace.paused = True
            try:
                return _plain(*args, **kwargs)
            finally:
                trace.paused = False

        monkeypatch.setattr(module, name, launch)


def assert_same_and_clean(first, second, launches=True):
    """Two traces equal op by op, neither with a forbidden op; with
    ``launches``, some kernel launched (on the CPU hubert's bidirectional
    attention takes the plain attention, not the kernel's branch)."""
    assert any(op[0].endswith(" kernel") for op in first) == launches
    bad = sorted({op[0] for op in first + second
                  if op[0].split(".")[:2] in [f.split(".") for f in FORBIDDEN]})
    assert not bad, bad
    assert len(first) == len(second)
    for i, (a, b) in enumerate(zip(first, second)):
        assert a == b, f"op {i} differs between steps 1 and 2: {a} / {b}"


def patch_plain_launches(monkeypatch) -> dict[str, int]:
    """Every kernel launch of flash attention, the SSD scan and the grouped
    GEMM replaced by its plain version on the CPU tensors it is given, each
    counted by name in the dict returned; the wrappers take their card's
    branches (the autograd.Functions and their vmap rules) for CPU
    tensors (the grouped GEMM's take them on the CPU as well)."""
    from repro_torch.kernels import batched, needs_grad
    calls = {"fa": 0, "fa_bwd": 0, "state": 0, "scan": 0, "state_bwd": 0,
             "scan_bwd": 0, "gmm": 0, "gmm_dx": 0, "gmm_dw": 0}

    def q_of(x, chunk):
        return min(chunk, x.shape[1])

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    plain_fa = fa.flash_attention

    def fa_on_card(q, k, v, *, causal=True, window=0):
        # the card's branch of the wrapper, on CPU tensors
        if needs_grad(q, k, v) or batched(q, k, v):
            return fa.FlashAttention.apply(q, k, v, causal, window)[0]
        return plain_fa(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fa, "_forward", counted(
        "fa", lambda q, k, v, causal, window, with_lse:
        fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)))
    monkeypatch.setattr(fa, "flash_attention_bwd", counted(
        "fa_bwd", fa.flash_attention_bwd_plain))
    monkeypatch.setattr(fa, "flash_attention", fa_on_card)
    monkeypatch.setattr(moe_gmm, "_forward", counted("gmm", moe_gmm.grouped_matmul_plain))
    monkeypatch.setattr(moe_gmm, "grouped_matmul_dx", counted(
        "gmm_dx", moe_gmm.grouped_matmul_dx_plain))
    monkeypatch.setattr(moe_gmm, "grouped_matmul_dw", counted(
        "gmm_dw", moe_gmm.grouped_matmul_dw_plain))
    monkeypatch.setattr(kssd, "_on_card", lambda x: True)
    monkeypatch.setattr(kssd, "_state_launch", counted(
        "state", lambda x, la, b, chunk, init:
        kssd.chunk_state_plain(x, la, b, q_of(x, chunk), init)))
    monkeypatch.setattr(kssd, "_scan_launch", counted(
        "scan", lambda x, la, b, c, prev, chunk:
        kssd.chunk_scan_plain(x, la, b, c, prev, q_of(x, chunk))))
    monkeypatch.setattr(kssd, "_scan_bwd_launch", counted(
        "scan_bwd", lambda x, la, b, c, prev, dy, gnext, d_total, chunk:
        kssd.chunk_scan_bwd_plain(x, la, b, c, prev, dy, gnext, d_total,
                                  q_of(x, chunk))))
    monkeypatch.setattr(kssd, "_state_bwd_launch", counted(
        "state_bwd", lambda dy, la, c, prev, dfinal, chunk:
        kssd.chunk_state_bwd_plain(dy, la, c, prev, q_of(dy, chunk), dfinal)))
    return calls
