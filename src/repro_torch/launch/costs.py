"""One counter of a step's costs, the same on the meta device (a dry run)
and on the card.

:class:`Counter` is a ``TorchDispatchMode`` that, inside its ``with``
block, counts on the tensors of one device type:

* **aten FLOPs**, as ``torch.utils.flop_counter`` counts each op (matrix
  products, convolutions, attention ops; elementwise ops count none);
* **HBM bytes**, each op's reads plus writes: every tensor argument's and
  every output's ``numel × element size``, once an op (views and
  allocations move none, and collectives are counted as collectives);
* **the kernels**, which launch through ctypes, invisible to any dispatch
  mode: each wrapper reports its FLOPs and bytes
  (:mod:`repro_torch.kernels.costs`), on the card where it launches and on
  the meta route where a dry run stands in for the launch;
* **collectives** by kind and mesh axis, at the one place every
  collective of the port goes through
  (:mod:`repro_torch.distributed.context`): the count and the
  result's bytes; the ops a backend runs inside one (gloo stages a CUDA
  tensor's reduce-scatter through copies) are not the step's and are not
  counted;
* **live bytes and their peak**: the arguments' storages
  (:meth:`Counter.track`) plus every storage an op makes, each until it is
  freed (a weak reference to the storage), so a kernel's scratch, which the
  meta route allocates as the kernel does, counts too.

With ``strict`` the counter raises on any tensor with elements an op
makes off its device type (a dry run allocates none on the CPU or a
card).  Ops on other
devices are otherwise ignored (on the card, autograd's and checkpoint's
CPU bookkeeping).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import events
from repro_torch.bridge import flatten
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd

#: ops that make a tensor without writing it
_ALLOCATIONS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
                torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """FLOPs, HBM bytes, kernel calls, collectives and the live-bytes peak
    of what runs inside the ``with`` block on ``device_type`` tensors
    (module docstring)."""

    def __init__(self, device_type: str = "meta", strict: bool = False) -> None:
        super().__init__()
        self.device_type = device_type
        self.strict = strict
        self.aten_flops = 0
        self.aten_bytes = 0
        self.kernels: dict[str, dict[str, int]] = {}
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
        self.by_axis: dict[str, dict[str, int]] = {}
        #: {op: [calls, bytes, flops]} of the counted aten ops
        self.ops: dict[str, list[int]] = {}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._storages: dict[int, tuple[int, Any]] = {}
        self._lock = threading.Lock()
        self._stack = contextlib.ExitStack()

    # -- what the counter reads --------------------------------------------
    @property
    def flops(self) -> int:
        return self.aten_flops + sum(k["flops"] for k in self.kernels.values())

    @property
    def hbm_bytes(self) -> int:
        return self.aten_bytes + sum(k["bytes"] for k in self.kernels.values())

    def kernel_calls(self) -> dict[str, int]:
        return {name: k["calls"] for name, k in sorted(self.kernels.items())}

    def summary(self) -> dict[str, Any]:
        """The counts as plain numbers (JSON)."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "aten_flops": self.aten_flops, "aten_bytes": self.aten_bytes,
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
                "collectives": {k: dict(v) for k, v in self.collectives.items()},
                "collectives_by_axis": {a: dict(v) for a, v in self.by_axis.items()},
                "argument_bytes": self.argument_bytes, "peak_bytes": self.peak,
                "output_bytes": self.output_bytes,
                "ops": {k: list(v) for k, v in sorted(self.ops.items())}}

    # -- storages ------------------------------------------------------------
    def track(self, *trees: Any) -> None:
        """Count the storages of ``trees``' tensors (a step's arguments; a
        DTensor's local tensor) as live from now on."""
        for tree in trees:
            for leaf in flatten(tree).values():
                leaf = shd.local(leaf)
                if isinstance(leaf, torch.Tensor):
                    self.argument_bytes += self._alloc(leaf)

    def _alloc(self, t: torch.Tensor) -> int:
        if t.device.type != self.device_type:
            return 0
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._storages:
                return 0
            nbytes = st.nbytes()
            self._storages[key] = (nbytes, weakref.ref(st, lambda _, k=key: self._free(k)))
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return nbytes

    def _free(self, key: int) -> None:
        with self._lock:
            nbytes, _ = self._storages.pop(key, (0, None))
            self.live -= nbytes

    # -- listener ----------------------------------------------------------------
    def _event(self, event: str, *details) -> None:
        (self._kernel if event == events.KERNEL else self._collective)(*details)

    def _kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _collective(self, kind: str, axis: str, nbytes: int) -> None:
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += nbytes
        per = self.by_axis.setdefault(axis, {})
        per[kind] = per.get(kind, 0) + nbytes

    def __enter__(self):
        self._stack.enter_context(events.counting(self._event))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    # -- ops -------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if mesh_ctx.inside_collective():
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if self.strict:
            for t in outs:
                # a zero-element tensor allocates nothing (checkpoint's
                # dummy on the CPU, in some torch versions)
                if t.device.type != self.device_type and t.numel():
                    raise RuntimeError(
                        f"{func} made a tensor on {t.device} in a count on "
                        f"{self.device_type} tensors")
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        dev = self.device_type
        if (func.is_view or func in _ALLOCATIONS or func.namespace == "c10d"
                or not any(t.device.type == dev for t in ins + outs)):
            for t in outs:
                self._alloc(t)
            return out
        nbytes = sum(_nbytes(t) for t in ins + outs if t.device.type == dev)
        counter = flop_registry.get(func._overloadpacket)
        flops = int(counter(*args, **kwargs, out_val=out)) if counter else 0
        self.aten_bytes += nbytes
        self.aten_flops += flops
        op = self.ops.setdefault(str(func), [0, 0, 0])
        op[0] += 1
        op[1] += nbytes
        op[2] += flops
        for t in outs:
            self._alloc(t)
        return out
