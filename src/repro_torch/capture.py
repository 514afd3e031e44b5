"""A step captured once as a CUDA graph and replayed: the port's form of the
reference's compiled steps (``jax.jit`` with the state or cache donated).

:class:`CapturedStep` is the one capture path of the port: the train step
(:class:`repro_torch.train.step.GraphedTrainStep`), the gang's step
(:class:`repro_torch.train.ensemble.Gang`) and the serve step
(:class:`repro_torch.serve.engine.GraphedServeStep`) all derive from it.
On a device mesh every rank captures and replays the same step, its
collectives too, so a mesh must run them over NCCL; after a capture the
ranks agree that every rank captured.
"""
from __future__ import annotations

import threading
import time
from typing import Any

import torch

from repro_torch import events, kernels
from repro_torch.distributed import context as mesh_ctx

#: one capture at a time in a process (a sweep's thread pool may train
#: several runs at once; each capture is also thread-local in its errors)
_CAPTURE_LOCK = threading.Lock()


class CapturedStep:
    """A step on fixed buffers (:meth:`_eager_step`, no arguments) run as the
    reference runs its compiled step.  On the CPU every :meth:`_run_step`
    runs it eagerly.  On a CUDA device the first runs :meth:`_warm_up` on a
    side stream: the step run eagerly (the kernels built and their
    per-device set-up done, library handles and workspaces made on that
    stream; on a mesh, every collective run once, so that NCCL has made each
    group's communicator, which a capture cannot); the second releases the
    cached blocks the warm-up left, captures the step once as a CUDA graph
    on that stream (a capture runs nothing) and replays it; every later one
    replays it: one graph launch a step.  A subclass may warm up and capture
    before its first step (:meth:`_warm_up`, then :meth:`_capture`).  The
    kernels' launches at the capture are taken off their counters and added
    back at each replay (:attr:`replay_launches`); what the capture reports
    to :mod:`repro_torch.events` (each collective, each kernel call's cost)
    reaches no listener then and is reported again at each replay
    (:attr:`replay_events`).  A replay returns the captured call's outputs,
    the graph's buffers, overwritten by the next replay.  A capture or
    replay that fails raises, and so does every later step: the step is
    never run eagerly in its place; out of memory, the capture names the
    memory.

    With a ``mesh`` on a CUDA device every rank captures and replays the
    same step, so the replays' collectives meet: a mesh with an axis of
    more than one rank whose collectives do not run over NCCL (gloo) is
    refused here, naming the backend, before anything runs.  After the
    capture the ranks agree (one all-reduce over each such axis) that every
    rank captured: where one failed (out of memory, say) every rank raises,
    so that no rank replays collectives that another never meets."""

    #: what the step is, for the refusal's message
    what = "step"

    def __init__(self, device: torch.device, mesh: Any = None) -> None:
        self.device = device
        #: the mesh whose ranks must agree on a capture (None off a card)
        self._mesh = mesh if device.type == "cuda" else None
        if self._mesh is not None:
            why = mesh_ctx.uncapturable(self._mesh)
            if why:
                raise ValueError(f"a graphed {self.what} cannot be captured: {why}")
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Any = None
        #: the kernel launches one replay makes (counted at the capture)
        self.replay_launches: dict[str, int] = {}
        #: the events one replay reports (recorded at the capture)
        self.replay_events: list[tuple] = []
        #: bytes the capture added to the device's reserved memory: the
        #: graph's private pool
        self.graph_pool_bytes = 0
        self.capture_seconds = 0.0
        #: the warm-up's and the capture's stream, made by the warm-up
        self._side: torch.cuda.Stream | None = None

    def _eager_step(self) -> Any:
        raise NotImplementedError

    def _run_step(self) -> Any:
        if self.device.type != "cuda":
            return self._eager_step()
        if self._side is None:
            return self._warm_up(1)
        if self.graph is None:
            self._capture()
        with torch.cuda.device(self.device):
            self.graph.replay()
        kernels.add_launches(self.replay_launches)
        events.replay(self.replay_events)
        return self.outputs

    def _warm_up(self, steps: int) -> Any:
        """The step run eagerly ``steps`` times on a new side stream, which
        the current stream then waits for; the last run's outputs."""
        current = torch.cuda.current_stream(self.device)
        self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            for _ in range(steps):
                out = self._eager_step()
        current.wait_stream(self._side)
        return out

    def _capture(self) -> None:
        """The step captured on the side stream, then (on a mesh) the ranks'
        agreement; raises where this rank's capture or another's failed."""
        failed = None
        try:
            self._record()
        except Exception as e:      # told to the other ranks, then raised
            failed = e
        if self._mesh is not None:
            ok = torch.tensor(float(failed is None), device=self.device)
            for i, name in enumerate(self._mesh.mesh_dim_names):
                if self._mesh.size(i) > 1:   # not a step's collective: unreported
                    torch.distributed.all_reduce(ok, torch.distributed.ReduceOp.MIN,
                                                 group=self._mesh.get_group(name))
            if failed is None and not ok.item():
                self.graph = self.outputs = None
                raise RuntimeError(f"another rank's capture of the mesh {self.what} "
                                   "failed (its error says why); this rank's graph "
                                   "is dropped")
        if failed is not None:
            try:
                raise failed
            finally:
                failed = None       # no cycle through this frame keeps the state

    def _record(self) -> None:
        dev = self.device
        self._side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = kernels.launch_counts()
            try:
                # thread-local: NCCL's watchdog thread queries events
                # meanwhile, which a global capture would refuse
                with events.recording() as recorded, torch.cuda.device(dev), \
                        torch.cuda.graph(graph, stream=self._side,
                                         capture_error_mode="thread_local"):
                    outputs = self._eager_step()
            except torch.OutOfMemoryError as e:
                total = torch.cuda.get_device_properties(dev).total_memory
                raise torch.OutOfMemoryError(
                    f"the captured {self.what} does not fit: {reserved / 1e9:.2f} GB "
                    f"reserved before the capture (the state and its buffers), "
                    f"{torch.cuda.memory_reserved(dev) / 1e9:.2f} GB when it ran "
                    f"out, of the card's {total / 1e9:.2f} GB") from e
            after = kernels.launch_counts()
        self.replay_launches = {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}
        kernels.add_launches({k: -n for k, n in self.replay_launches.items()})
        self.replay_events = recorded
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_seconds = time.perf_counter() - t0
        self.graph, self.outputs = graph, outputs
