"""Serving: token-level continuous batching over a fixed slot pool.

Port of ``repro.serve.engine``: the same admission (a freed slot takes
the next queued request) and the same teacher-forced prompt feeding
(prompt tokens go through the decode step one at a time).  The one cache
position is shared by all slots, as in the reference.  ``ServeEngine``
runs at one ``model`` rank, as the reference's engine does;
``make_serve_step`` with a mesh is the step on a rank's shards (the dry
run's decode cells).

The reference jits its serve step with the cache donated
(``jax.jit(make_serve_step(cfg), donate_argnums=(1,))``).  On a CUDA
device ``ServeEngine`` does the same with a CUDA graph: it captures
``decode_step`` and the argmax once over static buffers (its cache, a
token buffer, the logits and next tokens) and replays the graph every
tick; the step updates the cache and its position in place, the donated
cache's counterpart.  On the CPU, which the caller asks for, it runs the
step eagerly.  ``make_serve_step`` is the eager step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import compute_copy, decode_step, promote_conv
from repro_torch.tree import tree_leaves, tree_map

#: eager steps run before the capture (kernels built and loaded, library
#: handles and workspaces made on the capture's stream); the cache is
#: zeroed after them
WARMUP_STEPS = 2


def make_serve_step(cfg: ArchConfig, mesh: Any = None) -> Callable:
    """(params, cache, token (B,1)) → (logits (B,V), cache).  With a
    ``DeviceMesh`` the step runs under it on this rank's shards: the
    parameters as the sharding rules store them (DTensors or their local
    tensors), the cache from ``init_cache`` with the mesh, token this
    rank's rows; the logits are this rank's (``sharded_logits``)."""
    if mesh is None:
        def serve_step(params, cache, token):
            return decode_step(cfg, params, cache, token)
        return serve_step

    def serve_step_on_mesh(params, cache, token):
        with mesh_ctx.set_mesh(mesh):
            return decode_step(cfg, tree_map(shd.local, params), cache,
                               shd.local(token))

    return serve_step_on_mesh


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    fed: int = 0                      # prompt tokens fed so far


class ServeEngine:
    """Token-level continuous batching over ``slots`` sequences.

    Serves from a compute-dtype copy of ``params`` (see
    :func:`repro_torch.models.transformer.compute_copy`), which keeps a leaf
    already in the compute dtype (a tree from ``Model.init(serving=True)``)
    without a copy.  It decodes tokens only, as the reference's engine
    does: a VLM's patch embeddings reach only ``forward``, and an
    encoder-only config (no decode step) raises here.

    On a CUDA device the constructor captures the step
    (:meth:`_capture`): a tick then copies its tokens from pinned memory,
    replays the graph and reads the ``(B,)`` next tokens back, one
    synchronisation.  A capture or a replay that fails raises; there is
    no eager retry on the card.  ``logits`` is the last tick's ``(B, V)``
    logits (on the card the graph's output buffer, overwritten by the next
    tick)."""

    def __init__(self, cfg: ArchConfig, params: Any, slots: int = 8,
                 max_len: int = 256,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.params = compute_copy(cfg, params)
        self.slots = slots
        self.max_len = max_len
        self.cache = self.model.init_cache(slots, max_len)
        promote_conv(cfg, self.cache)       # no leaf reallocated by a step
        self._step = make_serve_step(cfg)
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.logits: torch.Tensor | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        #: the kernel launches one replay makes (counted at the capture)
        self.replay_launches: dict[str, int] = {}
        #: bytes the capture added to the device's reserved memory: the
        #: graph's private pool
        self.graph_pool_bytes = 0
        if self.model.device.type == "cuda":
            # the tick's tokens, written by the host straight into pinned
            # memory and copied into the graph's token buffer
            host = torch.zeros((slots, 1), dtype=torch.int64, pin_memory=True)
            self.tokens = host.numpy()
            self._tokens_host = host
            self._capture()
        else:
            self.tokens = np.zeros((slots, 1), np.int64)

    @torch.inference_mode()
    def _capture(self) -> None:
        """Warm-up steps on a side stream, the cache zeroed (every engine
        starts from a zeroed cache, as the reference's), then one graph of
        the step and the argmax captured on that stream, its kernel
        launches recorded and taken off the counters (a capture launches
        nothing)."""
        dev = self.model.device
        token = torch.zeros((self.slots, 1), dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step(self.params, self.cache, token)
            for leaf in tree_leaves(self.cache):
                leaf.zero_()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph, stream=side):
            logits, _ = self._step(self.params, self.cache, token)
            nxt = logits.argmax(dim=-1)
        after = kernels.launch_counts()
        self.replay_launches = {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}
        kernels.add_launches({k: -n for k, n in self.replay_launches.items()})
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self._token, self._logits, self._next = graph, token, logits, nxt

    def _decode(self) -> np.ndarray:
        """One step on the tick's tokens → the next token of every slot."""
        if self.graph is None:
            token = torch.from_numpy(self.tokens).to(self.model.device)
            self.logits, self.cache = self._step(self.params, self.cache, token)
            # argmax on the device; ties go to the first index, as np.argmax
            return self.logits.argmax(dim=-1).cpu().numpy()
        self._token.copy_(self._tokens_host, non_blocking=True)
        with torch.cuda.device(self.model.device):
            self.graph.replay()
        kernels.add_launches(self.replay_launches)
        self.logits = self._logits
        return self._next.cpu().numpy()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                # teacher-forced prefill: feed prompt tokens one at a time
                self.tokens[i, 0] = req.prompt[0] if req.prompt else 0
                req.fed = 1

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One engine tick: admit, decode one token for every live slot."""
        self._admit()
        if not any(self.active):
            return []
        nxt_all = self._decode()
        finished: list[Request] = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if req.fed < len(req.prompt):
                self.tokens[i, 0] = req.prompt[req.fed]
                req.fed += 1
                continue
            nxt = int(nxt_all[i])
            req.generated.append(nxt)
            self.tokens[i, 0] = nxt
            if len(req.generated) >= req.max_new:
                req.done = True
                finished.append(req)
                self.active[i] = None
        return finished

    def run(self) -> list[Request]:
        done: list[Request] = []
        while self.queue or any(self.active):
            done.extend(self.step())
        return done
