"""Serving: token-level continuous batching over a fixed slot pool.

Port of ``repro.serve.engine``: the same admission (a freed slot takes
the next queued request) and the same teacher-forced prompt feeding
(prompt tokens go through the decode step one at a time).  The one cache
position is shared by all slots, as in the reference.  ``ServeEngine``
runs at one ``model`` rank, as the reference's engine does;
``make_serve_step`` with a mesh is the step on a rank's shards (the dry
run's decode cells).

The reference jits its serve step with the cache donated
(``jax.jit(make_serve_step(cfg), donate_argnums=(1,))``; on a mesh, with
the parameters, cache and tokens sharded, ``lower_decode_cell``).
:class:`GraphedServeStep` is the port's form of it on a CUDA device: the
step (on a mesh, this rank's step with its collectives) captured once as a
CUDA graph over static buffers (the cache, a token buffer, the logits and
the next tokens) and replayed every token; the step updates the cache and
its position in place, the donated cache's counterpart.  ``ServeEngine``
replays one on its card.  On the CPU, which the caller asks for, both run
the step eagerly.  ``make_serve_step`` is the eager step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.capture import CapturedStep
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


class GraphedServeStep(CapturedStep):
    """``make_serve_step(cfg, mesh)`` on this rank's parameters, ``cache``
    and a static ``(slots, 1)`` token buffer (:attr:`token`), as a
    :class:`repro_torch.capture.CapturedStep`: the reference's jitted serve
    step with the cache donated.  ``slots`` are the rows this rank decodes;
    ``params`` are its stored tensors (DTensors or their local tensors:
    their local tensors are taken once, so every step reads the same
    ones), ``cache`` its cache (``init_cache``, with the mesh on a mesh),
    updated in place.

    On a CUDA device the constructor warms up (the step run WARMUP_STEPS
    times on a side stream: the kernels built and loaded, library handles
    and workspaces made, and on a mesh every collective of the step run
    once, so that NCCL has made its communicators), zeroes the cache and
    its position, and captures the step; every call replays it.  On a mesh
    each rank captures its own step, its collectives too: the mesh must
    run them over NCCL (one of more than one rank over gloo is refused,
    naming the backend, before anything runs), and where any rank's
    capture fails every rank raises.  A capture or replay that fails
    raises; no step runs eagerly in its place.  On the CPU every call runs
    the step eagerly on the same buffers.

    Called as ``step(token) -> logits``: ``token`` (slots, 1) is copied
    into the token buffer (from pinned host memory without a
    synchronisation), then the step runs.  ``logits`` are this rank's
    vocabulary columns (``sharded_logits``: the reference's ``P(dp,
    "model")`` out-sharding); :attr:`next` their argmax where this rank
    holds the whole vocabulary, else None.  On the card both are the
    graph's buffers, overwritten by the next step."""

    what = "serve step"

    def __init__(self, cfg: ArchConfig, params: Any, cache: dict[str, Any],
                 slots: int, mesh: Any = None) -> None:
        device = cache["pos"].device
        super().__init__(device, mesh)
        self.cfg = cfg
        self.params = tree_map(shd.local, params)
        self.cache = cache
        promote_conv(cfg, cache)            # no leaf reallocated by a step
        self.token = torch.zeros((slots, 1), dtype=torch.int64, device=device)
        self._serve = make_serve_step(cfg, mesh)
        self.logits: torch.Tensor | None = None
        self.next: torch.Tensor | None = None
        if device.type == "cuda":
            self._warm_up(WARMUP_STEPS)
            for leaf in tree_leaves(cache):
                leaf.zero_()
            self._capture()

    def __call__(self, token: torch.Tensor) -> torch.Tensor:
        self.token.copy_(token, non_blocking=token.device.type == "cpu"
                         and token.is_pinned())
        self.logits, self.next = self._run_step()
        return self.logits

    def _eager_step(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        with torch.inference_mode():
            logits, _ = self._serve(self.params, self.cache, self.token)
            # argmax on the device; ties go to the first index, as np.argmax
            whole = logits.shape[-1] == self.cfg.vocab_size
            return logits, logits.argmax(dim=-1) if whole else None


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

    The step is a :class:`GraphedServeStep` (:attr:`graphed`) on the
    engine's cache: on a CUDA device the constructor captures it, and a
    tick then copies its tokens from pinned memory, replays the graph and
    reads the ``(B,)`` next tokens back, one synchronisation; a capture or
    a replay that fails raises, and there is no eager retry on the card.
    On the CPU it runs the step eagerly.  ``logits`` is the last tick's
    ``(B, V)`` logits (on the card the graph's output buffer, overwritten
    by the next tick)."""

    def __init__(self, cfg: ArchConfig, params: Any, slots: int = 8,
                 max_len: int = 256,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.params = compute_copy(cfg, params)
        self.slots = slots
        self.max_len = max_len
        self.cache = self.model.init_cache(slots, max_len)
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.logits: torch.Tensor | None = None
        # the tick's tokens, written by the host into memory that the step
        # copies into its token buffer (pinned on a card)
        self._tokens_host = torch.zeros((slots, 1), dtype=torch.int64,
                                        pin_memory=self.model.device.type == "cuda")
        self.tokens = self._tokens_host.numpy()
        self.graphed = GraphedServeStep(cfg, self.params, self.cache, slots)

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        return self.graphed.graph

    @property
    def replay_launches(self) -> dict[str, int]:
        """The kernel launches one replay makes (counted at the capture)."""
        return self.graphed.replay_launches

    @property
    def graph_pool_bytes(self) -> int:
        """Bytes the capture added to the device's reserved memory: the
        graph's private pool."""
        return self.graphed.graph_pool_bytes

    def _decode(self) -> np.ndarray:
        """One step on the tick's tokens → the next token of every slot."""
        self.logits = self.graphed(self._tokens_host)
        return self.graphed.next.cpu().numpy()

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
