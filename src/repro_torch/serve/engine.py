"""Serving: token-level continuous batching over a fixed slot pool.

Port of ``repro.serve.engine``: the same admission (a freed slot takes
the next queued request) and the same teacher-forced prompt feeding
(prompt tokens go through the decode step one at a time).  The one cache
position is shared by all slots, as in the reference.  ``ServeEngine``
runs at one ``model`` rank, as the reference's engine does;
``make_serve_step`` with a mesh is the step on a rank's shards (the dry
run's decode cells).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import compute_copy, decode_step
from repro_torch.tree import tree_map


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
    encoder-only config (no decode step) raises here."""

    def __init__(self, cfg: ArchConfig, params: Any, slots: int = 8,
                 max_len: int = 256,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.params = compute_copy(cfg, params)
        self.slots = slots
        self.max_len = max_len
        self.cache = self.model.init_cache(slots, max_len)
        self._step = make_serve_step(cfg)
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.tokens = np.zeros((slots, 1), np.int64)

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
        token = torch.from_numpy(self.tokens).to(self.model.device)
        logits, self.cache = self._step(self.params, self.cache, token)
        # argmax on the device; ties go to the first index, as np.argmax
        nxt_all = logits.argmax(dim=-1).cpu().numpy()
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
