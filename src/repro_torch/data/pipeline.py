"""Deterministic synthetic data stream with host sharding (port of
``repro.data.pipeline``).

Each host draws exactly its shard of the global batch, and the stream is
reproducible from (seed, step) alone, which is what makes a resumed run
deterministic.  The draws are the reference's, so both packages give the
same numpy batches.  The hosts are the data-parallel ranks of the ambient
mesh, else the ranks of ``torch.distributed`` when it is initialised (the
reference reads ``jax.process_count`` and ``jax.process_index``: one
process a host, where the port runs one a device), else one host.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.distributed import context as mesh_ctx
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class SyntheticStream:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    start_step: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % self.n_hosts:
            raise ValueError("global batch must divide across hosts")
        self.local_batch = self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The host-local batch for a given global step (stateless)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, cfg = self.local_batch, self.seq_len, self.cfg
        if cfg.input_mode == "tokens":
            toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
            return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if cfg.input_mode == "embeds":
            emb = rng.standard_normal((b, s, cfg.d_model),
                                      dtype=np.float32) * 0.1
            labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
            return {"embeds": emb, "labels": labels}
        npatch = min(cfg.n_patches, s // 2)
        st = s - npatch
        toks = rng.integers(0, cfg.vocab_size, (b, st), dtype=np.int32)
        patches = rng.standard_normal((b, npatch, cfg.d_model),
                                      dtype=np.float32) * 0.1
        labels = np.concatenate(
            [np.full((b, npatch), -100, np.int32),
             rng.integers(0, cfg.vocab_size, (b, st), dtype=np.int32)],
            axis=1)
        return {"tokens": toks, "patch_embeds": patches, "labels": labels}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = self.start_step
        while True:
            yield self.batch_at(step)
            step += 1


def _hosts() -> tuple[int, int]:
    """(number of hosts, this host's index): the data-parallel ranks of the
    ambient mesh (ranks that differ only along ``model`` draw the same
    batch), else the initialised process group's ranks, else (1, 0)."""
    if mesh_ctx.get_mesh() is not None:
        return mesh_ctx.dp_size(), mesh_ctx.dp_index()
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_stream(cfg: ArchConfig, global_batch: int, seq_len: int,
                seed: int = 0, start_step: int = 0) -> SyntheticStream:
    n_hosts, host_id = _hosts()
    return SyntheticStream(
        cfg=cfg, global_batch=global_batch, seq_len=seq_len, seed=seed,
        start_step=start_step, n_hosts=n_hosts, host_id=host_id)
