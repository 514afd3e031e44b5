#!/usr/bin/env python3
"""The port's data-parallel step across the cards of one host, over NCCL.

    torchrun --nproc-per-node 4 scripts/dp_across_cards.py

Run from the repository root, one process a card.  gemma3-1b at full width
and depth through ``launch.train`` on ``make_local_mesh`` (every rank on
``data``; parameters replicated, the ZeRO-1 shards of m, v and master split
over the ranks):

1. ``agreement``: one step on a global (ranks, 2048) batch, one row a rank,
   against one rank without a mesh on the concatenation of the ranks'
   batches (rank 0, after the others' states are freed): the loss and the
   gradient norm, relative;
2. ``steps``: 2 warm-up and 5 timed steps on (4 · ranks, 2048) batches,
   four rows a rank, the per-card work of one card's (4, 2048) step: step
   ms, tokens/s, each rank's peak memory and ZeRO-1 shard of the
   embedding's m; then one step under the profiler on rank 0: the device
   time of the NCCL kernels and the busy time.

Rank 0 prints one JSON line a phase, with the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

WARMUP, TIMED, SEQ = 2, 5, 2048


def main() -> None:
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticStream, make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step

    mesh = make_local_mesh()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
    card = cs.nvidia_smi() if rank == 0 else ""
    cfg = get("gemma3-1b")

    def emit(phase, **fields):
        if rank == 0:
            print(json.dumps({"phase": phase, "ranks": world, "nvidia_smi": card,
                              **fields}), flush=True)

    # 1. one row a rank against one rank on the concatenation
    out, state = train.run(["--arch", "gemma3-1b", "--steps", "1", "--batch", str(world),
                            "--seq", str(SEQ), "--log-every", "1"])
    del state
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        opt = AdamW(schedule=cosine_schedule(3e-4, 20, 1))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        ref = init_train_state(cfg, opt, gen)
        hosts = [SyntheticStream(cfg, world, SEQ, seed=0, n_hosts=world, host_id=h
                                 ).batch_at(0) for h in range(world)]
        batch = {k: torch.from_numpy(np.concatenate([h[k] for h in hosts])).to(dev)
                 for k in hosts[0]}
        ref, m = make_train_step(cfg, opt)(ref, batch)
        emit("agreement", arch=cfg.name, batch=world, seq=SEQ, loss=out["loss"],
             one_rank_loss=float(m["loss"]),
             loss_rel_err=abs(out["loss"] / float(m["loss"]) - 1),
             grad_norm=out["grad_norm"], one_rank_grad_norm=float(m["grad_norm"]),
             grad_norm_rel_err=abs(out["grad_norm"] / float(m["grad_norm"]) - 1))
        del ref, batch
        torch.cuda.empty_cache()
    dist.barrier()

    # 2. four rows a rank: timed steps, then one profiled
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, opt, gen, mesh)
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    times = []
    with mesh_ctx.set_mesh(mesh):
        stream = iter(make_stream(cfg, 4 * world, SEQ, seed=1))
        for _ in range(WARMUP + TIMED):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9], device=dev)
        peaks = torch.empty(world, device=dev)
        dist.all_gather_into_tensor(peaks, peak)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            wall = time.perf_counter() - t0
    step_s = float(np.median(times[WARMUP:]))
    shard = state["opt"]["m"]["embed"]
    emit("steps", arch=cfg.name, batch=4 * world, seq=SEQ, step_seconds=times,
         step_ms=step_s * 1e3, tokens_per_s=4 * world * SEQ / step_s,
         peak_gb_per_rank=peaks.tolist(), nccl_device_ms=cs.nccl_device_ms(trace),
         zero1_shard_of_embed_m=[list(shard.to_local().shape), list(shard.shape)],
         **cs.summarize(trace, wall, 1))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
