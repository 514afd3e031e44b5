#!/usr/bin/env python3
"""The port's data-parallel step across the cards of one host, over NCCL.

    torchrun --nproc-per-node 4 scripts/dp_across_cards.py [--phases P ...]
    torchrun --standalone --nproc-per-node 4 scripts/dp_across_cards.py \\
        --smoke --device cpu

Run from the repository root, one process a card (``--device cpu``: one
gloo rank a process, gemma3-1b's smoke config at 32 positions a row; the
``steps`` phase, a card's timing and profile, is left out).  gemma3-1b at
full width and depth through ``launch.train`` on ``make_local_mesh`` (every
rank on ``data``; parameters replicated, the ZeRO-1 shards of m, v and
master split over the ranks):

1. ``agreement``: one step on a global (ranks, 2048) batch, one row a rank,
   against one rank without a mesh on the concatenation of the ranks'
   batches (rank 0, after the others' states are freed): the loss and the
   gradient norm, relative;
2. ``steps``: 2 warm-up and 5 timed steps on (4 · ranks, 2048) batches,
   four rows a rank, the per-card work of one card's (4, 2048) step: step
   ms, tokens/s, each rank's peak memory and ZeRO-1 shard of the
   embedding's m; then one step under the profiler on rank 0: the device
   time of the NCCL kernels and the busy time;
3. ``n_micro``: microbatches that span the data ranks (each rank's share of
   each microbatch, a block of the global batch, by an all-to-all) on a
   global (2 · ranks, 2048) batch: one step through ``launch.train`` at
   n_micro 1 and one at n_micro 2, each from the same state (seed 0), held
   against each other (the gradient norm: the loss a step reports at
   n_micro 2 is its last microbatch's, as the reference's) and against one
   rank without a mesh on the concatenated batch at n_micro 2 (rank 0,
   after the others' states are freed; the loss and the gradient norm), on
   ``chip_smoke.py``'s two-rank gates (loss 1e-3, gradient norm 1e-2,
   relative); every rank exits non-zero on a disagreement, before any
   timing.  Then, on one state, steps at n_micro 1 and 2 in turns
   (N_MICRO_TURNS pairs after a warm-up of each, the order swapped every
   pair): step ms at each, each rank's peak over its steps against
   ``train_memory_gb(cfg, ranks, n_micro=n)``, and a step's collectives
   (kind, count and bytes that leave the rank) from ``repro_torch.events``.

Rank 0 prints one JSON line a phase, with the card's name and power limit
(``--device cpu``: none; every time is then the host's).
"""
from __future__ import annotations

import argparse
import collections
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

WARMUP, TIMED, SEQ, SMOKE_SEQ = 2, 5, 2048, 32
PHASES = ("agreement", "steps", "n_micro")
#: the n_micro phase: rows a rank of the global batch, the settings held
#: against each other, and the timed pairs
N_MICRO_ROWS, N_MICRO = 2, (1, 2)
N_MICRO_TURNS = 3


def main(argv: list[str] | None = None) -> None:
    import chip_smoke as cs
    from repro_torch.configs import get, get_smoke
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch.mesh import make_local_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    mesh = make_local_mesh(device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
    on_card = dev.type == "cuda"
    card = cs.nvidia_smi() if rank == 0 and on_card else None
    cfg = get_smoke("gemma3-1b") if args.smoke else get("gemma3-1b")
    seq = SMOKE_SEQ if args.smoke else SEQ
    cli = ["--arch", "gemma3-1b", "--seq", str(seq), "--device", dev.type] + (
        ["--smoke"] if args.smoke else [])

    def emit(phase, **fields):
        if rank == 0:
            print(json.dumps({"phase": phase, "ranks": world, "nvidia_smi": card,
                              **fields}), flush=True)

    try:
        if "agreement" in args.phases:
            agreement(cfg, mesh, cli, seq, emit)
        if "steps" in args.phases and on_card:
            steps(cs, cfg, mesh, emit)
        if "n_micro" in args.phases:
            n_micro(cs, cfg, mesh, cli, seq, emit)
    finally:
        dist.destroy_process_group()


def one_rank_step(cfg, dev, rows: int, seq: int, n_micro: int = 1) -> dict:
    """One step without a mesh, as ``launch.train`` starts (seed 0, its
    optimizer), on the concatenation of every rank's first batch of
    ``rows`` rows a rank: its loss and gradient norm."""
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    world = dist.get_world_size()
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, opt, gen)
    hosts = [SyntheticStream(cfg, rows * world, seq, seed=0, n_hosts=world, host_id=h
                             ).batch_at(0) for h in range(world)]
    batch = {k: torch.from_numpy(np.concatenate([h[k] for h in hosts])).to(dev)
             for k in hosts[0]}
    _, m = make_train_step(cfg, opt, TrainStepConfig(n_micro=n_micro))(state, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def agreement(cfg, mesh, cli: list[str], seq: int, emit) -> None:
    """Phase 1: one row a rank against one rank on the concatenation."""
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch import train
    world = dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
    out, state = train.run(cli + ["--steps", "1", "--batch", str(world), "--log-every", "1"])
    del state
    free(dev)
    dist.barrier()
    if dist.get_rank() == 0:
        ref = one_rank_step(cfg, dev, 1, seq)
        emit("agreement", arch=cfg.name, batch=world, seq=seq, loss=out["loss"],
             one_rank_loss=ref["loss"], loss_rel_err=abs(out["loss"] / ref["loss"] - 1),
             grad_norm=out["grad_norm"], one_rank_grad_norm=ref["grad_norm"],
             grad_norm_rel_err=abs(out["grad_norm"] / ref["grad_norm"] - 1))
        free(dev)
    dist.barrier()


def steps(cs, cfg, mesh, emit) -> None:
    """Phase 2: four rows a rank, timed steps, then one profiled."""
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step
    world = dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
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
    del state, step, batch
    free(dev)


def n_micro(cs, cfg, mesh, cli: list[str], seq: int, emit) -> None:
    """Phase 3: n_micro 1 and 2 over the data ranks, gated, then timed in
    turns."""
    from repro_torch import events
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import (
        TrainStepConfig, init_train_state, make_train_step, train_memory_gb,
    )
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
    on_card = dev.type == "cuda"
    rows = N_MICRO_ROWS * world
    # -- the gates: each setting's step through launch.train from seed 0 ------
    runs = {}
    for n in N_MICRO:
        out, state = train.run(cli + ["--steps", "1", "--batch", str(rows),
                                      "--log-every", "1", "--n-micro", str(n)])
        runs[n] = {"loss": out["loss"], "grad_norm": out["grad_norm"]}
        del out, state
        free(dev)
    dist.barrier()
    ok = torch.zeros((), device=dev)
    if rank == 0:
        ref = one_rank_step(cfg, dev, N_MICRO_ROWS, seq, n_micro=N_MICRO[-1])
        free(dev)
        pairs = {"n_micro 1 vs 2": (runs[1], runs[2]),
                 "n_micro 2 vs one rank": (runs[2], ref)}
        rel = {what: {k: abs(got[k] / want[k] - 1) for k in ("loss", "grad_norm")}
               for what, (got, want) in pairs.items()}
        # at n_micro 2 the step reports the last microbatch's loss (the
        # reference's metrics: its aux, the last microbatch's, overrides the
        # mean), so across the two settings only the gradient norm is held
        passed = (rel["n_micro 1 vs 2"]["grad_norm"] <= cs.TWO_RANK_GNORM_REL_TOL
                  and rel["n_micro 2 vs one rank"]["loss"] <= cs.TWO_RANK_LOSS_REL_TOL
                  and rel["n_micro 2 vs one rank"]["grad_norm"] <= cs.TWO_RANK_GNORM_REL_TOL)
        emit("n_micro_agreement", arch=cfg.name, batch=rows, seq=seq,
             runs={str(n): r for n, r in runs.items()}, one_rank_n_micro_2=ref,
             rel_err=rel, loss_rel_tol=cs.TWO_RANK_LOSS_REL_TOL,
             grad_norm_rel_tol=cs.TWO_RANK_GNORM_REL_TOL, passed=passed)
        ok.fill_(float(passed))
    dist.broadcast(ok, 0)
    if not ok.item():
        raise SystemExit(f"rank {rank}: n_micro over {world} data ranks disagrees")

    # -- the timing: one state, the two settings in turns -----------------------
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, opt, gen, mesh)
    step = {n: make_train_step(cfg, opt, TrainStepConfig(n_micro=n)) for n in N_MICRO}
    times = {n: [] for n in N_MICRO}
    peaks = {n: 0.0 for n in N_MICRO}
    collectives = {}
    order = [N_MICRO] + [N_MICRO if i % 2 else N_MICRO[::-1] for i in range(N_MICRO_TURNS)]
    with mesh_ctx.set_mesh(mesh):
        stream = iter(make_stream(cfg, rows, seq, seed=1))
        for turn, pair in enumerate(order):
            for n in pair:
                batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, m = step[n](state, batch)
                float(m["loss"])
                if turn:   # the first pair warms up
                    times[n].append(time.perf_counter() - t0)
                if on_card:
                    peaks[n] = max(peaks[n], torch.cuda.max_memory_allocated() / 1e9)
        for n in N_MICRO:   # one more step of each with a counter listening
            seen = collections.defaultdict(lambda: [0, 0])

            def listen(event, *details, seen=seen):
                if event == events.COLLECTIVE:
                    kind, _, nbytes = details
                    seen[kind][0] += 1
                    seen[kind][1] += nbytes

            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
            with events.counting(listen):
                state, m = step[n](state, batch)
                float(m["loss"])
            collectives[str(n)] = {kind: {"count": c, "bytes": b}
                                   for kind, (c, b) in sorted(seen.items())}
    gathered = torch.empty(world * len(N_MICRO), device=dev)
    dist.all_gather_into_tensor(gathered, torch.tensor([peaks[n] for n in N_MICRO],
                                                       device=dev))
    per_rank = gathered.view(world, len(N_MICRO)).tolist()
    emit("n_micro", arch=cfg.name, batch=rows, seq=seq, turns=N_MICRO_TURNS,
         step_seconds={str(n): t for n, t in times.items()},
         step_ms={str(n): float(np.median(t)) * 1e3 for n, t in times.items()},
         tokens_per_s={str(n): rows * seq / float(np.median(t)) for n, t in times.items()},
         peak_gb_per_rank=({str(n): [r[i] for r in per_rank] for i, n in enumerate(N_MICRO)}
                           if on_card else None),
         reckoned_gb={str(n): train_memory_gb(cfg, world, n_micro=n)["total_gb"]
                      for n in N_MICRO},
         collectives_a_step=collectives)
    del state, step, batch
    free(dev)


if __name__ == "__main__":
    main()
