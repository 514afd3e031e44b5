#!/usr/bin/env python3
"""The port's data-parallel step across the cards of one host, over NCCL.

    torchrun --nproc-per-node 4 scripts/dp_across_cards.py [--phases P ...]
    torchrun --standalone --nproc-per-node 4 scripts/dp_across_cards.py \\
        --smoke --device cpu

Run from the repository root, one process a card (``--device cpu``: one
gloo rank a process, gemma3-1b's smoke config at 32 positions a row; the
steps' times, peaks and profiles are then left out).  gemma3-1b at full
width and depth through ``launch.train`` on ``make_local_mesh`` (every
rank on ``data``; parameters replicated, the ZeRO-1 shards of m, v and
master split over the ranks).  On the cards the mesh's collectives run
over NCCL, so ``launch.train`` compiles the step: the first step eager,
then one captured CUDA graph a step (``GraphedTrainStep``):

1. ``agreement``: one step on a global (ranks, 2048) batch, one row a rank,
   against one rank without a mesh on the concatenation of the ranks'
   batches (rank 0, after the others' states are freed): the loss and the
   gradient norm, relative;
2. ``steps``: four rows a rank, the per-card work of one card's (4, 2048)
   step, graphed and eager in turns (``chip_smoke.mesh_graph_case``):
   three runs from seed 0 on the same batches, eager, graphed (a
   ``GraphedTrainStep`` built as ``launch.train`` builds it) and eager,
   each of MESH_GRAPH_STEPS steps and MESH_GRAPH_TIMED more timed by CUDA
   events, and one profiled: step ms and tokens/s of both, whether the
   graphed run is bit-equal to the eager one, rank 0's graphed and eager
   step profiled (idle share, NCCL device ms, launches, graph launches,
   host syncs), the kernels' launches a step (counted from the replays
   where graphed), the collectives a step (heard from the replays), the
   capture's seconds and pool, and each rank's peak against
   ``train_memory_gb``.  Every rank exits non-zero where a graphed step's
   loss or gradient norm lies off its eager step's past ``chip_smoke.py``'s
   two-rank gates, its launches or collectives differ from the eager
   step's, or a graphed step is more than one launch;
3. ``n_micro``: microbatches that span the data ranks (each rank's share of
   each microbatch, a block of the global batch, by an all-to-all) on a
   global (2 · ranks, 2048) batch: ``launch.train`` at ``--steps`` 3 (the
   warm-up, the capture and a replay) at n_micro 1 and 2, each from the
   same state (seed 0), graphed and again eager (its step class run
   eagerly on the same buffers); each graphed step held against its eager
   step (loss and gradient norm, and the collectives heard), the first
   steps against each other (the gradient norm: the loss a step reports at
   n_micro 2 is its last microbatch's, as the reference's) and against one
   rank without a mesh on the concatenated batch at n_micro 2 (rank 0,
   after the others' states are freed; the loss and the gradient norm), on
   ``chip_smoke.py``'s two-rank gates (loss 1e-3, gradient norm 1e-2,
   relative); every rank exits non-zero on a disagreement, before any
   timing.  Then, on one state, a graphed step at each n_micro in turns
   (N_MICRO_TURNS pairs after two pairs of warm-up and capture, the order
   swapped every pair): step ms at each, each rank's peak over its steps
   against ``train_memory_gb(cfg, ranks, n_micro=n)`` at that batch, and a step's
   collectives (kind, count and bytes that leave the rank) heard from a
   replay.

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

SEQ, SMOKE_SEQ = 2048, 32
PHASES = ("agreement", "steps", "n_micro")
#: the steps phase: rows a rank
STEP_ROWS = 4
#: the n_micro phase: rows a rank of the global batch, the settings held
#: against each other, launch.train's steps (the warm-up, the capture, a
#: replay), the warm-up pairs of the timing (each setting's warm-up, then
#: its capture) and its timed pairs
N_MICRO_ROWS, N_MICRO = 2, (1, 2)
N_MICRO_STEPS, N_MICRO_WARMUP, N_MICRO_TURNS = 3, 2, 3


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
        if "steps" in args.phases:
            steps(cs, cfg, mesh, seq, emit)
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


def all_ranks(dev, failed: bool) -> bool:
    """Whether any rank failed (every rank learns it)."""
    flag = torch.tensor(float(failed), device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


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
             grad_norm_rel_err=abs(out["grad_norm"] / ref["grad_norm"] - 1),
             graphed=out["graphed"])
        free(dev)
    dist.barrier()


def steps(cs, cfg, mesh, seq: int, emit) -> None:
    """Phase 2: four rows a rank, graphed and eager in turns."""
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.train.step import train_memory_gb
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
    out = cs.mesh_graph_case(cfg, mesh, dev, STEP_ROWS, seq)
    ranks = [None] * world
    dist.all_gather_object(ranks, {k: out.get(k) for k in (
        "graphed_peak_allocated_gb", "eager_peak_allocated_gb", "graph_pool_gb",
        "capture_s", "bit_equal", "graphed_does_not_fit", "failures")})
    emit("steps", arch=cfg.name, batch=STEP_ROWS * world, seq=seq,
         reckoned_gb=train_memory_gb(cfg, world, rows=STEP_ROWS, seq=seq)["total_gb"],
         per_rank=ranks,
         **{k: v for k, v in out.items() if k != "failures"}, failures=out["failures"])
    if all_ranks(dev, bool(out["failures"])):
        raise SystemExit(f"rank {rank}: the graphed step disagrees with the eager step "
                         f"(the steps line above): {out['failures']}")
    free(dev)


class Recorder:
    """Each step's metrics (floats, read at once) and the collectives heard
    while it ran, of the step objects ``launch.train`` makes while
    :meth:`patched` is on: with ``graphed``, its ``GraphedTrainStep``'s
    calls (each replay's collectives reported by the replay); without, that
    class's step run eagerly on its buffers; on the CPU, where
    ``launch.train`` steps eagerly, its step function's calls."""

    def __init__(self, cs, graphed: bool) -> None:
        self.cs, self.graphed = cs, graphed
        self.metrics: list[dict] = []
        self.collectives: list[dict] = []

    def record(self, fn):
        from repro_torch import events
        listen, seen = self.cs.heard_collectives()
        with events.counting(listen):
            state, out = fn()
        self.metrics.append({k: float(v) for k, v in out.items()})
        self.collectives.append(seen)
        return state, out

    def patched(self, train):
        import contextlib
        recorder, make, base = self, train.make_train_step, train.GraphedTrainStep

        def make_recorded(*args, **kwargs):
            fn = make(*args, **kwargs)

            def step(state, batch):
                return recorder.record(lambda: fn(state, batch))
            step.unrecorded = fn
            return step

        class Step(base):
            def __init__(self, step_fn, state, batch):
                super().__init__(step_fn.unrecorded, state, batch)

            def __call__(self, state, batch):
                if recorder.graphed:
                    return recorder.record(lambda: base.__call__(self, state, batch))
                self._load(batch)
                return recorder.record(self._eager_step)

        @contextlib.contextmanager
        def on():
            train.make_train_step, train.GraphedTrainStep = make_recorded, Step
            try:
                yield self
            finally:
                train.make_train_step, train.GraphedTrainStep = make, base
        return on()


def n_micro(cs, cfg, mesh, cli: list[str], seq: int, emit) -> None:
    """Phase 3: n_micro 1 and 2 over the data ranks through launch.train,
    graphed and eager, gated, then graphed in turns on one state."""
    from repro_torch import events
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import (
        GraphedTrainStep, TrainStepConfig, init_train_state, make_train_step,
        train_memory_gb,
    )
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = mesh_ctx.mesh_device(mesh)
    on_card = dev.type == "cuda"
    rows = N_MICRO_ROWS * world
    # -- the gates: each setting through launch.train from seed 0 ----------------
    runs = {}
    for n in N_MICRO:
        for graphed in (True, False):
            recorder = Recorder(cs, graphed)
            with recorder.patched(train):
                out, state = train.run(cli + [
                    "--steps", str(N_MICRO_STEPS), "--batch", str(rows),
                    "--log-every", "1", "--n-micro", str(n)])
            runs[n, graphed] = {"graphed": out["graphed"], "metrics": recorder.metrics,
                                "collectives": recorder.collectives,
                                "step_seconds": out["step_seconds"]}
            del out, state
            free(dev)
    dist.barrier()
    ok = torch.zeros((), device=dev)
    if rank == 0:
        ref = one_rank_step(cfg, dev, N_MICRO_ROWS, seq, n_micro=N_MICRO[-1])
        free(dev)
        first = {n: runs[n, True]["metrics"][0] for n in N_MICRO}
        pairs = {"n_micro 1 vs 2": (first[1], first[2]),
                 "n_micro 2 vs one rank": (first[2], ref)}
        rel = {what: {k: abs(got[k] / want[k] - 1) for k in ("loss", "grad_norm")}
               for what, (got, want) in pairs.items()}
        graph_rel = {str(n): [{k: abs(g[k] / w[k] - 1) for k in ("loss", "grad_norm")}
                              for g, w in zip(runs[n, True]["metrics"],
                                              runs[n, False]["metrics"])]
                     for n in N_MICRO}
        # at n_micro 2 the step reports the last microbatch's loss (the
        # reference's metrics: its aux, the last microbatch's, overrides the
        # mean), so across the two settings only the gradient norm is held
        passed = (rel["n_micro 1 vs 2"]["grad_norm"] <= cs.TWO_RANK_GNORM_REL_TOL
                  and rel["n_micro 2 vs one rank"]["loss"] <= cs.TWO_RANK_LOSS_REL_TOL
                  and rel["n_micro 2 vs one rank"]["grad_norm"] <= cs.TWO_RANK_GNORM_REL_TOL)
        graph_passed = all(
            len(runs[n, True]["metrics"]) == N_MICRO_STEPS
            and runs[n, True]["graphed"] == on_card
            and runs[n, True]["collectives"] == runs[n, False]["collectives"]
            and all(r["loss"] <= cs.TWO_RANK_LOSS_REL_TOL
                    and r["grad_norm"] <= cs.TWO_RANK_GNORM_REL_TOL
                    for r in graph_rel[str(n)])
            for n in N_MICRO)
        emit("n_micro_agreement", arch=cfg.name, batch=rows, seq=seq, steps=N_MICRO_STEPS,
             runs={str(n): {"graphed" if g else "eager": r for (m, g), r in runs.items()
                            if m == n} for n in N_MICRO},
             one_rank_n_micro_2=ref, rel_err=rel, graphed_rel_err=graph_rel,
             bit_equal={str(n): runs[n, True]["metrics"] == runs[n, False]["metrics"]
                        for n in N_MICRO},
             loss_rel_tol=cs.TWO_RANK_LOSS_REL_TOL,
             grad_norm_rel_tol=cs.TWO_RANK_GNORM_REL_TOL,
             passed=passed, graph_passed=graph_passed)
        ok.fill_(float(passed and graph_passed))
    dist.broadcast(ok, 0)
    if not ok.item():
        raise SystemExit(f"rank {rank}: n_micro over {world} data ranks disagrees")

    # -- the timing: one state, the two settings graphed in turns -----------------
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, opt, gen, mesh)
    with mesh_ctx.set_mesh(mesh):
        stream = iter(make_stream(cfg, rows, seq, seed=1))
    first_batch = next(stream)
    step = {n: GraphedTrainStep(make_train_step(cfg, opt, TrainStepConfig(n_micro=n)),
                                state, first_batch) for n in N_MICRO}
    times = {n: [] for n in N_MICRO}
    peaks = {n: 0.0 for n in N_MICRO}
    collectives = {}
    order = ([N_MICRO if i % 2 == 0 else N_MICRO[::-1] for i in range(N_MICRO_WARMUP)]
             + [N_MICRO if i % 2 else N_MICRO[::-1] for i in range(N_MICRO_TURNS)])
    for turn, pair in enumerate(order):
        for n in pair:
            batch = next(stream)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step[n](state, batch)
            float(m["loss"])
            if turn >= N_MICRO_WARMUP:
                times[n].append(time.perf_counter() - t0)
            if on_card:
                peaks[n] = max(peaks[n], torch.cuda.max_memory_allocated() / 1e9)
    for n in N_MICRO:   # one more step of each (a replay) with a counter listening
        seen = collections.defaultdict(lambda: [0, 0])

        def listen(event, *details, seen=seen):
            if event == events.COLLECTIVE:
                kind, _, nbytes = details
                seen[kind][0] += 1
                seen[kind][1] += nbytes

        with events.counting(listen):
            state, m = step[n](state, next(stream))
            float(m["loss"])
        collectives[str(n)] = {kind: {"count": c, "bytes": b}
                               for kind, (c, b) in sorted(seen.items())}
    gathered = torch.empty(world * len(N_MICRO), device=dev)
    dist.all_gather_into_tensor(gathered, torch.tensor([peaks[n] for n in N_MICRO],
                                                       device=dev))
    per_rank = gathered.view(world, len(N_MICRO)).tolist()
    emit("n_micro", arch=cfg.name, batch=rows, seq=seq, turns=N_MICRO_TURNS,
         graphed={str(n): step[n].graph is not None for n in N_MICRO},
         capture_s={str(n): step[n].capture_seconds for n in N_MICRO},
         graph_pool_gb={str(n): step[n].graph_pool_bytes / 1e9 for n in N_MICRO},
         step_seconds={str(n): t for n, t in times.items()},
         step_ms={str(n): float(np.median(t)) * 1e3 for n, t in times.items()},
         tokens_per_s={str(n): rows * seq / float(np.median(t)) for n, t in times.items()},
         peak_gb_per_rank=({str(n): [r[i] for r in per_rank] for i, n in enumerate(N_MICRO)}
                           if on_card else None),
         reckoned_gb={str(n): train_memory_gb(cfg, world, n_micro=n, rows=N_MICRO_ROWS,
                                              seq=seq)["total_gb"] for n in N_MICRO},
         collectives_a_step=collectives)
    del state, step
    free(dev)


if __name__ == "__main__":
    main()
