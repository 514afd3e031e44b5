"""Training entry point of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--smoke] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch olmoe-1b-7b --batch 32 --seq 2048

Full width unless ``--smoke``; on ``cuda`` unless ``--device cpu``.  It
always runs on :func:`repro_torch.launch.mesh.make_local_mesh`, as the
reference does: every rank on ``data`` (under ``torchrun --nproc-per-node
N``, N ranks of one device each; alone, one rank), a process group started
here if none is running (and destroyed at the end; a running one is reused
and left alone).  The train state is placed by the sharding rules
(parameters replicated, AdamW's m, v and master sharded over ``data`` by
ZeRO-1) and trained by the data-parallel step
(:mod:`repro_torch.train.step`); each rank draws its block of the global
``--batch`` (the data stream's hosts are the data ranks).  Checkpoints
every ``--ckpt-every`` steps and at the end (the full arrays, written by
rank 0), and resumes from the latest checkpoint when restarted, at any
data size: kill it mid-run and rerun the same command.  ``--n-micro N``
splits each global batch into N microbatches, each a block of the global
batch as in the reference (each rank takes its share of every microbatch,
:mod:`repro_torch.train.step`); the global batch must divide by N times
the data size.  On a card the step is compiled, as the reference jits it
with the state donated on any mesh: the first step runs eagerly and is
then captured as a CUDA graph over the state
(:class:`repro_torch.train.step.GraphedTrainStep`; over N ranks, the
data-parallel step with its collectives, on every rank), and every later
step is one replay of that graph, each rank's batch copied in from pinned
memory; the metrics are read on the host only at log steps.  That needs
the mesh's collectives on NCCL (``torchrun`` on N cards); over gloo with
more than one rank (ranks sharing a card), and on the CPU, every step
runs eagerly.  Rank 0 says which at the start, and :func:`main` returns
it (``graphed``).  On a card the
attention runs the flash-attention kernels (bidirectional for
hubert-xlarge's encoder), the SSM (mamba2-780m) the SSD-scan kernels,
hymba-1.5b's hybrid layers both, and the MoE FFN (olmoe-1b-7b) the
grouped-GEMM kernels, forward and backward; on the CPU every kernel takes
its plain version.  The batches follow the config's input mode
(hubert-xlarge: frame embeddings; internvl2-26b: patch embeddings, then
tokens).  On a card the memory a device needs is reckoned first, with the
data size and ``--n-micro`` (:func:`repro_torch.train.step.train_memory_gb`),
and held against the card's: a model that does not fit is refused before
anything is allocated, naming the data size that would fit (olmoe-1b-7b
at full depth: 8), or, where none does (internvl2-26b: its replicated
parameters and gradients alone are 159 GB), the (data, model) mesh whose
tensor parallelism would fit it, which this entry point does not run, as
the reference's does not (see :data:`PART_3`; ``python -m
repro_torch.launch.dryrun`` reckons every cell's memory on the production
meshes).  Where such a mesh takes 4 cards, fewer than the data size that
fits (gemma-7b, olmoe-1b-7b, deepseek-7b), the refusal also names
``scripts/tp_across_cards.py``, which trains it on 4 cards.  Runs under
the PaPaS engine like any program, e.g. a study with ``command: python -m
repro_torch.launch.train --lr ${args:lr}``.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get, get_smoke
from repro_torch.data.pipeline import make_stream
from repro_torch.device import resolve_device
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import local_world, make_local_mesh
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.step import (
    GraphedTrainStep, TrainStepConfig, init_train_state, make_train_step,
    train_memory_gb,
)

#: the data sizes the refusal names (powers of two: they divide the batch
#: and the leaves ZeRO-1 shards)
DATA_SIZES = tuple(2 ** i for i in range(11))
#: the model sizes it reckons with where no data size fits
MODEL_SIZES = (2, 4, 8, 16)
#: the cards of one host that ``scripts/tp_across_cards.py`` trains a
#: configuration on, on the (data, model) meshes that fit
TP_SCRIPT_CARDS = 4
#: what this entry point leaves out, named by the refusal: the reference's
#: launcher has no model axis either (its make_local_mesh runs model 1)
PART_3 = ("launch.train on a (data, model) mesh is part 3's last step, beyond "
          "the reference's launcher (it runs model 1): a --model axis here is "
          "not ported (the step, repro_torch.train.step, runs any (data, model) "
          "mesh: see scripts/tp_across_cards.py; python -m "
          "repro_torch.launch.dryrun reckons the production meshes)")


def main(argv: list[str] | None = None) -> dict:
    """Runs the training; returns the last logged step's metrics, and
    ``steps_run``, ``tokens``, ``seconds``, ``step_seconds`` (the host
    time of each step, which ends at its log line's reading of the metrics,
    a wait for the device, so with ``--log-every 1`` each is the step's
    whole time) and ``graphed``, whether the steps after the first replay
    a captured CUDA graph."""
    return run(argv)[0]


def run(argv: list[str] | None = None) -> tuple[dict, dict]:
    """What :func:`main` does; returns what it returns and the train state
    after the last step (DTensors on the mesh)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _refuse_unless_fits(cfg, dev, local_world(), args.n_micro, args.batch, args.seq)
    started = not dist.is_initialized()
    mesh = make_local_mesh(device=dev)
    try:
        return _train(args, cfg, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _rows(batch: int, data: int) -> int:
    """Rows a data rank takes of a global batch of ``batch`` rows (at
    least one)."""
    return max(1, batch // data)


def _refuse_unless_fits(cfg, dev: torch.device, data: int, n_micro: int = 1,
                        batch: int = 8, seq: int = 128) -> None:
    """Exits, naming the memory, if training ``cfg`` over ``data`` ranks
    (``n_micro`` microbatches a step, a global batch of ``batch`` x
    ``seq``) does not fit one card; before anything is allocated."""
    def need_at(d):
        return train_memory_gb(cfg, d, 1, n_micro, rows=_rows(batch, d), seq=seq)

    need = need_at(data)
    have = torch.cuda.get_device_properties(dev).total_memory / 1e9
    if need["total_gb"] <= have:
        return
    fits = next((n for n in DATA_SIZES if n > data and need_at(n)["total_gb"] <= have),
                None)
    if fits:
        remedy = (f"it fits at a data size of {fits} (torchrun --nproc-per-node "
                  f"{fits}, one card a rank)")
        cards, tp = _tensor_parallel_fit(cfg, have, n_micro, batch, seq)
        if cards and cards < fits:
            remedy += f"; {tp}"
    else:
        remedy = (f"no data size fits (the replicated {cfg.param_dtype} parameters "
                  f"and gradients alone are {need['replicated_gb']:.1f} GB); "
                  f"{_tensor_parallel_fit(cfg, have, n_micro, batch, seq)[1]}; {PART_3}")
    accumulator = (f", {need['accumulator_gb']:.1f} GB of the microbatches' "
                   f"gradient sum" if n_micro > 1 else "")
    raise SystemExit(
        f"{cfg.name}: training needs ~{need['total_gb']:.1f} GB a device at a "
        f"data size of {data} ({need['state_gb']:.1f} GB of state for "
        f"{cfg.param_count():,} {cfg.param_dtype} parameters, their gradients and "
        f"AdamW's fp32 master and moments, {need['update_gb']:.1f} GB of "
        f"optimizer temporaries or {need['activation_gb']:.1f} GB of activations "
        f"for {_rows(batch, data)} x {seq} tokens, whichever is larger, "
        f"{need['workspace_gb']:.1f} GB of workspace{accumulator}); the card has "
        f"{have:.1f} GB; {remedy}")


def _tensor_parallel_fit(cfg, have: float, n_micro: int = 1, batch: int = 8,
                         seq: int = 128) -> tuple[int, str]:
    """(cards, text): the fewest cards whose (data, model) mesh fits ``cfg``
    (the smallest model axis first) for a global batch of ``batch`` x
    ``seq`` and, on TP_SCRIPT_CARDS cards, the script that trains it there
    at (data 1, model TP_SCRIPT_CARDS), or (0, that none of MODEL_SIZES
    does)."""
    def gb_at(d, m):
        return train_memory_gb(cfg, d, m, n_micro, rows=_rows(batch, d),
                               seq=seq)["total_gb"]

    meshes = sorted(((d * m, m, d) for m in MODEL_SIZES for d in DATA_SIZES
                     if gb_at(d, m) <= have))
    if not meshes:
        return 0, f"no (data, model) mesh up to model {MODEL_SIZES[-1]} fits"
    cards, m, d = meshes[0]
    text = (f"tensor parallelism fits it on {cards} cards at (data {d}, model "
            f"{m}), ~{gb_at(d, m):.1f} GB a device")
    if cards == TP_SCRIPT_CARDS:
        # the script's first mesh, the least memory of its cards (its steps
        # take one microbatch of its own batch, ROWS x SEQ a data rank)
        gb = train_memory_gb(cfg, 1, cards)["total_gb"]
        text += (f"; scripts/tp_across_cards.py trains it on {cards} cards at (data 1, "
                 f"model {cards}), ~{gb:.1f} GB a device: torchrun --nproc-per-node "
                 f"{cards} scripts/tp_across_cards.py --arch {cfg.name}")
    return cards, text


def _train(args, cfg, mesh) -> tuple[dict, dict]:
    """The training loop on ``mesh``: returns what :func:`run` returns."""
    dev = mesh_ctx.mesh_device(mesh)
    opt = AdamW(schedule=cosine_schedule(args.lr, args.warmup, args.steps))
    step_fn = make_train_step(cfg, opt, TrainStepConfig(n_micro=args.n_micro))
    log = dist.get_rank() == 0

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = init_train_state(cfg, opt, gen, mesh)

    with mesh_ctx.set_mesh(mesh):
        start_step = 0
        if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
            state = ckpt.restore(state, args.ckpt_dir,
                                 shardings=shd.state_shardings(state, mesh))
            start_step = int(state["step"].to_local())
            if log:
                print(f"[restore] resumed from step {start_step}")
        stream = make_stream(cfg, args.batch, args.seq, seed=args.seed,
                             start_step=start_step)
        t0 = last = time.time()
        tokens = 0
        metrics: dict[str, float] = {}
        step_seconds = []
        # the step captured as a CUDA graph at its first call (a real
        # step, the warm-up) and replayed from then on, wherever the mesh's
        # collectives can be captured
        why = "on the cpu" if dev.type != "cuda" else mesh_ctx.uncapturable(mesh)
        graphed = why is None
        if log:
            print(f"[graph] graphed={graphed} " + (
                "(the first step eager, then one CUDA graph a step)" if graphed
                else f"(every step eager: {why})"), flush=True)
        for i, host_batch in enumerate(stream):
            step = start_step + i
            if step >= args.steps:
                break
            if graphed:
                if i == 0:
                    step_fn = GraphedTrainStep(step_fn, state, host_batch)
                state, out = step_fn(state, host_batch)
            else:
                batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
                state, out = step_fn(state, batch)
            tokens += args.batch * args.seq
            if step % args.log_every == 0 or step == args.steps - 1:
                metrics = {k: float(v) for k, v in out.items()}
                dt = time.time() - t0
                if log:
                    print(f"step {step:5d} loss={metrics['loss']:.4f} "
                          f"ce={metrics['ce']:.4f} "
                          f"gnorm={metrics['grad_norm']:.3f} "
                          f"lr={metrics['lr']:.2e} "
                          f"tok/s={tokens / max(dt, 1e-9):,.0f}", flush=True)
            now = time.time()
            step_seconds.append(now - last)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                path = ckpt.save(state, args.ckpt_dir, step + 1)
                if log:
                    print(f"[ckpt] saved {path}", flush=True)
            last = time.time()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    if args.ckpt_dir:
        ckpt.save(state, args.ckpt_dir, int(state["step"].to_local()))
    if log:
        if "loss" in metrics:
            print(f"done: final loss {metrics['loss']:.4f}")
        else:
            print(f"done: no step to run (at step {start_step} of {args.steps})")
    return {**metrics, "steps_run": len(step_seconds), "tokens": tokens,
            "seconds": seconds, "step_seconds": step_seconds, "graphed": graphed}, state

if __name__ == "__main__":
    main()
