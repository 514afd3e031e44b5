#!/usr/bin/env python3
"""The port's tensor-parallel step across the cards of one host, over NCCL.

    torchrun --nproc-per-node 4 scripts/tp_across_cards.py

Run from the repository root, one process a card.  deepseek-7b at full
width (32 heads of 128, MLP 11008, vocabulary 102400: every leaf the
sharding rules split over ``model`` splits evenly, so each rank's stored
shards are its compute views and no weight is gathered), the train state
placed by the rules on a (data, model) mesh (``make_local_mesh(model=M)``):

1. ``agreement``: its first AGREEMENT_LAYERS layers at (data 1, model 4),
   one step on a (4, 2048) batch against one rank without a mesh on the
   same state and batch (rank 0, after the others' states are freed): the
   loss and the gradient norm, relative, and a few leaves and their first
   moments gathered whole (largest |Δ| over the learning rate, and over
   the leaf's largest |m|), each held to ``chip_smoke.py``'s tensor-parallel
   gates; every rank exits non-zero on a disagreement, before any timing;
2. ``steps``: full depth at (data 1, model 4) and at (data 2, model 2),
   4 x 2048 tokens a data rank, WARMUP and TIMED steps: step ms, tokens/s,
   each rank's peak memory against ``train_memory_gb(cfg, data, model)``;
   then one step under the profiler on rank 0: the device time of the NCCL
   kernels and the busy time.

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

ARCH = "deepseek-7b"
WARMUP, TIMED, ROWS, SEQ = 2, 3, 4, 2048
AGREEMENT_LAYERS = 4
#: leaves the agreement phase gathers whole and holds against one rank's
LEAVES = ("embed", "lm_head", "segments/[0]/attn/wq", "segments/[0]/attn/wo",
          "segments/[0]/mlp/wi_gate", "segments/[0]/mlp/wo", "final_norm")


def _batch(cfg, rows, seed, dev):
    from repro_torch.data.pipeline import SyntheticStream
    host = SyntheticStream(cfg, rows, SEQ, seed=seed).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def main() -> None:
    import chip_smoke as cs
    from repro_torch.bridge import flatten
    from repro_torch.configs import get
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch.mesh import local_world, make_local_mesh
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step, train_memory_gb

    world = local_world()
    card = cs.nvidia_smi()
    cfg = get(ARCH)

    def emit(phase, **fields):
        if dist.get_rank() == 0:
            print(json.dumps({"phase": phase, "ranks": world, "nvidia_smi": card,
                              **fields}), flush=True)

    # 1. a cut of depth at model 4 against one rank on the same state and batch
    mesh = make_local_mesh(model=world)
    rank = dist.get_rank()
    dev = mesh_ctx.mesh_device(mesh)
    cut = cs.cut_depth(cfg, AGREEMENT_LAYERS)
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cut, opt, gen, mesh)
    batch = _batch(cut, ROWS, 0, dev)
    state, m = make_train_step(cut, opt)(state, batch)
    got = {k: float(v) for k, v in m.items()}
    params, moments = flatten(state["params"]), flatten(state["opt"]["m"])
    whole = {k: params[k].full_tensor().cpu() for k in LEAVES}
    whole_m = {k: moments[k].full_tensor().cpu() for k in LEAVES}
    del state, params, moments
    torch.cuda.empty_cache()
    dist.barrier()
    agree = torch.zeros((), device=dev)
    if rank == 0:
        gen.manual_seed(0)
        ref = init_train_state(cut, opt, gen)
        ref, rm = make_train_step(cut, opt)(ref, batch)
        lr = float(rm["lr"])
        want, want_m = flatten(ref["params"]), flatten(ref["opt"]["m"])
        diffs = {k: (whole[k].to(dev) - want[k]).abs().max().item() / lr for k in LEAVES}
        m_errs = {k: ((whole_m[k].to(dev) - want_m[k]).abs().max()
                      / want_m[k].abs().max()).item() for k in LEAVES}
        line = {"loss_rel_err": abs(got["loss"] / float(rm["loss"]) - 1),
                "grad_norm_rel_err": abs(got["grad_norm"] / float(rm["grad_norm"]) - 1)}
        agree.fill_(line["loss_rel_err"] <= cs.TP_LOSS_REL_TOL
                    and line["grad_norm_rel_err"] <= cs.TP_GNORM_REL_TOL
                    and max(diffs.values()) <= cs.TP_PARAM_LR_BOUND
                    and max(m_errs.values()) <= cs.TP_MOMENT_REL_TOL)
        emit("agreement", arch=cut.name, layers=AGREEMENT_LAYERS,
             mesh={"data": 1, "model": world}, batch=ROWS, seq=SEQ,
             loss=got["loss"], one_rank_loss=float(rm["loss"]),
             grad_norm=got["grad_norm"], one_rank_grad_norm=float(rm["grad_norm"]),
             lr=lr, leaf_max_abs_diff_over_lr=diffs, m_max_rel_err=m_errs,
             loss_rel_tol=cs.TP_LOSS_REL_TOL, grad_norm_rel_tol=cs.TP_GNORM_REL_TOL,
             param_lr_bound=cs.TP_PARAM_LR_BOUND, m_rel_tol=cs.TP_MOMENT_REL_TOL,
             agrees=bool(agree), **line)
        del ref, want, want_m
        torch.cuda.empty_cache()
    del whole, whole_m
    dist.broadcast(agree, src=0)
    if not agree:
        dist.destroy_process_group()
        raise SystemExit(f"{ARCH} at model {world} disagrees with one rank "
                         "(the agreement line above)")

    # 2. full depth: (1, world) and (world / 2, 2), ROWS x SEQ a data rank,
    # each mesh's groups made in the one process group (NCCL's bootstrap
    # does not survive a destroyed and restarted default group here)
    for model in (world, 2):
        mesh = make_local_mesh(model=model)
        data = world // model
        opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_train_state(cfg, opt, gen, mesh)   # draws each leaf whole
        step = make_train_step(cfg, opt)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with mesh_ctx.set_mesh(mesh):
            index = mesh_ctx.dp_index()
            for i in range(WARMUP + TIMED):
                batch = _batch(cfg, ROWS, 100 * i + index, dev)
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
        nccl_ms = sum((e.time_range.end - e.time_range.start) / 1e3 for e in trace.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "nccl" in e.name.lower())
        step_s = float(np.median(times[WARMUP:]))
        tokens = data * ROWS * SEQ
        emit("steps", arch=cfg.name, layers=cfg.n_layers,
             mesh={"data": data, "model": model}, batch=data * ROWS, seq=SEQ,
             step_seconds=times, step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
             mfu_6nt=6 * cfg.param_count() * tokens / (step_s * world * cs.PEAK_BF16_FLOPS),
             loss=float(m["loss"]), peak_gb_per_rank=peaks.tolist(),
             reckoned_gb=train_memory_gb(cfg, data, model), nccl_device_ms=nccl_ms,
             **cs.summarize(trace, wall, 1))
        del state, step, trace
        torch.cuda.empty_cache()
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
