#!/usr/bin/env python3
"""The private pool of a captured tensor-parallel step against the eager
step's memory, on the cards of one host over NCCL.

    torchrun --nproc-per-node 4 scripts/graph_pool_ab.py MODEL LAYERS
    # the A/B of PyTorch's and NCCL's own settings, one process group each:
    for env in "" TORCH_NCCL_AVOID_RECORD_STREAMS=1 NCCL_GRAPH_REGISTER=0; do
        env $env torchrun --nproc-per-node 4 scripts/graph_pool_ab.py 4 8
    done

Run from the repository root, one process a card.  olmoe-1b-7b at full
width cut to LAYERS layers on a (world / MODEL, MODEL) mesh, 4 × 2048
tokens a data rank: an eager run of 3 steps (a ``GraphedTrainStep``'s
step run eagerly on its buffers), then a graphed run of 3 (the warm-up,
the capture, a replay), each from seed 0 and freed before the next.
Rank 0 prints one JSON line: the two settings read from the environment,
and for each run the state's GB, the peaks allocated and reserved, and
the capture's pool (the growth of reserved memory at the capture).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

SETTINGS = ("TORCH_NCCL_AVOID_RECORD_STREAMS", "NCCL_GRAPH_REGISTER")
ROWS, SEQ, STEPS = 4, 2048, 3


def main() -> None:
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import GraphedTrainStep, init_train_state, make_train_step
    model, layers = int(sys.argv[1]), int(sys.argv[2])
    mesh = make_local_mesh(model=model)
    rank = dist.get_rank()
    if rank == 0:
        _build.build()
    dist.barrier()
    cfg = cs.cut_depth(get("olmoe-1b-7b"), layers)
    dev = mesh_ctx.mesh_device(mesh)
    out = {"env": {k: os.environ.get(k) for k in SETTINGS}, "model": model,
           "layers": layers, "nvidia_smi": cs.nvidia_smi() if rank == 0 else None}
    for graphed in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_train_state(cfg, opt, gen, mesh)
        with mesh_ctx.set_mesh(mesh):
            stream = make_stream(cfg, mesh_ctx.dp_size(mesh) * ROWS, SEQ, seed=1)
        step = GraphedTrainStep(make_train_step(cfg, opt), state, stream.batch_at(0))
        torch.cuda.synchronize()
        state_gb = torch.cuda.memory_allocated() / 1e9
        for i in range(STEPS):
            if graphed:
                m = step(state, stream.batch_at(i))[1]
            else:
                step._load(stream.batch_at(i))
                m = step._eager_step()[1]
            float(m["loss"])
        out["graphed" if graphed else "eager"] = {
            "state_gb": state_gb, "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "pool_gb": step.graph_pool_bytes / 1e9}
        del step, state, m
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
