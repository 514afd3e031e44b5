#!/usr/bin/env python3
"""The port's tensor-parallel training and decode across the cards of one
host, over NCCL.

    torchrun --nproc-per-node 4 scripts/tp_across_cards.py [--arch A ...]
        [--phases agreement steps decode cells decode_cells]
    torchrun --nproc-per-node 4 scripts/tp_across_cards.py --smoke --device cpu

Run from the repository root, one process a card (``--device cpu``: one
gloo rank a process, the smoke configs at a (4, 32) batch a data rank,
with SMOKE_OVERRIDES so that their heads and vocabularies split over the
ranks as at full width).  For each ``--arch`` (olmoe-1b-7b and gemma-7b
by default; any ported decoder, e.g. deepseek-7b, qwen2-moe-a2.7b,
internvl2-26b), at full width, all in one process group (NCCL's bootstrap does not survive a destroyed and restarted default
group), each state freed before the next:

1. ``agreement``: its first AGREEMENT_LAYERS layers at (data 1, model N),
   one step on a (4, 2048) batch, against one rank without a mesh on the
   same state and batch (rank 0, after the others' states are freed): the
   loss and the gradient norm, relative, and the architecture's LEAVES and
   their first moments gathered whole (largest |Δ| over the learning rate,
   and over the leaf's largest |m|), each held to ``chip_smoke.py``'s
   tensor-parallel gates; then at the same mesh and depth the graphed mesh
   step (``GraphedTrainStep``: on the cards, over NCCL, one captured CUDA
   graph a step after the first) against the eager mesh step, on two
   copies of one state (each drawn from seed 0) on the same batches over
   GRAPH_AGREEMENT_STEPS steps, held to the same gates (each step's loss
   and gradient norm; the LEAVES and their first moments after the last),
   and whether they are bit-equal (every metric, and every rank's local
   parameters and optimizer state); every rank exits non-zero on a
   disagreement, before any timing;
2. ``steps``: full depth on each (data, model) mesh of the N ranks with a
   model axis (model N first) whose ``train_memory_gb(cfg, data, model)``
   is within ``chip_smoke.TRAIN_BUDGET_GB`` (a mesh left out gets a
   ``steps_skipped`` line with its reckoning), 4 x 2048 tokens a data
   rank, graphed and eager in turns (``chip_smoke.mesh_graph_case``: three
   runs from seed 0 on the same batches, eager, graphed and eager, each of
   MESH_GRAPH_STEPS steps and MESH_GRAPH_TIMED more timed by CUDA events,
   and one profiled): step ms and tokens/s of both, 6·N·T (MoE: the active
   parameters) against the cards' bf16 peak at the graphed step's ms (the
   eager one's where the capture does not fit the card: then
   ``graphed_does_not_fit`` names the memory, and the mesh has no graphed
   figures),
   whether the graphed run is bit-equal to the eager one, rank 0's graphed
   and eager step profiled (idle share, NCCL device ms, launches, graph
   launches, host syncs), the kernels' launches a step on each rank
   (``step_launches`` of the config on a card: flash attention's forward
   and backward, the grouped GEMM's forward, dx and dw; counted from the
   replays where graphed), the collectives a step (heard from the
   replays), the capture's seconds and pool, and each rank's peak over a
   run (its init included) against the reckoning.  Each graphed step's
   loss and gradient norm must lie within the two-rank gates of its eager
   step's, its launches and collectives be the eager step's, a graphed
   step be one launch, the loss finite and no rank's peak over its card;
3. ``decode``: at (data 1, model N), ``chip_smoke.tp_decode_check`` on
   every rank, its tp_decode check over NCCL: a bf16 serving tree (the
   same on every rank, from one seed), ``init_cache`` with the mesh and
   ``make_serve_step(cfg, mesh)``, TP_DECODE_TOKENS teacher-forced tokens
   on TP_DECODE_SLOTS slots and a cache of TP_DECODE_LEN, against one
   card's decode of the same tokens on the whole tree (rank 0 in bf16,
   rank 1 at fp32 compute, at once, broadcast to every rank) under
   tp_decode's logit, fp32-distance and cache gates; ms a step (one token
   on each slot) and tokens/s beside one card's (rank 0's bf16 decode),
   the collectives a step (count and bytes, from ``repro_torch.events``),
   and over PROFILE_TOKENS more steps under the profiler the NCCL device
   ms a step, the device's busy time and idle share and the host's time by
   operator on each rank; then (``decode_graphed``) the graphed mesh step
   (``GraphedServeStep``: on the cards, over NCCL, the step captured once
   as a CUDA graph after its warm-up, replayed every token, the cache
   updated in place) against the eager one, from the same shards on two
   caches over the same tokens (``chip_smoke.tp_decode_graphed``: the same
   logit and cache gates, its launches and collectives a step, heard from
   the replays, equal to the eager step's, one graph launch a profiled
   step on each rank; whether the two are bit-equal), then both timed in
   turns by CUDA events (ms a step, tokens/s) beside one card's graphed
   ``ServeEngine`` on the whole tree (a tick by the host's clock, its
   replay by CUDA events), rank 0's graphed step profiled (NCCL device
   ms, busy ms, idle share, launches, host syncs), the capture's seconds
   and pool and each rank's peak; the grouped GEMM's launches a token
   (olmoe: 3 a layer, from the replays), and on rank 0 its calls at a
   model-N rank's decode shape against their plain version,
   ``torch._grouped_mm`` and the bound, eager and replayed
   (``decode_gmm``).  A rank whose capture fails makes every rank raise.

4. ``cells`` (only when ``--phases`` names it; its architectures
   CELL_ARCHS unless ``--arch`` says otherwise): the reference's cell
   options (``launch.dryrun.cell_config``: bf16 parameters, ``loss_chunk``
   1024, ``vocab_pad`` 256, ``attn_q_chunk`` 1024, ``seq_shard``) and its
   MoE dispatch groups.  ``cell_agreement``: the agreement above on the
   train cell's CELL_ROWS x 4096 batch at model N (AdamW's fp32 master held,
   olmoe on the mesh step's expert choices where near-ties route a token
   otherwise); ``cells``: the steps above on each mesh at CELL_ROWS x 4096
   tokens a data rank, failing also where a rank's peak passes
   ``train_memory_gb(cfg, data, model, rows, seq)`` or the sequence's
   reduce-scatter and all-gather over ``model`` are missing from the
   collectives (``cells_skipped`` past the budget, then on the same mesh
   the deepest cut within CUT_BUDGET_GB, ``cut_layers``, under the same
   gates, its capture required to fit: qwen2-moe-a2.7b and internvl2-26b,
   whose line carries ``layers`` and ``n_layers``); ``prefill_agreement``
   and ``prefill``: the prefill cell (``prefill``; its peaks within
   chip_smoke.DRYRUN_PEAK_REL_TOL of the dry run's prefill_32k rank at
   (16, N), reckoned beside); on the card ``cell_kernel`` lines, each
   kernel at a model-N rank's shapes of the cells against its plain
   version (``cell_kernels``).

5. ``decode_cells`` (only when ``--phases`` names it; CELL_ARCHS unless
   ``--arch`` says otherwise): the reference's decode_32k cell at its cell
   options, DECODE_CELL_SLOTS sequences a data rank (its 128 over 16 data
   ranks) on a cache of 32,768 positions filled at random from one seed
   (each rank draws the whole cache slab by slab and keeps its shard), at
   (1, N), and for olmoe-1b-7b also at (2, N/2): ``decode_cell_agreement``
   (AGREEMENT_LAYERS layers against one card on the whole cache, its
   expert choices the mesh's where near-ties flip them) and
   ``decode_cells`` (full depth, ``chip_smoke.decode_cell_graphed``: the
   graphed mesh step bit-equal to the eager one, one graph launch a step,
   launches and collectives from the replays the eager step's, both timed
   in turns, NCCL ms, capture, pool, each rank's eager peak within 10% of
   the dry run's reckoning of the same rank at (16, M), run beside); an
   MoE config's decode GEMMs at the cell's rows (``decode_cells_gmm``).

Rank 0 prints one JSON line a phase, with the card's name and power limit
(``--device cpu``: none; every time is then the host's).  The script exits
non-zero if any phase failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ARCHS = ("olmoe-1b-7b", "gemma-7b")
#: the agreement phase's graphed and eager steps
GRAPH_AGREEMENT_STEPS = 3
#: rows a data rank and positions: full size, and with --smoke
ROWS, SEQ, SMOKE_SEQ = 4, 2048, 32
AGREEMENT_LAYERS = 4
#: the leaves the agreement phase gathers whole and holds against one
#: rank's, by architecture: the ones the rules split over ``model``
#: (olmoe: the experts at f / N a rank; gemma-7b: the tied embedding over
#: the vocabulary, the attention's heads; qwen2-moe: its routed experts at
#: f / N, its shared expert at d_ff / N with its sigmoid gate and the router
#: replicated, the untied embedding and head over the vocabulary;
#: internvl2: the vocabulary, the GQA heads, the MLP, and the patches'
#: replicated frontend_proj)
LEAVES = {
    "olmoe-1b-7b": ("segments/[0]/moe/router", "segments/[0]/moe/wi_gate",
                    "segments/[0]/moe/wo"),
    "gemma-7b": ("embed", "segments/[0]/attn/wq", "segments/[0]/attn/wo"),
    "deepseek-7b": ("embed", "lm_head", "segments/[0]/attn/wq", "segments/[0]/attn/wo",
                    "segments/[0]/mlp/wi_gate", "segments/[0]/mlp/wo", "final_norm"),
    "qwen2-moe-a2.7b": ("embed", "lm_head", "segments/[0]/moe/router",
                        "segments/[0]/moe/wi_gate", "segments/[0]/moe/wo",
                        "segments/[0]/moe/shared/wi_gate", "segments/[0]/moe/shared/wi_up",
                        "segments/[0]/moe/shared/wo", "segments/[0]/moe/shared/gate"),
    "internvl2-26b": ("embed", "lm_head", "frontend_proj", "segments/[0]/attn/wq",
                      "segments/[0]/attn/wk", "segments/[0]/mlp/wi_gate",
                      "segments/[0]/mlp/wo"),
}
#: smoke configs as the script runs them: gemma-7b's 2 heads do not split
#: over 4 ranks, its full width's 16 do; internvl2's 2 KV heads do not
#: either, its full width's 8 do (2 a rank, each under several query
#: heads); both vocabularies short of their padding, so that the last rank
#: holds pad columns beside real ones, as at full width (151,936 of
#: 152,064 and 92,553 of 92,672) and every rank holds real ones
SMOKE_OVERRIDES = {"gemma-7b": {"n_heads": 4, "n_kv_heads": 4},
                   "qwen2-moe-a2.7b": {"vocab_size": 250},
                   "internvl2-26b": {"n_heads": 16, "n_kv_heads": 8, "vocab_size": 250}}
#: decode: chip_smoke's tp_decode sizes; a shorter cache at smoke size
SMOKE_DECODE_LEN, PROFILE_TOKENS = 64, 4
#: the phases ``--phases`` picks from, and the ones a run without it runs
PHASES = ("agreement", "steps", "decode", "cells", "decode_cells")
DEFAULT_PHASES = ("agreement", "steps", "decode")
#: the cells phase: the reference's cell options (``launch.dryrun.cell_config``:
#: bf16 parameters, loss_chunk 1024, vocab_pad 256, attn_q_chunk 1024,
#: seq_shard) on these architectures (the default ``--arch`` with it); the
#: train cell at SHAPES["train_4k"]'s positions and CELL_ROWS rows a data
#: rank (the reference's 16 halved: its 256 rows over 16 data ranks), the
#: prefill cell at SHAPES["prefill_32k"]'s positions and PREFILL_ROWS rows
#: a data rank (its 32 over 16), its agreement on PREFILL_ROWS x
#: PREFILL_AGREEMENT_SEQ; at smoke size SMOKE_CELL_SEQ positions for all
#: three, the CE chunked at SMOKE_LOSS_CHUNK
CELL_ARCHS = ("olmoe-1b-7b", "gemma-7b", "deepseek-7b")
CELL_ROWS, PREFILL_ROWS, PREFILL_AGREEMENT_SEQ = 8, 2, 4096
SMOKE_CELL_SEQ, SMOKE_LOSS_CHUNK = 32, 16
#: the train cell on a mesh whose full depth passes chip_smoke.TRAIN_BUDGET_GB
#: (qwen2-moe-a2.7b's and internvl2-26b's, 89-137 GB a card) runs the deepest
#: cut whose train_memory_gb lies within this budget instead.  It is below
#: the full-depth budget because a graphed step's capture reserves memory
#: past the eager step's: the cells graphed at full depth reserved
#: 1.22-1.34x their reckoning (olmoe-1b-7b at (2, 2): 70.31 GB at 52.64;
#: PERF.md §5), so a 72 GB cut would reserve up to ~96 GB of an 85 GB card,
#: while 62 x 1.34 = 83 GB leaves NCCL's and the context's own memory room
CUT_BUDGET_GB = 62.0
#: the full-depth prefill: calls timed by CUDA events after one warm-up
PREFILL_TIMED = 2
#: the decode_cells phase: the reference's decode_32k cell (128 sequences on
#: a cache of 32,768 positions) at the cell options on CELL_ARCHS,
#: DECODE_CELL_SLOTS sequences a data rank (its 128 over 16 data ranks) at
#: (1, N), and for DECODE_CELL_DATA_ARCHS also at (2, N/2); at smoke size on
#: a cache of SMOKE_DECODE_LEN
DECODE_CELL_SLOTS = 8
DECODE_CELL_DATA_ARCHS = ("olmoe-1b-7b",)


def step_meshes(cfg, world: int, budget_gb: float, rows: int = ROWS,
                seq: int = SEQ) -> list[tuple[int, int, float, bool]]:
    """(data, model, reckoned GB a device, fits) for each (data, model)
    mesh of ``world`` ranks with a model axis, model ``world`` first, at
    ``rows`` x ``seq`` tokens a data rank: fits where ``train_memory_gb``
    is within ``budget_gb``."""
    from repro_torch.train.step import train_memory_gb
    out = []
    for model in range(world, 1, -1):
        if world % model:
            continue
        gb = train_memory_gb(cfg, world // model, model, rows=rows, seq=seq)["total_gb"]
        out.append((world // model, model, gb, gb <= budget_gb))
    return out


def config(arch: str, smoke: bool):
    from repro_torch.configs import get, get_smoke
    return get_smoke(arch, **SMOKE_OVERRIDES.get(arch, {})) if smoke else get(arch)


def cell_config(arch: str, smoke: bool):
    """``arch`` at the reference's cell options, as the dry run reckons it
    (``launch.dryrun.cell_config``; at smoke size the CE chunked at
    SMOKE_LOSS_CHUNK)."""
    from repro_torch.launch.dryrun import cell_config as cell
    if smoke:
        return cell(arch, True, SMOKE_LOSS_CHUNK, SMOKE_OVERRIDES.get(arch))
    return cell(arch)


def cell_step_config(data: int, rows: int, seq: int):
    """The train cell's ``TrainStepConfig``: the reference's MoE dispatch
    groups for the cell's global tokens (``launch.dryrun``'s, as its
    ``lower_train_cell``)."""
    from repro_torch.launch.dryrun import _moe_groups
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.step import TrainStepConfig
    return TrainStepConfig(moe_groups=_moe_groups(ShapeConfig("cell", seq, data * rows,
                                                              "train")))


def _batch(cfg, rows, seq, seed, dev):
    from repro_torch.data.pipeline import SyntheticStream
    host = SyntheticStream(cfg, rows, seq, seed=seed).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


class Run:
    """The ranks' shared settings and rank 0's output."""

    def __init__(self, args):
        import chip_smoke as cs
        from repro_torch.launch.mesh import local_world, make_local_mesh
        from repro_torch.distributed import context as mesh_ctx
        self.cs, self.smoke = cs, args.smoke
        self.world = local_world()
        if self.world < 2:
            raise SystemExit("tp_across_cards: needs 2 ranks or more (torchrun "
                             "--nproc-per-node N)")
        self.device_type = args.device or "cuda"
        if self.device_type == "cpu":
            torch.set_num_threads(1)
        mesh = make_local_mesh(model=self.world, device=self.device_type)
        self.rank, self.dev = dist.get_rank(), mesh_ctx.mesh_device(mesh)
        self.on_card = self.dev.type == "cuda"
        self.card = cs.nvidia_smi() if self.on_card else "cpu: no card"
        self.seq = SMOKE_SEQ if self.smoke else SEQ
        self.failed: list[str] = []
        if self.on_card:
            from repro_torch.kernels import _build
            if self.rank == 0:
                _build.build()
            dist.barrier()

    def mesh(self, model: int):
        from repro_torch.launch.mesh import make_local_mesh
        return make_local_mesh(model=model, device=self.device_type)

    def emit(self, phase, **fields):
        if self.rank == 0:
            print(json.dumps({"phase": phase, "ranks": self.world, "device": self.dev.type,
                              "nvidia_smi": self.card, **fields}), flush=True)

    def generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        return gen

    def free(self):
        if self.on_card:
            torch.cuda.empty_cache()

    def peaks(self, mine: float | None) -> list[float] | None:
        """Each rank's ``mine`` (a peak in GB; None off a card)."""
        if not self.on_card:
            return None
        peaks = torch.empty(self.world, device=self.dev)
        dist.all_gather_into_tensor(peaks, torch.tensor([mine], device=self.dev))
        return peaks.tolist()

    def any_rank(self, failed: bool) -> bool:
        """Whether any rank failed (every rank learns it)."""
        flag = torch.tensor(float(failed), device=self.dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())



def routing_flips(got: list, want: list) -> int:
    """(token, call) pairs whose set of chosen experts differs between two
    runs' recorded choices (``chip_smoke.recorded_choices``)."""
    return sum(int((g.sort(-1).values != w.to(g.device).sort(-1).values).any(-1).sum())
               for g, w in zip(got, want))


def agreement(run: Run, cfg, rows: int = ROWS, seq: int | None = None,
              step_cfg=None, phase: str = "agreement") -> None:
    """Phase 1: a cut of depth at model N against one rank on the same state
    and batch; every rank exits on a disagreement.  With bf16 parameters
    the weights held are AdamW's fp32 master (the parameters are its
    rounding to bf16, a step of which is 5 learning rates at |w| 0.02).
    An MoE config's expert choices are recorded in the mesh step; where
    near-ties route a token otherwise in the one-rank step (its choices
    recorded too), the one-rank step is run again on the mesh step's
    choices and the gates hold that (ROADMAP C7: chip_smoke holds
    qwen2-moe on the replayed routing)."""
    from repro_torch.bridge import flatten
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    cs = run.cs
    seq = seq or run.seq
    step_cfg = step_cfg or TrainStepConfig()
    layers = min(AGREEMENT_LAYERS, cfg.n_layers)
    cut = cs.cut_depth(cfg, layers)
    leaves = LEAVES.get(cfg.name.removesuffix("-smoke"), ("embed",))
    held = "params" if cut.param_dtype == "float32" else "master"

    def weights(state):
        return flatten(state["params"] if held == "params" else state["opt"]["master"])

    mesh = run.mesh(run.world)
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    state = init_train_state(cut, opt, run.generator(0), mesh)
    batch = _batch(cut, rows, seq, 0, run.dev)
    with cs.recorded_choices(moe_mod) as mesh_choices:
        state, m = make_train_step(cut, opt, step_cfg)(state, batch)
    got = {k: float(v) for k, v in m.items()}
    params, moments = weights(state), flatten(state["opt"]["m"])
    whole = {k: params[k].full_tensor().cpu() for k in leaves}
    whole_m = {k: moments[k].full_tensor().cpu() for k in leaves}
    stored = flatten(state["params"])
    split = sum(stored[k].to_local().numel() < stored[k].numel() for k in leaves)
    del state, params, moments, stored
    run.free()
    dist.barrier()
    agree = torch.zeros((), device=run.dev)
    if run.rank == 0:
        def one_rank(replay: bool):
            ref = init_train_state(cut, opt, run.generator(0))
            step = make_train_step(cut, opt, step_cfg)
            if replay:
                with cs.replayed_choices(moe_mod, mesh_choices):
                    return (*step(ref, batch), [])
            with cs.recorded_choices(moe_mod) as choices:
                ref, rm = step(ref, batch)
            return ref, rm, choices

        ref, rm, choices = one_rank(replay=False)
        flips = routing_flips(mesh_choices, choices)
        if flips:
            del ref
            run.free()
            ref, rm, _ = one_rank(replay=True)
        lr = float(rm["lr"])
        want, want_m = weights(ref), flatten(ref["opt"]["m"])
        diffs = {k: (whole[k].to(run.dev) - want[k]).abs().max().item() / lr for k in leaves}
        m_errs = {k: ((whole_m[k].to(run.dev) - want_m[k]).abs().max()
                      / want_m[k].abs().max()).item() for k in leaves}
        line = {"loss_rel_err": abs(got["loss"] / float(rm["loss"]) - 1),
                "grad_norm_rel_err": abs(got["grad_norm"] / float(rm["grad_norm"]) - 1)}
        agree.fill_(line["loss_rel_err"] <= cs.TP_LOSS_REL_TOL
                    and line["grad_norm_rel_err"] <= cs.TP_GNORM_REL_TOL
                    and max(diffs.values()) <= cs.TP_PARAM_LR_BOUND
                    and max(m_errs.values()) <= cs.TP_MOMENT_REL_TOL
                    and split > 0)
        run.emit(phase, arch=cut.name, layers=layers,
                 mesh={"data": 1, "model": run.world}, batch=rows, seq=seq,
                 param_dtype=cut.param_dtype, loss_chunk=cut.loss_chunk,
                 seq_shard=cut.seq_shard, moe_groups=step_cfg.moe_groups, held=held,
                 routing_calls=len(mesh_choices), routing_flips=flips,
                 replayed_routing=bool(flips),
                 loss=got["loss"], one_rank_loss=float(rm["loss"]),
                 grad_norm=got["grad_norm"], one_rank_grad_norm=float(rm["grad_norm"]),
                 lr=lr, split_leaves=split, leaf_max_abs_diff_over_lr=diffs,
                 m_max_rel_err=m_errs, loss_rel_tol=cs.TP_LOSS_REL_TOL,
                 grad_norm_rel_tol=cs.TP_GNORM_REL_TOL,
                 param_lr_bound=cs.TP_PARAM_LR_BOUND, m_rel_tol=cs.TP_MOMENT_REL_TOL,
                 agrees=bool(agree), **line)
        del ref, want, want_m
        run.free()
    del whole, whole_m, mesh_choices
    dist.broadcast(agree, src=0)
    if not agree:
        dist.destroy_process_group()
        raise SystemExit(f"{cut.name} at model {run.world} disagrees with one rank "
                         f"(the {phase} line above)")
    if phase == "agreement":
        graph_agreement(run, cut, mesh, leaves)


def graph_agreement(run: Run, cut, mesh, leaves: tuple[str, ...]) -> None:
    """The graphed mesh step against the eager one on two copies of one
    state (each drawn from seed 0), GRAPH_AGREEMENT_STEPS steps on the
    same batches; every rank exits on a disagreement."""
    from repro_torch.bridge import flatten
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import GraphedTrainStep, init_train_state, make_train_step
    cs = run.cs
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    graphed_state, eager_state = (init_train_state(cut, opt, run.generator(0), mesh)
                                  for _ in range(2))
    with mesh_ctx.set_mesh(mesh):
        stream = make_stream(cut, mesh_ctx.dp_size(mesh) * ROWS, run.seq, seed=2)
    graphed = GraphedTrainStep(make_train_step(cut, opt), graphed_state, stream.batch_at(0))
    eager = make_train_step(cut, opt)
    got, want = [], []
    for i in range(GRAPH_AGREEMENT_STEPS):
        host = stream.batch_at(i)
        got.append({k: float(v) for k, v in graphed(graphed_state, host)[1].items()})
        _, m = eager(eager_state, {k: torch.from_numpy(v).to(run.dev) for k, v in host.items()})
        want.append({k: float(v) for k, v in m.items()})
    lr = want[-1]["lr"]
    rel = [{k: abs(g[k] / w[k] - 1) for k in ("loss", "grad_norm")} for g, w in zip(got, want)]
    trees = [(flatten(st["params"]), flatten(st["opt"]["m"])) for st in (graphed_state,
                                                                           eager_state)]
    diffs, m_errs = {}, {}
    for k in leaves:
        (gp, gm), (ep, em) = trees
        diffs[k] = (gp[k].full_tensor() - ep[k].full_tensor()).abs().max().item() / lr
        whole_m = em[k].full_tensor()
        m_errs[k] = ((gm[k].full_tensor() - whole_m).abs().max() / whole_m.abs().max()).item()
    local_equal = all(torch.equal(shd.local(a), shd.local(b)) for a, b in zip(
        flatten(graphed_state).values(), flatten(eager_state).values()))
    bit_equal = got == want and not run.any_rank(not local_equal)
    agrees = (all(r["loss"] <= cs.TP_LOSS_REL_TOL and r["grad_norm"] <= cs.TP_GNORM_REL_TOL
                  for r in rel)
              and max(diffs.values()) <= cs.TP_PARAM_LR_BOUND
              and max(m_errs.values()) <= cs.TP_MOMENT_REL_TOL
              and (graphed.graph is not None) == run.on_card)
    run.emit("graph_agreement", arch=cut.name, layers=cut.n_layers,
             mesh={"data": 1, "model": run.world}, batch=ROWS, seq=run.seq,
             steps=GRAPH_AGREEMENT_STEPS, graphed=graphed.graph is not None,
             capture_s=graphed.capture_seconds, losses=[g["loss"] for g in got],
             eager_losses=[w["loss"] for w in want], rel_err=rel,
             leaf_max_abs_diff_over_lr=diffs, m_max_rel_err=m_errs,
             loss_rel_tol=cs.TP_LOSS_REL_TOL, grad_norm_rel_tol=cs.TP_GNORM_REL_TOL,
             param_lr_bound=cs.TP_PARAM_LR_BOUND, m_rel_tol=cs.TP_MOMENT_REL_TOL,
             bit_equal=bit_equal, agrees=agrees)
    del graphed, eager, graphed_state, eager_state, trees
    run.free()
    if run.any_rank(not agrees):
        dist.destroy_process_group()
        raise SystemExit(f"{cut.name}: the graphed mesh step at model {run.world} "
                         "disagrees with the eager one (the graph_agreement line above)")


def cut_layers(cfg, data: int, model: int, rows: int, seq: int,
               budget_gb: float) -> int | None:
    """The deepest cut of ``cfg`` (its first L < n_layers layers,
    ``chip_smoke.cut_depth``) whose ``train_memory_gb`` at (``data``,
    ``model``), ``rows`` x ``seq`` tokens a data rank, lies within
    ``budget_gb``; None where not even one layer does."""
    import chip_smoke as cs
    from repro_torch.train.step import train_memory_gb
    for layers in range(cfg.n_layers - 1, 0, -1):
        if train_memory_gb(cs.cut_depth(cfg, layers), data, model, rows=rows,
                           seq=seq)["total_gb"] <= budget_gb:
            return layers
    return None


def steps(run: Run, cfg, rows: int = ROWS, seq: int | None = None,
          phase: str = "steps") -> list:
    """Phase 2: full depth on each mesh that fits, graphed and eager in
    turns, ``rows`` x ``seq`` tokens a data rank.  As the cells phase
    (``phase`` "cells": the cell's MoE dispatch groups) it also fails
    where a rank's peak passes the reckoning, or where the step's
    collectives over ``model`` leave out the sequence's reduce-scatter or
    all-gather that ``seq_shard`` sends through NCCL; and on a mesh where
    full depth passes the budget it runs the deepest cut within
    CUT_BUDGET_GB (``cut_layers``) the same way, failing too where its
    capture does not fit the card.  Returns the config each mesh trained
    (full depth or its cut), model N first."""
    from repro_torch.train.step import train_memory_gb
    cs = run.cs
    seq = seq or run.seq
    cell = phase == "cells"
    trained = []
    for data, model, reckoned, fits in step_meshes(cfg, run.world, cs.TRAIN_BUDGET_GB,
                                                   rows, seq):
        where = {"data": data, "model": model}
        if fits:
            mesh_step(run, cfg, data, model, reckoned, rows, seq, phase)
            trained.append(cfg)
            continue
        run.emit(f"{phase}_skipped", arch=cfg.name, layers=cfg.n_layers, mesh=where,
                 batch=data * rows, seq=seq, reckoned_gb=reckoned,
                 budget_gb=cs.TRAIN_BUDGET_GB,
                 reason=f"train_memory_gb reckons {reckoned:.1f} GB a device, over "
                        f"the {cs.TRAIN_BUDGET_GB} GB budget")
        layers = cut_layers(cfg, data, model, rows, seq, CUT_BUDGET_GB) if cell else None
        if layers is None:
            continue
        cut = cs.cut_depth(cfg, layers)
        mesh_step(run, cut, data, model,
                  train_memory_gb(cut, data, model, rows=rows, seq=seq)["total_gb"],
                  rows, seq, phase, n_layers=cfg.n_layers)
        trained.append(cut)
    return trained


def mesh_step(run: Run, cfg, data: int, model: int, reckoned: float, rows: int,
              seq: int, phase: str, n_layers: int | None = None) -> None:
    """``steps`` on one (``data``, ``model``) mesh, ``cfg`` at its depth
    (``n_layers`` given: a cut of a config that deep, whose capture must
    fit the card), ``reckoned`` its ``train_memory_gb``."""
    from repro_torch.train.step import TrainStepConfig
    cs = run.cs
    cell = phase == "cells"
    where = {"data": data, "model": model}
    step_cfg = cell_step_config(data, rows, seq) if cell else TrainStepConfig()
    out = cs.mesh_graph_case(cfg, run.mesh(model), run.dev, rows, seq, step_cfg)
    peaks = {k: run.peaks(out[f"{k}_peak_allocated_gb"] or 0.0) for k in ("graphed", "eager")}
    tokens = data * rows * seq
    flops = 6 * cs.active_params(cfg) * tokens
    have = (torch.cuda.get_device_properties(run.dev).total_memory / 1e9
            if run.on_card else None)
    launches = out["launches_a_step"]
    want_launches = cs.step_launches(cfg) if run.on_card else launches
    sequence = {kind for kind in ("reduce-scatter model", "all-gather model")
                if kind in out["collectives_a_step"]}
    over = [p for p in peaks["graphed"] + peaks["eager"] if p > reckoned] \
        if run.on_card else []
    failures = out["failures"] + [
        what for what, bad in (
            ("a loss not finite", not all(map(math.isfinite, out["losses"]))),
            (f"launches {launches}, want {want_launches}", launches != want_launches),
            ("a rank's peak over its card",
             run.on_card and max(peaks["graphed"] + peaks["eager"]) > have),
            (f"a rank's peak over the reckoning {reckoned:.2f} GB: {over}",
             cell and bool(over)),
            (f"the sequence's collectives over model {sorted(sequence)}, want a "
             "reduce-scatter and an all-gather",
             cell and cfg.seq_shard and len(sequence) < 2),
            (f"the cut's capture does not fit the card: {out['graphed_does_not_fit']}",
             n_layers is not None and out["graphed_does_not_fit"] is not None)) if bad]
    ok = not run.any_rank(bool(failures))
    # the graphed step's ms, or the eager one's where the capture did
    # not fit the card
    step_ms = (out.get("graphed_step_ms") or min(out["eager_step_ms"])
               if run.on_card else None)
    profile = out.get("graphed_profile") or {}
    run.emit(phase, arch=cfg.name, layers=cfg.n_layers, n_layers=n_layers or cfg.n_layers,
             mesh=where, batch=data * rows, seq=seq, param_dtype=cfg.param_dtype,
             loss_chunk=cfg.loss_chunk, seq_shard=cfg.seq_shard,
             moe_groups=step_cfg.moe_groups, loss=out["losses"][-1],
             model_flops_6nt=flops,
             active_params=cs.active_params(cfg),
             mfu_6nt=(flops / (step_ms / 1e3 * run.world * cs.PEAK_BF16_FLOPS)
                      if run.on_card else None),
             graph_launches_a_step=profile.get("graph_launches"),
             graphed_peak_gb_per_rank=peaks["graphed"],
             eager_peak_gb_per_rank=peaks["eager"], card_gb=have, reckoned_gb=reckoned,
             cut_budget_gb=CUT_BUDGET_GB if n_layers is not None else None,
             want_launches=want_launches, ok=ok,
             **{k: v for k, v in out.items() if k != "failures"}, failures=failures)
    if not ok:
        run.failed.append(f"{phase} {cfg.name} {where} at {cfg.n_layers} layers")
    del out
    run.free()
    dist.barrier()


def prefill_params(run: Run, cfg, mesh):
    """``cfg``'s parameters drawn from seed 5, each leaf whole then this
    rank's slice by the sharding rules kept (a copy), the rest freed."""
    from repro_torch.bridge import flatten
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    specs = flatten(shd.params_shardings(tfm.init_abstract_params(cfg), mesh))
    return tfm.init_params(cfg, run.generator(5), lambda path, leaf: leaf[
        shd.local_slices(specs[path], leaf.shape, mesh)].clone())


def prefill_call(cfg, mesh, params, batch, moe_groups: int):
    """The reference's prefill cell on this rank (its ``lower_prefill_cell``):
    ``forward`` with the remat off and the sequence over ``model``, the
    logits left vocab-sharded; no gradient."""
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    infer = dataclasses.replace(cfg, remat="none")
    spec = shd.Spec((("pod", "data"), "model", None))

    def call():
        with mesh_ctx.set_mesh(mesh), torch.no_grad():
            return tfm.forward(infer, params, batch, moe_groups, spec, gather=False)
    return call


def gathered_logits(run: Run, cfg, local: torch.Tensor) -> torch.Tensor:
    """The whole (B, S, vocab_size) logits from each rank's vocab-sharded
    columns (the last rank's cut short by the padding: padded to a block
    before the all-gather)."""
    cols = cfg.padded_vocab // run.world
    block = torch.zeros((*local.shape[:-1], cols), dtype=local.dtype, device=local.device)
    block[..., :local.shape[-1]] = local
    blocks = [torch.empty_like(block) for _ in range(run.world)]
    dist.all_gather(blocks, block)
    return torch.cat(blocks, dim=-1)[..., :cfg.vocab_size]


def prefill(run: Run, cfg, reckoning=None) -> None:
    """The prefill cell at (data 1, model N): AGREEMENT_LAYERS layers on
    PREFILL_ROWS x PREFILL_AGREEMENT_SEQ tokens, the logits gathered,
    against one rank's forward of the same tokens on the whole parameters
    under chip_smoke's prefill gates for a dense config
    (``chip_smoke.consistency_or_own_rounding``: §2's bounds, scaled to the
    cut's depth as chip_smoke scales its cuts'; or, where only the max
    bound fails, the mesh's logits no farther from the same weights'
    logits at fp32 compute than DENSE_FP32_REF times one rank's); an MoE
    config on the mesh's expert choices where near-ties route a token
    otherwise, as in the agreement phase; then full depth on
    PREFILL_ROWS x 32,768 positions: ms by CUDA events, tokens/s, a call
    profiled on every rank (rank 0's busy, idle, NCCL ms printed), each
    rank's peak, failing where it is not within DRYRUN_PEAK_REL_TOL of the
    dry run's reckoning of the reference's prefill_32k rank at (16, N)
    (``reckoning``, on the card); ``prefill_does_not_fit`` where the card
    runs out."""
    import gc
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch.dryrun import _moe_groups
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import SHAPES, ShapeConfig
    cs = run.cs
    mesh = run.mesh(run.world)
    seq = SMOKE_CELL_SEQ if run.smoke else PREFILL_AGREEMENT_SEQ
    full_seq = SMOKE_CELL_SEQ if run.smoke else SHAPES["prefill_32k"].seq_len

    def batch(c, s):
        host = SyntheticStream(c, PREFILL_ROWS, s, seed=3).batch_at(0)
        return {k: torch.from_numpy(v).to(run.dev) for k, v in host.items()
                if k != "labels"}

    def groups(s):
        return _moe_groups(ShapeConfig("prefill", s, PREFILL_ROWS, "prefill"))

    layers = min(AGREEMENT_LAYERS, cfg.n_layers)
    cut = cs.cut_depth(cfg, layers)
    inputs = batch(cut, seq)
    with cs.recorded_choices(moe_mod) as mesh_choices:
        local = prefill_call(cut, mesh, prefill_params(run, cut, mesh), inputs,
                             groups(seq))()
    got = gathered_logits(run, cut, local)
    del local
    agree = torch.zeros((), device=run.dev)
    if run.rank == 0:
        whole = tfm.init_params(cut, run.generator(5))
        infer = dataclasses.replace(cut, remat="none")

        def one_rank(c, replay):
            with torch.no_grad(), (cs.replayed_choices(moe_mod, mesh_choices) if replay
                                   else cs.recorded_choices(moe_mod)) as choices:
                return tfm.forward(c, whole, inputs, groups(seq)).flatten(0, 1).float(), choices

        want, choices = one_rank(infer, False)
        # near-ties may route a token otherwise than the mesh did (C7): then
        # the one-rank forward takes the mesh's expert choices
        flips = routing_flips(mesh_choices, choices)
        if flips:
            del want
            want, _ = one_rank(infer, True)
        # the same weights at fp32 compute (the kernels take bf16: their plain
        # versions), on the mesh's expert choices
        with cs.plain_kernels(), cs.plain_grouped_matmul():
            ref, _ = one_rank(dataclasses.replace(infer, compute_dtype="float32"),
                              bool(mesh_choices))
        del whole
        # chip_smoke's prefill gates for a dense config (its own rounding
        # where only the max bound fails) at a cut of depth: the bounds
        # scaled by sqrt(layers / 26), as chip_smoke scales its cuts' (bf16
        # rounding adds up as a random walk)
        check = cs.consistency_or_own_rounding(
            want, got.flatten(0, 1).float(), ref, layers,
            depth_scale=math.sqrt(layers / cs.CONSISTENCY_LAYERS))
        agree.fill_(check["within_bounds"])
        run.emit("prefill_agreement", arch=cut.name, layers=layers,
                 mesh={"data": 1, "model": run.world}, batch=PREFILL_ROWS, seq=seq,
                 moe_groups=groups(seq), routing_calls=len(mesh_choices),
                 routing_flips=flips, replayed_routing=bool(flips),
                 agrees=bool(agree), **check)
        del want, ref
    del got, inputs, mesh_choices
    run.free()
    dist.broadcast(agree, src=0)
    if not agree:
        dist.destroy_process_group()
        raise SystemExit(f"{cut.name}'s prefill at model {run.world} disagrees with one "
                         "rank (the prefill_agreement line above)")

    params = prefill_params(run, cfg, mesh)
    inputs = batch(cfg, full_seq)
    call = prefill_call(cfg, mesh, params, inputs, groups(full_seq))
    tokens = PREFILL_ROWS * full_seq
    if run.on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        shape = tuple(call().shape)
        ms = cs.time_ms(call, PREFILL_TIMED, warmup=0) if run.on_card else None
        profile = cs.mesh_profile(call, run.on_card)   # every rank: its collectives
        reason = None
    except torch.OutOfMemoryError as e:
        shape, ms, profile, reason = None, None, None, str(e)
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 1e9 if run.on_card else None
    failed = run.any_rank(reason is not None)
    peaks = run.peaks(peak or 0.0)
    if failed:
        run.emit("prefill_does_not_fit", arch=cfg.name, layers=cfg.n_layers,
                 mesh={"data": 1, "model": run.world}, batch=PREFILL_ROWS, seq=full_seq,
                 reason=reason, peak_gb_per_rank=peaks)
        run.failed.append(f"prefill {cfg.name}: does not fit")
    else:
        reckoned = reckoned_peak_gb(reckoning, cfg.name, "prefill_32k", run.world)
        rel = [abs(reckoned / p - 1) for p in peaks] if reckoned is not None else None
        within = rel is None or max(rel) <= cs.DRYRUN_PEAK_REL_TOL
        prof = profile or {}
        run.emit("prefill", arch=cfg.name, layers=cfg.n_layers,
                 mesh={"data": 1, "model": run.world}, batch=PREFILL_ROWS, seq=full_seq,
                 param_dtype=cfg.param_dtype, seq_shard=cfg.seq_shard,
                 moe_groups=groups(full_seq), local_logits_shape=shape, wall_ms=ms,
                 tokens_per_s=tokens / ms * 1e3 if ms else None,
                 model_flops_2nt=2 * cs.active_params(cfg) * tokens,
                 busy_ms=prof.get("device_busy_ms"), idle_share=prof.get("idle_share"),
                 nccl_device_ms=prof.get("nccl_device_ms"), profile=profile,
                 peak_gb_per_rank=peaks, reckoned_peak_gb=reckoned, peak_rel_err=rel,
                 peak_rel_tol=cs.DRYRUN_PEAK_REL_TOL, within_reckoning=within)
        if not within:
            run.failed.append(f"prefill {cfg.name}: peaks {peaks} GB, the dry run's "
                              f"{reckoned:.2f} GB")
    del params, inputs, call
    run.free()
    dist.barrier()


def cell_kernels(run: Run, cfg, trained, launches: dict[str, int]) -> None:
    """On rank 0, the kernels at a model-N rank's shapes of the cells: flash
    attention forward and backward on CELL_ROWS x 4096 and the forward on
    PREFILL_ROWS x 32,768 (its plain version not timed there: its dense
    (S, S) scores do not fit a card), the grouped GEMM's forward, dx and
    dw on the train cell's T·K rows; each call timed by CUDA events beside
    its plain version, the library call and the bound (``kernels/costs.py``),
    with ``launches``, a train step's from the replays.  The train cell's
    calls are a step of ``trained`` (``cfg`` or its cut), the prefill's a
    forward of ``cfg``.  Fails where a kernel disagrees with its plain
    version (the attention's at 32,768 positions: with SDPA) past
    chip_smoke's gates."""
    from repro_torch.models.config import SHAPES
    cs = run.cs
    failures = []
    if run.rank == 0:
        gen = run.generator(17)
        local, train_local = (cs.tp_local_config(c, run.world) for c in (cfg, trained))
        seq = SHAPES["train_4k"].seq_len
        if cfg.n_heads:
            # forward and backward at the rank's heads against the plain
            # versions, under chip_smoke's kernel gates
            try:
                errors = cs.tp4_fa_errors(train_local, gen, run.dev, CELL_ROWS, seq)
            except AssertionError as e:
                errors = None
                failures.append(str(e))
            run.free()
            for name, mix in (("flash_attention", cs.fa_prefill_mix),
                              ("flash_attention_bwd", cs.fa_train_mix)):
                run.emit("cell_kernel", kernel=name, arch=cfg.name, model=run.world,
                         layers=trained.n_layers,
                         shape=[CELL_ROWS, seq, local.n_heads, local.n_kv_heads,
                                local.head_dim], calls=len(cs.attention_windows(train_local)),
                         launches=launches.get(name), errors=errors, nvidia_smi=run.card,
                         **mix(train_local, gen, run.dev, CELL_ROWS, seq))
                run.free()
            long = SHAPES["prefill_32k"].seq_len
            fields = cs.fa_prefill_mix(local, gen, run.dev, PREFILL_ROWS, long, plain=False)
            if not fields["max_abs_err"] <= cs.KERNEL_TOL:
                failures.append(f"flash_attention at {PREFILL_ROWS} x {long}: "
                                f"{fields['max_abs_err']} from SDPA > {cs.KERNEL_TOL}")
            run.emit("cell_kernel", kernel="flash_attention", arch=cfg.name,
                     model=run.world, cell="prefill",
                     shape=[PREFILL_ROWS, long, local.n_heads, local.n_kv_heads,
                            local.head_dim], calls=len(cs.attention_windows(local)),
                     launches=cfg.n_layers, tol=cs.KERNEL_TOL, nvidia_smi=run.card,
                     **fields)
            run.free()
        if cfg.n_experts:
            # gmm_errors and dw_errors raise past their gates
            try:
                entries = cs.tp_gmm_entries(trained, gen, run.dev, run.card, launches,
                                            run.world, CELL_ROWS * seq)
            except AssertionError as e:
                entries = []
                failures.append(str(e))
            for entry in entries:
                run.emit("cell_kernel", kernel=entry.pop("name"), arch=cfg.name,
                         model=run.world, layers=trained.n_layers, nvidia_smi=run.card,
                         **entry)
            run.free()
    if run.any_rank(bool(failures)):
        run.failed.append(f"cell_kernel {cfg.name}: {failures or 'on rank 0'}")


def cells(run: Run, arch: str, reckoning=None) -> None:
    """The cells phase for ``arch`` at the reference's cell options: the
    agreement at AGREEMENT_LAYERS layers on the train cell's batch, the
    train cell graphed and eager on each mesh that fits, or at its deepest
    cut that does (``steps`` as "cells"), the prefill cell (its peaks
    against ``reckoning``, the dry run's), and on the card the kernels at
    the cells' shapes."""
    from repro_torch.models.config import SHAPES
    cfg = cell_config(arch, run.smoke)
    seq = SMOKE_CELL_SEQ if run.smoke else SHAPES["train_4k"].seq_len
    agreement(run, cfg, CELL_ROWS, seq, cell_step_config(1, CELL_ROWS, seq),
              phase="cell_agreement")
    trained = steps(run, cfg, CELL_ROWS, seq, phase="cells")
    prefill(run, cfg, reckoning)
    if run.on_card and trained:
        # the train cell at model N (full depth or its cut): the cells
        # phase failed unless its step launched these
        cell_kernels(run, cfg, trained[0], run.cs.step_launches(trained[0]))


def depth_scale(run: Run, cfg) -> float | None:
    """The decode gates' scale with depth: tp_decode's (layers / 26) at full
    size; at smoke size (2 layers) the square root, chip_smoke's scale for
    a shallow cut (bf16 rounding over depth adds up as a random walk)."""
    return math.sqrt(cfg.n_layers / run.cs.CONSISTENCY_LAYERS) if run.smoke else None


def decode(run: Run, cfg) -> None:
    """Phase 3: decode at model N against one card's decode of the same
    tokens, and the graphed mesh step against the eager one
    (``chip_smoke.tp_decode_check`` with ``graphed`` on every rank)."""
    cs = run.cs
    length = SMOKE_DECODE_LEN if run.smoke else cs.TP_DECODE_LEN
    mine = cs.tp_decode_check(cfg, run.mesh(run.world), run.dev, length,
                              depth_scale(run, cfg), PROFILE_TOKENS, graphed=True)
    ranks = [None] * run.world
    dist.all_gather_object(ranks, mine)
    agrees = all(r["agrees"] for r in ranks)
    first, slots = ranks[0], cs.TP_DECODE_SLOTS
    graphed = [r["graphed"] for r in ranks]
    moe_layers = sum(n for kind, n in cfg.segments() if kind == "moe")
    gmm_a_token = graphed[0]["launches"].get("grouped_matmul", 0) / cs.TP_DECODE_TOKENS
    failures = [f"rank {i}: {f}" for i, g in enumerate(graphed) for f in g["failures"]]
    if run.on_card and moe_layers and gmm_a_token != 3 * moe_layers:
        failures.append(f"grouped_matmul launched {gmm_a_token} times a token from the "
                        f"replays, want {3 * moe_layers}")
    run.emit("decode_graphed", arch=cfg.name, layers=cfg.n_layers,
             mesh={"data": 1, "model": run.world}, slots=slots, cache_len=length,
             tokens=cs.TP_DECODE_TOKENS, timed=cs.TP_DECODE_TIMED,
             graphed_ms_a_step=graphed[0].get("graphed_ms_a_step"),
             eager_ms_a_step=graphed[0].get("eager_ms_a_step"),
             graphed_tokens_per_s=graphed[0].get("graphed_tokens_per_s"),
             eager_tokens_per_s=graphed[0].get("eager_tokens_per_s"),
             one_card_engine=first["one_card_engine"],
             one_card_eager_ms_a_step=first["one_rank_step_ms"],
             bit_equal=all(g["bit_equal"] for g in graphed),
             grouped_matmul_a_token=gmm_a_token,
             collectives_a_step=graphed[0]["collectives_a_step"],
             eager_collectives_a_step=first["collectives_a_step"],
             capture_s=[g["capture_s"] for g in graphed],
             graph_pool_gb=[g["graph_pool_gb"] for g in graphed],
             peak_allocated_gb=[g.get("peak_allocated_gb") for g in graphed],
             graph_launches_a_step=[(g.get("profile") or {}).get("per_step", {}).get(
                 "graph_launches") for g in graphed],
             agrees=not failures, failures=failures, per_rank=graphed)
    if failures:
        run.failed.append(f"decode_graphed {cfg.name}")
    if run.on_card and moe_layers:
        if run.rank == 0:
            entry = cs.tp_decode_gmm_entry(cfg, run.generator(11), run.dev, run.card,
                                           graphed[0]["launches"]["grouped_matmul"],
                                           model=run.world)
            run.emit("decode_gmm", arch=cfg.name, **entry)
        dist.barrier()
    run.emit("decode", arch=cfg.name, layers=cfg.n_layers,
             mesh={"data": 1, "model": run.world}, slots=slots, cache_len=length,
             tokens=cs.TP_DECODE_TOKENS, ms_a_step=first["step_ms"],
             tokens_per_s=1e3 * slots / first["step_ms"],
             one_card_ms_a_step=first["one_rank_step_ms"],
             one_card_tokens_per_s=1e3 * slots / first["one_rank_step_ms"],
             collectives_a_step=first["collectives_a_step"],
             nccl_device_ms_a_step=first["nccl_device_ms_a_step"],
             launches=first["launches"], profile=first["profile"],
             seconds=first["seconds"], cache_ref=cs.TP_DECODE_CACHE_REF,
             cache_floor=cs.TP_DECODE_CACHE_FLOOR, fp32_ref=cs.TP_DECODE_FP32_REF,
             depth_scale=depth_scale(run, cfg), agrees=agrees, per_rank=ranks)
    if not agrees:
        run.failed.append(f"decode {cfg.name}")
    run.free()
    dist.barrier()


def decode_cell_meshes(arch: str, world: int) -> list[tuple[int, int]]:
    """The (data, model) meshes the decode_cells phase runs ``arch`` on: (1,
    N), and (2, N/2) for DECODE_CELL_DATA_ARCHS."""
    meshes = [(1, world)]
    if arch in DECODE_CELL_DATA_ARCHS and world % 2 == 0 and world > 2:
        meshes.append((2, world // 2))
    return meshes


def start_reckoning(run: Run, archs: list[str], phases) -> tuple | None:
    """On rank 0, the dry run's reckoning of the cells' ranks at full size,
    started now beside the ranks (``chip_smoke.reckon_cells``): with the
    cells phase the reference's prefill_32k cell over (16, N), whose rank
    holds PREFILL_ROWS sequences at model N as the prefill cell's rank
    here does; with decode_cells its decode_32k cell over (16, M), whose
    rank holds DECODE_CELL_SLOTS sequences at model M as a rank of (data,
    M) here does.  (the process, the JSON path), or None on other ranks, at
    smoke size or with neither phase."""
    if run.rank != 0 or run.smoke:
        return None
    cells = [(arch, "prefill_32k", (16, run.world)) for arch in archs
             if "cells" in phases]
    cells += [(arch, "decode_32k", (16, model)) for arch in archs if "decode_cells" in phases
              for _, model in decode_cell_meshes(arch, run.world)]
    return run.cs.reckon_cells(cells, ROOT / "build" / "tp_cells") if cells else None


def reckoned_peak_gb(reckoning, arch: str, shape: str, model: int) -> float | None:
    """The reckoned peak of ``arch``'s ``shape`` rank at (16, ``model``)
    (rank 0, at full size; waits for the reckoning), else None."""
    if reckoning is None:
        return None
    proc, path = reckoning
    if proc.wait() != 0:
        raise RuntimeError(f"the dry run of the cells failed: exit {proc.returncode}")
    return json.loads(path.read_text())[f"{arch} {shape} 16x{model}"]["peak_bytes"] / 1e9


def _written(cfg, path: str, t: int, start: int, n: int) -> list[int]:
    """The positions of a KV leaf at ``path`` (its segment's kind) that n
    tokens from ``start`` write: a ring's slots, or the positions clamped
    to the cache's last."""
    seg = int(path.split("/")[1].strip("[]"))
    ring = cfg.segments()[seg][0] in ("swa", "hyb_l") and cfg.window
    return sorted({(start + i) % t if ring else min(start + i, t - 1) for i in range(n)})


def _batch_rows(run: Run, mine: torch.Tensor, d: int, data: int) -> torch.Tensor:
    """A (rows a data rank, ...) tensor of every rank (the same on a data
    rank's ``model`` ranks) as the whole batch's, data rank by data rank,
    on every rank."""
    bufs = torch.empty((run.world * mine.shape[0], *mine.shape[1:]), dtype=mine.dtype,
                       device=mine.device)
    dist.all_gather_into_tensor(bufs, mine.contiguous())
    bufs = bufs.view(run.world, *mine.shape)
    where = torch.empty(run.world, dtype=torch.int64, device=mine.device)
    dist.all_gather_into_tensor(where, torch.tensor([d], device=mine.device))
    first = {}
    for r, di in enumerate(where.tolist()):
        first.setdefault(di, r)
    return torch.cat([bufs[first[di]] for di in range(data)])


def decode_cell_agreement(run: Run, cfg, mesh, data: int, length: int) -> bool:
    """Its first AGREEMENT_LAYERS layers at (``data``, model N) on
    data x DECODE_CELL_SLOTS sequences and a cache of ``length``, filled from
    DECODE_CELL_SEED at length - DECODE_CELL_TOKENS (each rank draws the
    whole cache slab by slab and keeps its shard, ``fill_cache`` with the
    mesh), against one card's decode of the same tokens on the whole tree
    and the whole cache filled alike: rank 0 in bf16, rank 1 at fp32
    compute (the grouped GEMM's plain version in the kernel's place), each
    broadcast; an MoE config's expert choices recorded in the mesh step,
    the one-card bf16 step run again on them where near-ties route a token
    otherwise (C7), the fp32 one on them.  tp_decode's gates: this rank's
    logits (its rows, its vocabulary columns) within §2's decode gates of
    one card's at the cut's sqrt depth scale (or, where only the max bound
    fails, held to the model's own rounding as the prefill agreement holds
    them, ``chip_smoke.consistency_or_own_rounding``) and no further from
    the fp32 ones than TP_DECODE_FP32_REF times one card's in mean; its
    cache shards, a layer of a
    leaf at a time against the same slices of one card's, within the
    model's own rounding (TP_DECODE_CACHE_REF, TP_DECODE_CACHE_FLOOR) on
    the positions the tokens wrote, and bit for bit elsewhere (the fill,
    untouched).  Returns whether every rank agrees; rank 0 prints the
    decode_cell_agreement line."""
    import contextlib
    import numpy as np
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import init_cache, init_serving_params
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.tree import tree_map
    cs = run.cs
    layers = min(AGREEMENT_LAYERS, cfg.n_layers)
    cut = cs.cut_depth(cfg, layers)
    slots, n = data * DECODE_CELL_SLOTS, cs.DECODE_CELL_TOKENS
    start = length - n
    m, j = shd.axis_sizes(mesh)["model"], mesh.get_local_rank("model")
    d = mesh.get_local_rank("data") if data > 1 else 0
    rows = slice(d * DECODE_CELL_SLOTS, (d + 1) * DECODE_CELL_SLOTS)
    params = init_serving_params(cut, run.generator(cs.TP_SEED))
    rng = np.random.default_rng(cs.DECODE_CELL_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, slots))).to(run.dev)
    whole = init_cache(cut, slots, length, device="meta")
    slices = {p: shd.local_slices(spec, leaf.shape, mesh) for (p, leaf), spec in zip(
        bridge.flatten(whole).items(), shd.spec_leaves(shd.cache_shardings(whole, mesh)))
        if p != "pos"}

    # the mesh first, its expert choices recorded
    local = tree_map(lambda leaf, spec: leaf[shd.local_slices(spec, leaf.shape, mesh)].clone(),
                     params, shd.params_shardings(params, mesh))
    mine = cs.fill_cache(init_cache(cut, slots, length, device=run.dev, mesh=mesh),
                         cs.DECODE_CELL_SEED, start, whole=whole, mesh=mesh)
    serve = make_serve_step(cut, mesh)
    with cs.recorded_choices(moe_mod) as mesh_choices, torch.inference_mode():
        got = torch.cat([serve(local, mine, tokens[t, rows, None])[0].float()
                         for t in range(n)])
    choices = [_batch_rows(run, c, d, data) for c in mesh_choices]

    # one card on the whole tree and cache: rank 0 in bf16 (on the mesh's
    # expert choices where near-ties route a token otherwise, C7), rank 1 at
    # fp32 compute on the mesh's choices
    one, flips = None, 0
    if run.rank < 2:
        c = cut if run.rank == 0 else dataclasses.replace(cut, compute_dtype="float32")
        cache = init_cache(c, slots, length, device=run.dev)
        serve = make_serve_step(c)

        def decode(replay: bool):
            cs.fill_cache(cache, cs.DECODE_CELL_SEED, start)
            with (cs.replayed_choices(moe_mod, choices) if replay
                  else cs.recorded_choices(moe_mod)) as seen, \
                    (cs.plain_grouped_matmul() if run.rank else contextlib.nullcontext()), \
                    torch.inference_mode():
                return torch.cat([serve(params, cache, tokens[t, :, None])[0].float()
                                  for t in range(n)]), seen

        if run.rank == 0:
            logits, seen = decode(False)
            flips = routing_flips(choices, seen)
            if flips:
                logits, _ = decode(True)
        else:
            logits, _ = decode(bool(choices))
        one = {"logits": logits, "cache": bridge.flatten(cache)}
    del params

    def from_rank(src, value, shape):
        buf = (value.float().contiguous() if run.rank == src
               else torch.empty(shape, dtype=torch.float32, device=run.dev))
        dist.broadcast(buf, src=src)
        return buf

    first = 0 if got.shape[-1] == cfg.vocab_size else j * -(-cfg.padded_vocab // m)
    want, fp32 = (from_rank(src, one and one["logits"], (n * slots, cfg.vocab_size))
                  .view(n, slots, -1)[:, rows].reshape(n * DECODE_CELL_SLOTS, -1)
                  [:, first:first + got.shape[-1]] for src in (0, 1))
    gates = {"layers": layers, "gate": False,
             "depth_scale": math.sqrt(layers / cs.CONSISTENCY_LAYERS)}
    agreement = cs.consistency_or_own_rounding(want, got, fp32, layers,
                                               gates["depth_scale"])
    one_vs_fp32 = cs.logits_agreement(want, fp32, **gates)
    tp_vs_fp32 = cs.logits_agreement(got, fp32, **gates)

    cache_err, untouched = {}, True
    flat = bridge.flatten(mine)
    shapes = {p: tuple(leaf.shape) for p, leaf in bridge.flatten(whole).items()}
    for path, sl in slices.items():
        shape, kv = shapes[path], path.endswith(("/k", "/v"))
        sums = torch.zeros(3, dtype=torch.float64, device=run.dev)
        for layer in range(shape[0]):
            r0, r1 = (from_rank(src, one and one["cache"][path][layer], shape[1:])[sl[1:]]
                      for src in (0, 1))
            a = flat[path][layer]
            if kv:
                idx = torch.tensor(_written(cut, path, shape[2], start, n), device=run.dev)
                same = a == r0.to(a.dtype)
                same[:, idx] = True
                untouched = untouched and bool(same.all())
                a, r0, r1 = a[:, idx], r0[:, idx], r1[:, idx]
            a = a.float()
            sums += torch.stack([(a - r0).square().sum(), (r1 - r0).square().sum(),
                                 r0.square().sum()]).double()
        e_tp, e_ref, norm = sums.tolist()
        cache_err[path] = {"norm": math.sqrt(e_tp / max(norm, 1e-30)),
                           "ref_norm": math.sqrt(e_ref / max(norm, 1e-30))}
    del one, mine, local
    run.free()
    cache_ok = untouched and all(
        e["norm"] <= max(cs.TP_DECODE_CACHE_REF * e["ref_norm"], cs.TP_DECODE_CACHE_FLOOR)
        for e in cache_err.values())
    mine_ok = (agreement["within_bounds"] and cache_ok
               and tp_vs_fp32["mean_rel_to_std"]
               <= cs.TP_DECODE_FP32_REF * one_vs_fp32["mean_rel_to_std"])
    ranks = [None] * run.world
    dist.all_gather_object(ranks, {
        "rank": run.rank, "agrees": mine_ok, "agreement": agreement,
        "one_card_vs_fp32": one_vs_fp32, "tp_vs_fp32": tp_vs_fp32,
        "cache_rel_err": cache_err, "untouched_equal": untouched,
        "cache_within_rounding": cache_ok, "view": shd.cache_view(cut, m, j)})
    agrees = all(r["agrees"] for r in ranks)
    run.emit("decode_cell_agreement", arch=cut.name, layers=layers,
             routing_calls=len(choices), routing_flips=flips, replayed_routing=bool(flips),
             mesh={"data": data, "model": m}, slots=slots, slots_a_data_rank=DECODE_CELL_SLOTS,
             cache_len=length, start_pos=start, tokens=n, param_dtype=cut.param_dtype,
             padded_vocab=cut.padded_vocab, depth_scale=gates["depth_scale"],
             cache_ref=cs.TP_DECODE_CACHE_REF, cache_floor=cs.TP_DECODE_CACHE_FLOOR,
             fp32_ref=cs.TP_DECODE_FP32_REF, agrees=agrees, per_rank=ranks)
    return agrees


def decode_cell_full(run: Run, cfg, mesh, data: int, length: int, reckoned: float | None
                     ) -> None:
    """Full depth at (``data``, model N), data x DECODE_CELL_SLOTS sequences
    and a cache of ``length`` filled as in the agreement: each rank's
    slices of the bf16 serving tree (drawn whole, then freed), then
    ``chip_smoke.decode_cell_graphed`` on every rank (the graphed mesh step
    bit-equal to the eager one on two caches filled alike, launches and
    collectives from the replays the eager step's, one graph launch a
    profiled step; both in turns by CUDA events, the capture's seconds and
    pool, NCCL ms).  It also fails where a rank's eager peak (its first
    step's, the cell's tree and cache included) is not within
    DRYRUN_PEAK_REL_TOL of the dry run's reckoning of the same rank
    (``reckoned``, on the card), or where the grouped GEMM's launches a
    token from the replays are not 3 a MoE layer.  olmoe: its decode GEMMs
    at the cell's rows (``decode_cells_gmm``)."""
    import numpy as np
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import init_cache, init_serving_params
    from repro_torch.tree import tree_map
    cs = run.cs
    slots, n = data * DECODE_CELL_SLOTS, cs.DECODE_CELL_TOKENS
    start = length - n
    m = shd.axis_sizes(mesh)["model"]
    d = mesh.get_local_rank("data") if data > 1 else 0
    rows = slice(d * DECODE_CELL_SLOTS, (d + 1) * DECODE_CELL_SLOTS)
    run.free()
    base = torch.cuda.memory_allocated() if run.on_card else 0
    params = init_serving_params(cfg, run.generator(cs.TP_SEED))
    local = tree_map(lambda leaf, spec: leaf[shd.local_slices(spec, leaf.shape, mesh)].clone(),
                     params, shd.params_shardings(params, mesh))
    del params
    run.free()
    rng = np.random.default_rng(cs.DECODE_CELL_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, slots)))[:, rows].to(run.dev)
    whole = init_cache(cfg, slots, length, device="meta")
    out, eager_cache = cs.decode_cell_graphed(
        cfg, local, lambda: init_cache(cfg, slots, length, device=run.dev, mesh=mesh),
        lambda c: cs.fill_cache(c, cs.DECODE_CELL_SEED, start, whole=whole, mesh=mesh),
        DECODE_CELL_SLOTS, tokens, run.dev, mesh, base=base)
    del eager_cache, local
    run.free()
    peaks = run.peaks(out["eager_peak_gb"] or 0.0)
    graphed_peaks = run.peaks(out.get("graphed_peak_gb") or 0.0)
    moe_layers = sum(k == "moe" for k in cfg.layer_types)
    gmm = out["launches"].get("grouped_matmul", 0) / n
    failures = list(out["failures"])
    if run.on_card and moe_layers and gmm != 3 * moe_layers:
        failures.append(f"grouped_matmul launched {gmm} times a token from the replays, "
                        f"want {3 * moe_layers}")
    rel = None
    if run.rank == 0 and reckoned is not None:
        rel = [abs(reckoned / p - 1) for p in peaks]
        if max(rel) > cs.DRYRUN_PEAK_REL_TOL:
            failures.append(f"eager peaks {peaks} GB, reckoned {reckoned:.2f} GB")
    ranks = [None] * run.world
    dist.all_gather_object(ranks, {"rank": run.rank, "failures": failures,
                                   "bit_equal": out["bit_equal"],
                                   **{k: out.get(k) for k in (
                                       "capture_s", "graph_pool_gb", "graph",
                                       "graphed_ms_a_step", "eager_ms_a_step", "turns",
                                       "graphed_profile", "seconds")}})
    ok = not any(r["failures"] for r in ranks)
    prof = (out.get("graphed_profile") or {}).get("per_step", {})
    run.emit("decode_cells", arch=cfg.name, layers=cfg.n_layers,
             mesh={"data": data, "model": m}, slots=slots, slots_a_data_rank=DECODE_CELL_SLOTS,
             cache_len=length, start_pos=start, tokens=n, param_dtype=cfg.param_dtype,
             padded_vocab=cfg.padded_vocab,
             graphed_ms_a_step=out.get("graphed_ms_a_step"),
             eager_ms_a_step=out.get("eager_ms_a_step"),
             graphed_tokens_per_s=(1e3 * slots / out["graphed_ms_a_step"]
                                   if run.on_card else None),
             eager_tokens_per_s=1e3 * slots / out["eager_ms_a_step"] if run.on_card else None,
             nccl_device_ms_a_step=prof.get("nccl_device_ms"),
             idle_share=(out.get("graphed_profile") or {}).get("idle_share"),
             graph_launches_a_step=[(r["graphed_profile"] or {}).get("per_step", {}).get(
                 "graph_launches") for r in ranks],
             bit_equal=all(r["bit_equal"] for r in ranks), launches=out["launches"],
             grouped_matmul_a_token=gmm, collectives_a_step=out["collectives_a_step"],
             capture_s=[r["capture_s"] for r in ranks],
             graph_pool_gb=[r["graph_pool_gb"] for r in ranks],
             eager_peak_gb_per_rank=peaks, graphed_peak_gb_per_rank=graphed_peaks,
             reckoned_peak_gb=reckoned, peak_rel_err=rel, peak_rel_tol=cs.DRYRUN_PEAK_REL_TOL,
             ok=ok, failures=[f for r in ranks for f in r["failures"]], per_rank=ranks)
    if not ok:
        run.failed.append(f"decode_cells {cfg.name} {(data, m)}")
    if run.on_card and moe_layers:
        if run.rank == 0:
            entry = cs.tp_decode_gmm_entry(cfg, run.generator(11), run.dev, run.card,
                                           out["launches"]["grouped_matmul"], model=m,
                                           slots=DECODE_CELL_SLOTS,
                                           path=f"{cfg.name} decode_32k cell at "
                                                f"({data}, {m}), graphed")
            run.emit("decode_cells_gmm", arch=cfg.name, mesh={"data": data, "model": m},
                     **entry)
        dist.barrier()
    run.free()
    dist.barrier()


def decode_cells(run: Run, arch: str, reckoning) -> None:
    """The decode_cells phase for ``arch`` at the reference's cell options:
    on each of ``decode_cell_meshes``, the agreement at AGREEMENT_LAYERS
    layers, then (where every rank agrees) full depth."""
    from repro_torch.models.config import SHAPES
    cfg = cell_config(arch, run.smoke)
    length = SMOKE_DECODE_LEN if run.smoke else SHAPES["decode_32k"].seq_len
    for data, model in decode_cell_meshes(arch, run.world):
        mesh = run.mesh(model)
        if not decode_cell_agreement(run, cfg, mesh, data, length):
            run.failed.append(f"decode_cell_agreement {cfg.name} {(data, model)}")
            continue
        decode_cell_full(run, cfg, mesh, data, length,
                         reckoned_peak_gb(reckoning, arch, "decode_32k", model))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=None,
                    help=f"default {' '.join(ARCHS)}; with the cells phase "
                         f"{' '.join(CELL_ARCHS)}")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(DEFAULT_PHASES),
                    help="the phases to run, in their order")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at a (4, 32) batch a data rank")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run = Run(args)
    cell_phases = {"cells", "decode_cells"} & set(args.phases)
    archs = args.arch or list(CELL_ARCHS if cell_phases else ARCHS)
    reckoning = start_reckoning(run, archs, args.phases)
    for arch in archs:
        cfg = config(arch, args.smoke)
        for phase in (p for p in PHASES if p in args.phases):
            if phase == "cells":
                cells(run, arch, reckoning)
            elif phase == "decode_cells":
                decode_cells(run, arch, reckoning)
            else:
                {"agreement": agreement, "steps": steps, "decode": decode}[phase](run, cfg)
    if reckoning is not None and reckoning[0].poll() is None:
        reckoning[0].kill()
    dist.destroy_process_group()
    if run.failed:
        raise SystemExit(f"tp_across_cards: failed: {run.failed}")


if __name__ == "__main__":
    main()
