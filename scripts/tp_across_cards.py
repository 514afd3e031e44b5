#!/usr/bin/env python3
"""The port's tensor-parallel training and decode across the cards of one
host, over NCCL.

    torchrun --nproc-per-node 4 scripts/tp_across_cards.py [--arch A ...]
    torchrun --nproc-per-node 4 scripts/tp_across_cards.py --smoke --device cpu

Run from the repository root, one process a card (``--device cpu``: one
gloo rank a process, the smoke configs at a (4, 32) batch a data rank,
gemma-7b's with 4 query and 4 KV heads so that they split one a rank as at
full width).  For each ``--arch`` (olmoe-1b-7b and gemma-7b by default;
any ported decoder, e.g. deepseek-7b), at full width, all in one process
group (NCCL's bootstrap does not survive a destroyed and restarted default
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

Rank 0 prints one JSON line a phase, with the card's name and power limit
(``--device cpu``: none; every time is then the host's).  The script exits
non-zero if any phase failed.
"""
from __future__ import annotations

import argparse
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
#: the vocabulary, the attention's heads)
LEAVES = {
    "olmoe-1b-7b": ("segments/[0]/moe/router", "segments/[0]/moe/wi_gate",
                    "segments/[0]/moe/wo"),
    "gemma-7b": ("embed", "segments/[0]/attn/wq", "segments/[0]/attn/wo"),
    "deepseek-7b": ("embed", "lm_head", "segments/[0]/attn/wq", "segments/[0]/attn/wo",
                    "segments/[0]/mlp/wi_gate", "segments/[0]/mlp/wo", "final_norm"),
}
#: smoke configs as the script runs them: gemma-7b's 2 heads do not split
#: over 4 ranks, its full width's 16 do
SMOKE_OVERRIDES = {"gemma-7b": {"n_heads": 4, "n_kv_heads": 4}}
#: decode: chip_smoke's tp_decode sizes; a shorter cache at smoke size
SMOKE_DECODE_LEN, PROFILE_TOKENS = 64, 4


def step_meshes(cfg, world: int, budget_gb: float) -> list[tuple[int, int, float, bool]]:
    """(data, model, reckoned GB a device, fits) for each (data, model)
    mesh of ``world`` ranks with a model axis, model ``world`` first: fits
    where ``train_memory_gb`` is within ``budget_gb``."""
    from repro_torch.train.step import train_memory_gb
    out = []
    for model in range(world, 1, -1):
        if world % model:
            continue
        gb = train_memory_gb(cfg, world // model, model)["total_gb"]
        out.append((world // model, model, gb, gb <= budget_gb))
    return out


def config(arch: str, smoke: bool):
    from repro_torch.configs import get, get_smoke
    return get_smoke(arch, **SMOKE_OVERRIDES.get(arch, {})) if smoke else get(arch)


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



def agreement(run: Run, cfg) -> None:
    """Phase 1: a cut of depth at model N against one rank on the same state
    and batch; every rank exits on a disagreement."""
    from repro_torch.bridge import flatten
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step
    cs = run.cs
    layers = min(AGREEMENT_LAYERS, cfg.n_layers)
    cut = cs.cut_depth(cfg, layers)
    leaves = LEAVES.get(cfg.name.removesuffix("-smoke"), ("embed",))
    mesh = run.mesh(run.world)
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    state = init_train_state(cut, opt, run.generator(0), mesh)
    batch = _batch(cut, ROWS, run.seq, 0, run.dev)
    state, m = make_train_step(cut, opt)(state, batch)
    got = {k: float(v) for k, v in m.items()}
    params, moments = flatten(state["params"]), flatten(state["opt"]["m"])
    whole = {k: params[k].full_tensor().cpu() for k in leaves}
    whole_m = {k: moments[k].full_tensor().cpu() for k in leaves}
    split = sum(params[k].to_local().numel() < params[k].numel() for k in leaves)
    del state, params, moments
    run.free()
    dist.barrier()
    agree = torch.zeros((), device=run.dev)
    if run.rank == 0:
        ref = init_train_state(cut, opt, run.generator(0))
        ref, rm = make_train_step(cut, opt)(ref, batch)
        lr = float(rm["lr"])
        want, want_m = flatten(ref["params"]), flatten(ref["opt"]["m"])
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
        run.emit("agreement", arch=cut.name, layers=layers,
                 mesh={"data": 1, "model": run.world}, batch=ROWS, seq=run.seq,
                 loss=got["loss"], one_rank_loss=float(rm["loss"]),
                 grad_norm=got["grad_norm"], one_rank_grad_norm=float(rm["grad_norm"]),
                 lr=lr, split_leaves=split, leaf_max_abs_diff_over_lr=diffs,
                 m_max_rel_err=m_errs, loss_rel_tol=cs.TP_LOSS_REL_TOL,
                 grad_norm_rel_tol=cs.TP_GNORM_REL_TOL,
                 param_lr_bound=cs.TP_PARAM_LR_BOUND, m_rel_tol=cs.TP_MOMENT_REL_TOL,
                 agrees=bool(agree), **line)
        del ref, want, want_m
        run.free()
    del whole, whole_m
    dist.broadcast(agree, src=0)
    if not agree:
        dist.destroy_process_group()
        raise SystemExit(f"{cut.name} at model {run.world} disagrees with one rank "
                         "(the agreement line above)")
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


def steps(run: Run, cfg) -> None:
    """Phase 2: full depth on each mesh that fits, graphed and eager in
    turns."""
    cs = run.cs
    for data, model, reckoned, fits in step_meshes(cfg, run.world, cs.TRAIN_BUDGET_GB):
        where = {"data": data, "model": model}
        if not fits:
            run.emit("steps_skipped", arch=cfg.name, layers=cfg.n_layers, mesh=where,
                     reckoned_gb=reckoned, budget_gb=cs.TRAIN_BUDGET_GB,
                     reason=f"train_memory_gb reckons {reckoned:.1f} GB a device, over "
                            f"the {cs.TRAIN_BUDGET_GB} GB budget")
            continue
        out = cs.mesh_graph_case(cfg, run.mesh(model), run.dev, ROWS, run.seq)
        peaks = {k: run.peaks(out[f"{k}_peak_allocated_gb"] or 0.0)
                 for k in ("graphed", "eager")}
        tokens = data * ROWS * run.seq
        flops = 6 * cs.active_params(cfg) * tokens
        have = (torch.cuda.get_device_properties(run.dev).total_memory / 1e9
                if run.on_card else None)
        launches = out["launches_a_step"]
        want_launches = cs.step_launches(cfg) if run.on_card else launches
        failures = out["failures"] + [
            what for what, bad in (
                ("a loss not finite", not all(map(math.isfinite, out["losses"]))),
                (f"launches {launches}, want {want_launches}", launches != want_launches),
                ("a rank's peak over its card",
                 run.on_card and max(peaks["graphed"] + peaks["eager"]) > have)) if bad]
        ok = not run.any_rank(bool(failures))
        # the graphed step's ms, or the eager one's where the capture did
        # not fit the card
        step_ms = (out.get("graphed_step_ms") or min(out["eager_step_ms"])
                   if run.on_card else None)
        run.emit("steps", arch=cfg.name, layers=cfg.n_layers, mesh=where,
                 batch=data * ROWS, seq=run.seq, loss=out["losses"][-1],
                 model_flops_6nt=flops,
                 active_params=cs.active_params(cfg),
                 mfu_6nt=(flops / (step_ms / 1e3 * run.world * cs.PEAK_BF16_FLOPS)
                          if run.on_card else None),
                 graphed_peak_gb_per_rank=peaks["graphed"],
                 eager_peak_gb_per_rank=peaks["eager"], card_gb=have, reckoned_gb=reckoned,
                 want_launches=want_launches, ok=ok,
                 **{k: v for k, v in out.items() if k != "failures"}, failures=failures)
        if not ok:
            run.failed.append(f"steps {cfg.name} {where}")
        del out
        run.free()
        dist.barrier()


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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at a (4, 32) batch a data rank")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run = Run(args)
    for arch in args.arch:
        cfg = config(arch, args.smoke)
        agreement(run, cfg)
        steps(run, cfg)
        decode(run, cfg)
    dist.destroy_process_group()
    if run.failed:
        raise SystemExit(f"tp_across_cards: failed: {run.failed}")


if __name__ == "__main__":
    main()
