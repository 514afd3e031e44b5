"""Multi-pod dry run on the meta device: every (arch × shape × mesh) cell
reckoned rank by rank, with nothing allocated (port of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh {16x16,2x16x16,both} [--mesh-shape 64x4] [--out DIR]

The reference lowers and compiles each cell's step over 256 or 512
placeholder devices and reads XLA's memory and cost analyses.  Torch has
neither, so the port runs the step itself, as one rank of the mesh plays
it, on the meta device under one counter (:mod:`repro_torch.launch.costs`):

* a ``fake`` process group of 256 or 512 ranks in this one process, which
  plays a chosen rank: every collective returns at once, and is counted;
* each rank's local shards are meta tensors of the shapes the sharding
  rules give it (:mod:`repro_torch.distributed.sharding`): the train state
  as DTensors (parameters by the rules, m, v and master by ZeRO-1), the
  serving parameters and the decode cache (``cache_shardings``) as local
  tensors, each cell's batch as the rank's rows;
* the steps are the port's own: ``make_train_step``, ``forward`` (remat
  off, the logits left vocab-sharded) and ``make_serve_step`` on a mesh,
  with the reference's settings (``loss_chunk`` 1024, ``vocab_pad`` 256,
  bf16 parameters, ``attn_q_chunk`` 1024, ``seq_shard``, ``moe_groups =
  max(32, tokens // 2048)``);
* the kernels take their meta route (their checks, their outputs and
  scratch allocated on meta, their FLOPs and bytes reported), so the
  counts are the card's route's, not the plain versions'.

A cell's ranks differ only where a split is uneven (hymba's 5 KV groups
over 2 model ranks); the dry run plays one rank of each distinct work
(:func:`rank_classes`) and records the largest.  Memory is reckoned: the
argument bytes are the rank's shards, the peak the live meta storages over
the step.  The roofline takes ``launch/mesh.py``'s H100 datasheet rates,
each mesh axis's collectives on the link it crosses (``axis_link``): an
axis of 16 spans two 8-card nodes, so it crosses InfiniBand.  One JSON a
cell under ``--out`` and a summary line a cell; a non-zero exit if any
cell fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import all_archs, get, get_smoke
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costs
from repro_torch.launch.mesh import (
    HBM_BW, PEAK_FLOPS_BF16, PRODUCTION_SHAPES, axis_link,
)
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig, cell_applicable
from repro_torch.models.model import cache_specs, input_specs
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.serve.engine import make_serve_step
from repro_torch.train.step import TrainStepConfig, abstract_train_state, make_train_step
from repro_torch.tree import tree_map

#: effective bytes crossing a link per payload byte (ring algorithms), the
#: reference's
_ALGO_FACTOR = {
    "all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}

#: a card's memory (NVIDIA H100 SXM5 80 GB)
CARD_BYTES = 80e9

def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N_active·D reference FLOPs for the whole step (train), 2·N_active·D
    for a prefill, or 2·N_active·B for one decode token."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch


def _moe_groups(shape: ShapeConfig) -> int:
    return max(32, shape.tokens // 2048)


def roofline(flops: float, hbm_bytes: float, by_axis: dict[str, dict[str, int]],
             sizes: dict[str, int]) -> dict[str, Any]:
    """Three-term per-device roofline (seconds): FLOPs at the bf16 peak,
    bytes at HBM's rate, and each axis's collective bytes (times the ring
    factor) at the rate of the link it crosses."""
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / HBM_BW
    coll_bytes, collective_s = 0.0, 0.0
    for axis, kinds in by_axis.items():
        moved = sum(b * _ALGO_FACTOR[k] for k, b in kinds.items())
        coll_bytes += moved
        collective_s += moved / axis_link(sizes, axis)[1]
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "collective_bytes": coll_bytes,
            "dominant": dominant,
            "step_s_lower_bound": max(compute_s, memory_s, collective_s)}


# ---------------------------------------------------------------------------
# One process as any rank of a mesh
# ---------------------------------------------------------------------------

def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...], rank: int,
              device: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on ``device`` in a
    ``fake`` process group of that many ranks, this process playing
    ``rank`` (a running group is replaced)."""
    store = _fake_store()
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=rank, world_size=math.prod(shape),
                            store=store)
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def _fake_store():
    """A store for the ``fake`` backend, which torch registers in a testing
    module of its own (not a public API: the one place the port reads it)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry run needs torch's fake process group "
            f"(torch.testing._internal.distributed.fake_pg), which torch "
            f"{torch.__version__} does not have: {e}") from e
    return FakeStore()


def _local_shape(leaf: torch.Tensor, spec: shd.Spec, mesh) -> list[int]:
    return [s.stop - s.start for s in shd.local_slices(spec, leaf.shape, mesh)]


def _shard(leaf: torch.Tensor, spec: shd.Spec, mesh, device: str) -> torch.Tensor:
    """A rank's shard of ``leaf``: empty on meta, zeros elsewhere (a count
    of the same step on real tensors)."""
    make = torch.empty if device == "meta" else torch.zeros
    return make(_local_shape(leaf, spec, mesh), dtype=leaf.dtype, device=device)


def local_shards(tree: Any, specs: Any, mesh, device: str = "meta") -> Any:
    """This rank's shards of an abstract tree: meta tensors, or zeros on
    another ``device`` (a Python value as it is)."""
    return tree_map(lambda leaf, spec: (_shard(leaf, spec, mesh, device)
                                        if isinstance(leaf, torch.Tensor) else leaf),
                    tree, specs)


def dtensor_shards(tree: Any, specs: Any, mesh, device: str = "meta") -> Any:
    """This rank's shards of an abstract tree as DTensors over local
    tensors made as :func:`local_shards` makes them (a train state as
    ``init_train_state`` stores it)."""
    return tree_map(lambda leaf, spec: shd.from_local(
        _shard(leaf, spec, mesh, device), leaf.shape, spec, mesh), tree, specs)


def cell_config(arch: str, smoke: bool = False, loss_chunk: int = 1024,
                overrides: dict | None = None) -> ArchConfig:
    """The reference's dry-run settings over ``arch``'s config (its smoke
    config with ``smoke``), then ``overrides``."""
    opts = dict(loss_chunk=loss_chunk, vocab_pad=256, param_dtype="bfloat16",
                attn_q_chunk=1024, seq_shard=True)
    opts.update(overrides or {})
    return dataclasses.replace((get_smoke if smoke else get)(arch), **opts)


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh, device: str = "meta",
               n_micro: int = 1) -> tuple[Callable[[], Any], tuple]:
    """(the cell's step as a call, its arguments) on this rank's meta
    shards (or, on another ``device``, zeros of the same shapes): the train
    step (with ``n_micro`` microbatches, as the reference's
    ``lower_train_cell``), a prefill (``forward``, remat off, the logits
    left vocab-sharded) or a decode step (``make_serve_step`` on the mesh,
    the cache at its last position)."""
    sizes = shd.axis_sizes(mesh)
    dp = shd._dp_entry(sizes)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = AdamW(schedule=cosine_schedule(3e-4, 2000, 100_000))
        step = make_train_step(cfg, opt, TrainStepConfig(
            n_micro=n_micro, moe_groups=_moe_groups(shape)))
        state = abstract_train_state(cfg, opt)
        state = dtensor_shards(state, shd.state_shardings(state, mesh), mesh, device)
        batch = local_shards(batch, shd.batch_shardings(batch, mesh), mesh, device)
        return (lambda: step(state, batch)), (state, batch)
    if shape.kind == "prefill":
        infer = dataclasses.replace(cfg, remat="none")
        params = transformer.init_abstract_params(infer)
        params = local_shards(params, shd.params_shardings(params, mesh), mesh, device)
        batch = {k: v for k, v in batch.items() if k != "labels"}
        batch = local_shards(batch, shd.batch_shardings(batch, mesh), mesh, device)
        seq_spec = shd.Spec((dp, "model", None)) if cfg.seq_shard else None

        def prefill():
            with mesh_ctx.set_mesh(mesh), torch.no_grad():
                return transformer.forward(infer, params, batch, _moe_groups(shape),
                                           seq_spec, gather=False)
        return prefill, (params, batch)
    params = transformer.init_abstract_params(cfg)
    params = local_shards(params, shd.params_shardings(params, mesh), mesh, device)
    cache = cache_specs(cfg, shape)
    # pos, the cache's 0-d int32 tensor, passes through replicated
    cache = local_shards(cache, shd.cache_shardings(cache, mesh), mesh, device)
    token = local_shards(batch["token"], shd.batch_shardings(batch["token"], mesh), mesh,
                       device)
    serve_step = make_serve_step(cfg, mesh)

    def decode():
        with torch.no_grad():
            return serve_step(params, cache, token)
    return decode, (params, cache, token)


def rank_classes(cfg: ArchConfig, m: int) -> dict[tuple, int]:
    """{signature: the first ``model`` rank with it}: ranks with one
    signature do the same work (the sizes of their compute and cache views
    and hidden blocks)."""
    out: dict[tuple, int] = {}
    for j in range(m):
        sig = []
        if cfg.n_heads:
            v = shd.attn_view(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, m, j)
            sig.append(None if v is None else (v["heads"][1] - v["heads"][0],
                                               v["kv_heads"][1] - v["kv_heads"][0]))
        if cfg.ssm_state:
            v = shd.ssm_view(cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state,
                             cfg.ssm_groups, m, j)
            sig.append(None if v is None else v["heads"][1] - v["heads"][0])
        for n in (cfg.d_ff, cfg.moe_d_ff):
            if n:
                (a, b), = shd.hidden_view(n, m, j)
                sig.append(b - a)
        out.setdefault(tuple(sig), j)
    return out


def count_rank(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: tuple,
               axes: tuple, rank: int, n_micro: int = 1) -> tuple[costs.Counter, float]:
    """``model`` rank ``rank`` (pod 0, data 0) of a ``mesh_shape`` mesh over
    ``axes`` in a fake group: its step on meta shards under the counter
    (strict: no tensor made off meta).  Returns (the counter, the seconds
    the count took)."""
    mesh = fake_mesh(mesh_shape, axes, rank)
    try:
        fn, args = build_step(cfg, shape, mesh, n_micro=n_micro)
        counter = costs.Counter("meta", strict=True)
        counter.track(*args)
        t0 = time.perf_counter()
        with counter:
            out = fn()
            counter.output_bytes = sum(t.numel() * t.element_size() for t in _tensors(out))
            del out
        return counter, time.perf_counter() - t0
    finally:
        dist.destroy_process_group()


def _tensors(tree: Any) -> list[torch.Tensor]:
    from repro_torch.bridge import flatten
    return [shd.local(v) for v in flatten(tree).values()
            if isinstance(shd.local(v), torch.Tensor)]


def mesh_of(multi_pod: bool, mesh_shape: tuple | None) -> tuple[tuple, tuple, str]:
    """(shape, axes, name) of a cell's mesh."""
    if mesh_shape is not None:
        axes = (("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model"))
        return tuple(mesh_shape), axes, "x".join(map(str, mesh_shape))
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return shape, axes, "x".join(map(str, shape))


def run_cell(arch: str, shape_name: str | ShapeConfig, multi_pod: bool,
             outdir: Path | None = None, loss_chunk: int = 1024,
             overrides: dict | None = None, mesh_shape: tuple | None = None,
             smoke: bool = False, ranks: tuple[int, ...] | None = None,
             n_micro: int = 1) -> dict:
    """One cell's record.  ``mesh_shape`` re-maps the same chips to another
    (data, model) or (pod, data, model) split; ``ranks`` plays these
    ``model`` ranks instead of one of each class; ``shape_name`` may be a
    ``ShapeConfig`` of its own (a cell of another size); a train cell runs
    ``n_micro`` microbatches (the reference's ``lower_train_cell``
    argument; the CLI, as the reference's, has no flag for it)."""
    cfg = cell_config(arch, smoke, loss_chunk, overrides)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    mshape, axes, mesh_name = mesh_of(multi_pod, mesh_shape)
    record: dict[str, Any] = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    ok, reason = cell_applicable(cfg, shape)
    record["applicable"] = ok
    if not ok:
        record["skip_reason"] = reason
        return record
    sizes = dict(zip(axes, mshape))
    m = sizes.get("model", 1)
    plays = sorted(set(ranks if ranks is not None else rank_classes(cfg, m).values()))
    runs = []
    for j in plays:                               # pod 0, data 0, model j
        try:
            counter, seconds = count_rank(cfg, shape, mshape, axes, j, n_micro)
        except Exception as e:
            raise type(e)(f"{arch} {shape.name} {mesh_name} model rank {j}: {e}") from e
        runs.append((counter.peak, counter.flops, j, counter, seconds))
    peak, flops, j, counter, seconds = max(runs, key=lambda r: r[:2])
    chips = math.prod(mshape)
    summ = counter.summary()
    rl = roofline(counter.flops, counter.hbm_bytes, counter.by_axis, sizes)
    mflops = model_flops(cfg, shape)
    layer_kinds: dict[str, int] = {}
    for k in cfg.layer_types:
        layer_kinds[k] = layer_kinds.get(k, 0) + 1
    record.update({
        "chips": chips,
        "rank": {"global": j, "coords": {a: (j if a == "model" else 0) for a in axes},
                 "model_ranks_played": plays,
                 "peak_bytes_by_model_rank": {str(r[2]): r[0] for r in runs}},
        "links": {a: dict(zip(("link", "bytes_per_s"), axis_link(sizes, a)))
                  for a in axes},
        "reckon_seconds": sum(r[4] for r in runs),
        "memory": {"argument_bytes": counter.argument_bytes,
                   "output_bytes": counter.output_bytes,
                   "temp_bytes": counter.peak - counter.argument_bytes,
                   "peak_bytes": counter.peak,
                   "fits_80gb": counter.peak <= CARD_BYTES},
        # the port loops over layers in Python: the totals are exact, and
        # per_kind keeps only the reference's key (its layer counts)
        "per_kind": {kind: {"n_layers": n} for kind, n in sorted(layer_kinds.items())},
        "hlo_flops_per_device": counter.flops,
        "hlo_bytes_per_device": counter.hbm_bytes,
        "aten_flops": summ["aten_flops"], "aten_bytes": summ["aten_bytes"],
        "kernels": summ["kernels"],
        "collectives": summ["collectives"],
        "collectives_by_axis": summ["collectives_by_axis"],
        "roofline": rl,
        "model_flops_total": mflops,
        "model_flops_per_device": mflops / chips,
        "useful_flops_ratio": (mflops / chips) / counter.flops if counter.flops else None,
    })
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)
        fname = f"{arch.replace('.', '_')}__{shape.name}__{mesh_name}.json"
        (outdir / fname).write_text(json.dumps(record, indent=1, default=str))
    return record


def sweep(archs: list[str], shapes: list[str], meshes: list[bool], outdir: Path,
          mesh_shape: tuple | None = None, smoke: bool = False,
          arch_overrides: dict[str, dict] | None = None) -> int:
    """Every (arch, shape, mesh) cell, a summary line each (a failure's
    with its cause); returns the number that failed.  ``smoke`` runs the
    smoke configs, with ``arch_overrides[arch]`` over each (sizes the
    kernels take at ``model`` 16)."""
    failures = 0
    for arch in archs:
        overrides = (arch_overrides or {}).get(arch)
        for shape_name in shapes:
            for multi_pod in meshes:
                name = mesh_of(multi_pod, mesh_shape)[2]
                try:
                    rec = run_cell(arch, shape_name, multi_pod, outdir,
                                   overrides=overrides, mesh_shape=mesh_shape,
                                   smoke=smoke)
                except Exception as e:  # noqa: BLE001  (each cell's failure is reported)
                    failures += 1
                    print(f"FAIL {arch} {shape_name} {name}: {type(e).__name__}: {e}",
                          flush=True)
                    continue
                if not rec.get("applicable", True):
                    print(f"SKIP {arch} {shape_name}: {rec['skip_reason']}", flush=True)
                    continue
                rl = rec["roofline"]
                print(f"OK   {arch:18s} {shape_name:12s} {rec['mesh']:8s} "
                      f"reckon={rec['reckon_seconds']:6.1f}s "
                      f"flops/dev={rec['hlo_flops_per_device']:.3e} "
                      f"dom={rl['dominant']:10s} "
                      f"peakMB={rec['memory']['peak_bytes'] / 1e6:9.1f}", flush=True)
    if failures:
        print(f"{failures} cells failed", flush=True)
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["16x16", "2x16x16", "both"])
    ap.add_argument("--mesh-shape", default=None,
                    help="the same chips as another split, e.g. 64x4")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mesh_shape = (tuple(int(v) for v in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    meshes = ([False] if mesh_shape else
              {"16x16": [False], "2x16x16": [True], "both": [False, True]}[args.mesh])
    return 1 if sweep(archs, shapes, meshes, Path(args.out), mesh_shape) else 0


if __name__ == "__main__":
    raise SystemExit(main())
