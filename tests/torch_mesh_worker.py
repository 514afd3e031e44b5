"""Rank workers for the port's multi-rank tests on the CPU.

``spawn`` starts ``world`` processes with ``torch.multiprocessing`` (spawn),
joins them in a gloo process group through a ``file://`` store under the
test's own directory (no port: the suite runs under several workers), builds
a ``DeviceMesh`` of the asked shape and axes, runs one job of this module
in every rank and returns each rank's result.  This module imports torch,
numpy and the port only, so the ranks never import jax; their inputs and
results are numpy arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import bridge, events
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.tree import tree_map

LR = 1e-3


def optimizer() -> AdamW:
    """The optimizer every DP case uses, in both processes and references."""
    return AdamW(schedule=cosine_schedule(LR, 2, 10))


def to_torch(tree: Any) -> Any:
    """numpy → CPU tensors (ints as int64, as the tests' batches)."""
    def one(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer) and x.ndim:
            return torch.from_numpy(x.astype(np.int64))
        return torch.from_numpy(np.array(x, copy=True))
    return tree_map(one, tree)


def rank_rows(batch: dict, index: int, n: int) -> dict:
    """Rank ``index``'s block of ``n`` of a global batch (rows)."""
    return {k: v[index * (v.shape[0] // n):(index + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


def _numpy(tree: Any) -> Any:
    """A copy of a tree's local tensors as numpy (bf16 widened)."""
    def one(x):
        x = shd.local(x)
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy().copy()
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Jobs: each runs in every rank, on the mesh, and returns numpy
# ---------------------------------------------------------------------------

def job_dp(mesh, cases: list[dict]) -> list[dict]:
    """Each case: the data-parallel step for ``len(batches)`` steps from a
    whole numpy state, this rank taking its block of each global batch.
    Returns each step's metrics, the parameters after every step, and this
    rank's m, v and master shards with their slices after the last."""
    from repro_torch.train.step import TrainStepConfig, distribute_state, make_train_step
    out = []
    for case in cases:
        cfg = get_smoke(case["arch"], **case["overrides"])
        step = make_train_step(cfg, optimizer(), TrainStepConfig(**case["step_cfg"]))
        state = distribute_state(to_torch(case["state"]), mesh)
        metrics, params = [], []
        with mesh_ctx.set_mesh(mesh):
            n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
        for batch in case["batches"]:
            state, m = step(state, to_torch(rank_rows(batch, i, n)))
            metrics.append({k: float(v) for k, v in m.items()})
            params.append(bridge.flatten(_numpy(state["params"])))
        shards = {}
        for key in ("m", "v", "master"):
            for path, leaf in bridge.flatten(state["opt"][key]).items():
                sl = shd.local_slices(shd.spec_of(leaf), leaf.shape, mesh)
                shards[f"{key}/{path}"] = (leaf.to_local().numpy().copy(),
                                           [(s.start, s.stop) for s in sl])
        out.append({"metrics": metrics, "params": params, "shards": shards,
                    "step": int(state["step"].to_local())})
    return out


def _step_config(step_cfg: dict):
    """A TrainStepConfig from a case's plain dict (``seq_spec`` a list of
    entries, made a Spec)."""
    from repro_torch.train.step import TrainStepConfig
    sc = dict(step_cfg)
    if sc.get("seq_spec") is not None:
        sc["seq_spec"] = shd.Spec(tuple(sc["seq_spec"]))
    return TrainStepConfig(**sc)


def _with_slices(tree: Any, mesh) -> dict:
    """{path: (this rank's local array, its slice bounds in the whole
    leaf)} of a tree of DTensors."""
    out = {}
    for path, leaf in bridge.flatten(tree).items():
        sl = shd.local_slices(shd.spec_of(leaf), leaf.shape, mesh)
        x = leaf.to_local()
        out[path] = ((x.float() if x.dtype == torch.bfloat16 else x).numpy().copy(),
                     [(s.start, s.stop) for s in sl])
    return out


def job_tp(mesh, cases: list[dict]) -> list[dict]:
    """Each case: the mesh step (data and model) for ``len(batches)``
    steps from a whole numpy state, this rank taking its data-parallel
    block of each global batch.  Returns each step's metrics, this rank's
    stored parameter shards with their slices after every step, and its
    m, v and master shards after the last."""
    from repro_torch.train.step import distribute_state, make_train_step
    out = []
    for case in cases:
        cfg = get_smoke(case["arch"], **case["overrides"])
        step = make_train_step(cfg, optimizer(), _step_config(case["step_cfg"]))
        state = distribute_state(to_torch(case["state"]), mesh)
        with mesh_ctx.set_mesh(mesh):
            n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
        metrics, params = [], []
        for batch in case["batches"]:
            state, m = step(state, to_torch(rank_rows(batch, i, n)))
            metrics.append({k: float(v) for k, v in m.items()})
            params.append(_with_slices(state["params"], mesh))
        shards = {f"{key}/{path}": v for key in ("m", "v", "master")
                  for path, v in _with_slices(state["opt"][key], mesh).items()}
        out.append({"metrics": metrics, "params": params, "shards": shards,
                    "step": int(state["step"].to_local()),
                    "coords": {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}})
    return out


def job_refusals(mesh) -> dict:
    """What the mesh step once refused and runs now: ``n_micro`` = 2 over
    the data ranks on this rank's block of a global batch (each step's
    metrics), and the message of a global batch that does not divide by
    n_micro x data ranks."""
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    cfg = get_smoke("gemma3-1b", compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(cfg, optimizer(), gen, mesh)
    step = make_train_step(cfg, optimizer(), TrainStepConfig(n_micro=2))
    with mesh_ctx.set_mesh(mesh):
        n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
    out = {"n_micro": []}
    for batch in refusal_batches(cfg):
        state, m = step(state, to_torch(rank_rows(batch, i, n)))
        out["n_micro"].append({k: float(v) for k, v in m.items()})
    try:
        make_train_step(cfg, optimizer(), TrainStepConfig(n_micro=4))(
            state, to_torch(rank_rows(refusal_batches(cfg)[0], i, n)))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def refusal_batches(cfg) -> list[dict]:
    """job_refusals' two global batches of 4 rows of 8 tokens."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (4, 8))
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return out


def job_microbatches(mesh, cases: list[tuple[int, int]]) -> list[dict]:
    """``dp_microbatches`` on this rank's block of a global batch of row
    numbers, for each (n, rows a rank a microbatch): what it returns, and
    the bytes of the all-to-alls it reports by axis."""
    out = []
    with mesh_ctx.set_mesh(mesh):
        d, r = mesh_ctx.dp_size(), mesh_ctx.dp_index()
        for n, c in cases:
            rows = n * d * c
            block = torch.arange(rows * 3, dtype=torch.float32).view(rows, 3)
            sent: dict[str, int] = {}

            def listen(event, kind, axis, nbytes):
                if event == events.COLLECTIVE:
                    sent[f"{kind} {axis}"] = sent.get(f"{kind} {axis}", 0) + nbytes

            with events.counting(listen):
                got = mesh_ctx.dp_microbatches(block[r * n * c:(r + 1) * n * c], n)
            out.append({"got": got.numpy().copy(), "sent": sent, "rank": r, "dp": d})
    return out


def job_step_collectives(mesh, n_micros: list[int]) -> list[dict]:
    """One gemma3-1b smoke step of the mesh step at each ``n_micro`` on this
    rank's block of refusal_batches' first batch: the collectives it reports
    (count and bytes by kind and axis) and its metrics."""
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    cfg = get_smoke("gemma3-1b")
    with mesh_ctx.set_mesh(mesh):
        n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
    out = []
    for n_micro in n_micros:
        gen = torch.Generator()
        gen.manual_seed(0)
        state = init_train_state(cfg, optimizer(), gen, mesh)
        seen: dict[str, list[int]] = {}

        def listen(event, *details):
            if event == events.COLLECTIVE:
                kind, axis, nbytes = details
                entry = seen.setdefault(f"{kind} {axis}", [0, 0])
                entry[0] += 1
                entry[1] += nbytes

        step = make_train_step(cfg, optimizer(), TrainStepConfig(n_micro=n_micro))
        with events.counting(listen):
            _, m = step(state, to_torch(rank_rows(refusal_batches(cfg)[0], i, n)))
        out.append({"collectives": seen, "metrics": {k: float(v) for k, v in m.items()}})
    return out


def job_collectives(mesh, x: np.ndarray, cots: np.ndarray) -> dict:
    """Each differentiable ``model`` collective on this rank's inputs: ``x``
    (whole, the same on every rank) and its rank's cotangent ``cots[j]``.
    Returns each op's output and the gradient of sum(out * cot) of its
    input."""
    with mesh_ctx.set_mesh(mesh):
        j, m = mesh_ctx.model_rank(), mesh_ctx.axis_size("model")
        k = x.shape[1] // m
        part = np.ascontiguousarray(x[:, j * k:(j + 1) * k])
        cot = torch.from_numpy(cots[j])
        ops = {
            "gather_summed": (part, lambda t: mesh_ctx.model_gather(t, 1, summed=True)),
            "gather_slice": (part, lambda t: mesh_ctx.model_gather(t, 1, summed=False)),
            "reduce_scatter": (x, lambda t: mesh_ctx.model_reduce_scatter(t * (j + 1), 1)),
            "slice": (x, lambda t: mesh_ctx.model_slice(t, 1)),
            "stat_sum": (x, lambda t: mesh_ctx.model_stat_sum(t * (j + 1))),
            "copy": (x, mesh_ctx.model_copy),
            "sum": (x, lambda t: mesh_ctx.model_sum(t * (j + 1))),
            # a view across the shards' boundary, for sliced work
            "view": (part, lambda t: mesh_ctx.model_view(
                t, 1, ((k // 2, k // 2 + k),), x.shape[1])),
        }
        out = {}
        for name, (inp, fn) in ops.items():
            t = torch.tensor(inp, requires_grad=True)
            y = fn(t)
            c = cot[tuple(slice(0, n) for n in y.shape)]
            (g,) = torch.autograd.grad((y * c).sum(), [t])
            out[name] = (y.detach().numpy(), g.numpy())
        out["max"] = mesh_ctx.model_max(torch.tensor(float(j))).item()
    return {"ops": out, "model": j}


def block_call(name: str, kwargs: dict):
    """One tensor-parallel site of the model as ``fn(x, params) -> (out,
    aux or None)``: the module's function with its keyword arguments."""
    from repro_torch.models import attention, layers, moe, ssm
    if name == "mlp":
        return lambda x, p: (layers.mlp(x, p, **kwargs), None)
    if name == "embed":
        def embed(x, p):
            v, d = p["embed"].shape
            table = SimpleNamespace(padded_vocab=kwargs["vocab"], d_model=kwargs["d"],
                                    tie_embeddings=True)
            layout = shd.vocab_view(table, mesh_ctx.axis_size("model"))["embed"]
            return layers.embed_tokens(x, p["embed"], kwargs["scale"], "float32",
                                       layout), None
        return embed
    if name == "attn":
        def attn(x, p):
            b, s, _ = x.shape
            pos = torch.arange(s).expand(b, s)
            return attention.attn_block(x, p, positions=pos, **kwargs)[0], None
        return attn
    if name == "ssm":
        return lambda x, p: (ssm.mamba2_block(x, p, **kwargs)[0], None)
    if name == "moe":
        return lambda x, p: moe.moe_block(x, p, **kwargs)
    raise KeyError(name)


def _block_spec(path: str, shape: tuple, mesh) -> shd.Spec:
    """A block leaf's spec as the rules store it in a model: a layer's leaf
    on a stacked segment's leading layer axis (so no 2-D fallback), the
    embedding as it is."""
    names = path.split("/")
    if names[0] == "embed":
        return shd.fit_spec(shd.param_spec(names, len(shape)), shape, mesh)
    spec = shd.fit_spec(shd.param_spec(names, len(shape) + 1), (1,) + tuple(shape), mesh)
    return shd.Spec(tuple(spec)[1:])


def run_block(name: str, kwargs: dict, x: np.ndarray, params: dict,
              cot: np.ndarray, mesh=None) -> dict:
    """``block_call(name)`` on ``x`` and ``params`` (this rank's stored
    shards under ``mesh``, placed by the sharding rules on the paths
    ``params`` names; whole without a mesh): its output, and the gradients
    of sum(out · cot) (+ the aux losses) of x and of each parameter leaf."""
    fn = block_call(name, kwargs)
    local, tree = {}, {}
    for path, arr in params.items():
        names = path.split("/")
        if mesh is not None:
            arr = arr[shd.local_slices(_block_spec(path, arr.shape, mesh), arr.shape, mesh)]
        local[path] = torch.tensor(np.ascontiguousarray(arr), requires_grad=True)
        node = tree                       # the block's tree: the path past its name
        for key in names[1:-1]:
            node = node.setdefault(key, {})
        node[names[-1]] = local[path]
    xt = torch.from_numpy(x)
    if xt.is_floating_point():
        xt.requires_grad_(True)
    ctx = mesh_ctx.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        out, aux = fn(xt, tree)
        loss = (out.float() * torch.from_numpy(cot)).sum()
        if aux is not None:
            loss = loss + 0.37 * sum(aux.values())
        leaves = list(local.values()) + ([xt] if xt.requires_grad else [])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = list(params) + (["x"] if xt.requires_grad else [])
    return {"out": out.detach().numpy().copy(),
            "grads": {n: (None if g is None else g.numpy().copy())
                      for n, g in zip(names, grads)}}


def job_blocks(mesh, cases: list[dict]) -> list[dict]:
    """Each case through :func:`run_block` on this rank's stored shards;
    with each leaf's slice bounds."""
    out = []
    for case in cases:
        res = run_block(mesh=mesh, **case)
        res["slices"] = {}
        for path, arr in case["params"].items():
            spec = _block_spec(path, arr.shape, mesh)
            res["slices"][path] = [(s.start, s.stop)
                                   for s in shd.local_slices(spec, arr.shape, mesh)]
        out.append(res)
    return out


def job_forward(mesh, cases: list[dict]) -> list[np.ndarray]:
    """Each case's ``transformer.forward`` (the logits) on this rank's
    stored shards of a whole numpy parameter tree."""
    from repro_torch.models.transformer import forward
    out = []
    for case in cases:
        cfg = get_smoke(case["arch"], **case["overrides"])
        params = to_torch(case["params"])
        local = tree_map(lambda leaf, spec: leaf[shd.local_slices(spec, leaf.shape, mesh)],
                         params, shd.params_shardings(params, mesh))
        with mesh_ctx.set_mesh(mesh), torch.no_grad():
            out.append(forward(cfg, local, to_torch(case["batch"])).numpy().copy())
    return out


def job_placements(mesh, arrays: dict[str, tuple]) -> dict:
    """Each (array, spec entries) distributed by its spec: this rank's local
    chunk, its local_slices and the gathered full tensor."""
    out = {}
    for name, (arr, entries) in arrays.items():
        spec = shd.Spec(tuple(tuple(e) if isinstance(e, list) else e for e in entries))
        dt = shd.distribute(torch.from_numpy(arr), spec, mesh)
        sl = shd.local_slices(spec, arr.shape, mesh)
        full = torch.zeros_like(torch.from_numpy(arr))
        full[sl] = dt.to_local()
        shd.gather_shards(full, spec, mesh)
        out[name] = {"local": dt.to_local().numpy(),
                     "slices": [(s.start, s.stop) for s in sl],
                     "full": dt.full_tensor().numpy(), "gathered": full.numpy(),
                     "coords": {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}}
    return out


def job_ragged(mesh, x: np.ndarray, params: dict, cot: np.ndarray,
               cfg_args: dict, aux_weight: float) -> dict:
    """moe_ragged_sharded on this rank's data shard of ``x`` (B, S, d) and
    its model slice of the experts: the output, the aux losses, and the
    gradients of sum(out * cot) + aux_weight · Σ aux of x, the router and
    the expert slices."""
    from repro_torch.models.moe import moe_ragged_sharded
    with mesh_ctx.set_mesh(mesh):
        n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
        m, j = mesh_ctx.axis_size("model"), mesh.get_local_rank("model")
        f = params["wo"].shape[1] // m
        local = {"router": params["router"],
                 "wi_gate": params["wi_gate"][:, :, j * f:(j + 1) * f],
                 "wi_up": params["wi_up"][:, :, j * f:(j + 1) * f],
                 "wo": params["wo"][:, j * f:(j + 1) * f, :]}
        p = {k: torch.tensor(np.ascontiguousarray(v), requires_grad=True)
             for k, v in local.items()}
        xs = torch.tensor(rank_rows({"x": x}, i, n)["x"], requires_grad=True)
        out, aux = moe_ragged_sharded(xs, p, moe_d_ff=params["wo"].shape[1],
                                      **cfg_args)
        cot_local = torch.from_numpy(rank_rows({"c": cot}, i, n)["c"])
        loss = (out.float() * cot_local).sum() + aux_weight * sum(aux.values())
        grads = torch.autograd.grad(loss, [xs, *p.values()])
    return {"out": out.detach().numpy(), "aux": {k: float(v) for k, v in aux.items()},
            "grads": dict(zip(["x", *p], (g.numpy() for g in grads))),
            "data": i, "model": j}


def job_elastic(mesh, arch: str, state: dict | None, ckpt_dir: str,
                save_step: int | None, batches: list[dict]) -> dict:
    """Restore the latest checkpoint of ``ckpt_dir`` onto this mesh (or, with
    ``state``, start from it), run a step on each global batch, and with
    ``save_step`` save after the first ``save_step`` steps.  Returns each
    step's loss and the restored step."""
    from repro_torch.train.step import (
        distribute_state, init_train_state, make_train_step,
    )
    cfg = get_smoke(arch, compute_dtype="float32")
    step = make_train_step(cfg, optimizer())
    if state is not None:
        st = distribute_state(to_torch(state), mesh)
    else:
        gen = torch.Generator()
        gen.manual_seed(123)       # other values: the restore must replace them
        target = init_train_state(cfg, optimizer(), gen, mesh)
        with mesh_ctx.set_mesh(mesh):
            st = ckpt.restore(target, ckpt_dir,
                              shardings=shd.state_shardings(target, mesh))
    restored = int(st["step"].to_local())
    with mesh_ctx.set_mesh(mesh):
        n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
    losses = []
    for k, batch in enumerate(batches):
        st, m = step(st, to_torch(rank_rows(batch, i, n)))
        losses.append(float(m["loss"]))
        if save_step is not None and k + 1 == save_step:
            ckpt.save(st, ckpt_dir, int(st["step"].to_local()))
    return {"losses": losses, "restored_step": restored}


def job_launch_train(mesh, argv: list[str]) -> dict:
    """``launch.train.main`` under the running group (which it reuses and
    leaves running)."""
    from repro_torch.launch import train
    out = train.main(argv)
    return {"metrics": {k: v for k, v in out.items() if isinstance(v, float)},
            "steps_run": out["steps_run"], "group_alive": dist.is_initialized(),
            "world": dist.get_world_size()}


def job_decode(mesh, cases: list[dict]) -> list[dict]:
    """Each case: ``decode_step`` under the mesh on this rank's stored
    shards of a whole numpy parameter tree and its shards of a cache made
    by ``init_cache`` with the mesh, teacher-forced on ``tokens`` (steps,
    B) (this rank's rows).  Returns each step's logits (this rank's
    columns), the cache leaves with their slices in the whole cache after
    the last step, the cache view, and the collective bytes by kind a
    step."""
    from repro_torch.models.transformer import decode_step, init_cache
    out = []
    for case in cases:
        cfg = get_smoke(case["arch"], **case["overrides"])
        params = to_torch(case["params"])
        local = tree_map(lambda leaf, spec: leaf[shd.local_slices(spec, leaf.shape, mesh)],
                         params, shd.params_shardings(params, mesh))
        tokens = torch.from_numpy(case["tokens"].astype(np.int64))
        batch = tokens.shape[1]
        cache = init_cache(cfg, batch, case["max_len"], case["cache_dtype"], "cpu", mesh)
        whole = init_cache(cfg, batch, case["max_len"], case["cache_dtype"], "meta")
        with mesh_ctx.set_mesh(mesh):
            n, i = mesh_ctx.dp_size(), mesh_ctx.dp_index()
            j = mesh_ctx.model_rank()
        rows = slice(i * (batch // n), (i + 1) * (batch // n))
        logits, moved = [], []
        with mesh_ctx.set_mesh(mesh), torch.no_grad():
            for t in range(tokens.shape[0]):
                sent = {}

                def listen(event, kind, axis, nbytes, sent=sent):
                    if event == events.COLLECTIVE:
                        sent[kind] = sent.get(kind, 0) + nbytes

                with events.counting(listen):
                    lg, cache = decode_step(cfg, local, cache, tokens[t, rows, None])
                logits.append(lg.float().numpy().copy())
                moved.append(sent)
        specs = shd.cache_shardings(whole, mesh)
        leaves = {}
        for (path, leaf), spec, w in zip(bridge.flatten(cache).items(),
                                         shd.spec_leaves(specs),
                                         bridge.flatten(whole).values()):
            if not isinstance(leaf, torch.Tensor):
                continue
            leaves[path] = (leaf.float().numpy().copy(),
                            [(s.start, s.stop) for s in
                             shd.local_slices(spec, w.shape, mesh)])
        out.append({"logits": logits, "cache": leaves, "pos": cache["pos"],
                    "moved": moved, "model": j, "data": i,
                    "view": shd.cache_view(cfg, mesh_ctx.axis_size("model", mesh), j)})
    return out


def job_counted(mesh, cells: list[dict]) -> list[dict]:
    """Each cell (an arch's smoke config with the dry run's settings and a
    ``ShapeConfig``'s fields): the dry run's step built on this rank's
    shards as zeros on the CPU and run under its cost counter; returns the
    counter's summary."""
    from repro_torch.launch import costs, dryrun
    from repro_torch.models.config import ShapeConfig
    out = []
    for cell in cells:
        cfg = dryrun.cell_config(cell["arch"], smoke=True, overrides=cell.get("overrides"))
        fn, _ = dryrun.build_step(cfg, ShapeConfig(*cell["shape"]), mesh, "cpu")
        counter = costs.Counter("cpu")
        with counter:
            fn()
        out.append(counter.summary())
    return out


JOBS = {"dp": job_dp, "tp": job_tp, "refusals": job_refusals,
        "microbatches": job_microbatches, "step_collectives": job_step_collectives,
        "collectives": job_collectives, "blocks": job_blocks, "forward": job_forward,
        "placements": job_placements, "ragged": job_ragged,
        "elastic": job_elastic, "launch_train": job_launch_train,
        "decode": job_decode, "counted": job_counted}


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Job:
    name: str
    kwargs: dict
    mesh_shape: tuple[int, ...] = ()
    axes: tuple[str, ...] = ("data", "model")


def _rank(rank: int, world: int, init_file: str, out_dir: str,
          jobs: list[Job]) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        results = []
        for job in jobs:
            shape = job.mesh_shape or (world, 1)
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=job.axes)
            results.append(JOBS[job.name](mesh, **job.kwargs))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, jobs: list[Job], tmp: Path) -> list[list[Any]]:
    """Run ``jobs`` in order in ``world`` spawned gloo ranks; returns
    ``results[rank][job]``."""
    tmp.mkdir(parents=True, exist_ok=True)
    init_file = tmp / "store"
    mp.start_processes(_rank, args=(world, str(init_file), str(tmp), jobs),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
