"""The port's data-parallel layer on the CPU: gloo ranks spawned with
``torch.multiprocessing`` (``tests/torch_mesh_worker.py``, which imports no
jax), against one process on the concatenated batch and against the JAX
package's ``make_train_step`` on it.

Every case runs at an fp32 ``compute_dtype`` from weights made by the JAX
init and handed over as numpy; the global batches are numpy from seeds.
Two spawns (2 and 4 ranks) and two one-rank groups in this process cover:

* the DP step at data 2 and 4 for three steps: gemma3-1b, mamba2-780m,
  olmoe-1b-7b (einsum dispatch at a capacity factor of 0.5, so tokens drop
  and the queue offsets across ranks matter, with ``moe_groups`` 1 and equal
  to the data size) and internvl2-26b (patch labels -100 and more masked
  labels on the first rows, so the ranks' label counts differ): loss, ce,
  the aux losses and ``grad_norm`` after each step, the parameters after
  each step, and each rank's ZeRO-1 shards of m, v and master against the
  matching slices of the one-process tree;
* the same at ``n_micro`` 2 (gemma3-1b, olmoe-1b-7b at ``moe_groups`` 1,
  internvl2-26b) on global batches of 8 rows, against one process and JAX
  at ``n_micro`` 2: microbatch i is block i of the global batch, so each
  rank's share of it comes by an all-to-all (``dp_microbatches``, checked
  row by row at data 2 and 4, (2, 2) and (pod 2, data 2)); the grouping in
  which each rank splits its own rows is shown to miss the reference
  (olmoe's load balance and drops, internvl2's label counts); ``n_micro``
  1 posts no all-to-all, and one data rank is the reshape, bit for bit;
* ``moe_ragged_sharded`` at (data, model) = (1, 2) and (2, 2), forward and
  gradients, against JAX's ``moe_sorted_local`` on each data shard;
* placements: each rank's DTensor chunk is the numpy slice the spec names,
  and the in-place gather restores the whole;
* elastic checkpoints, 1 → 2 and 2 → 1 ranks, resuming with the unbroken
  run's loss; ``launch.train.main`` under two ranks, also at ``--n-micro``
  2.

Tolerances, fixed up front (fp32, summation order only): metrics to 2e-5
relative (the aux losses and ``dropped`` also 1e-7 absolute); m and v to
2e-5 of the leaf's largest element; parameters and master to 2e-5 of the
leaf's largest element wherever the one-process run's m has been settled
at every step so far (above 1e-3 of its leaf's largest and above 1e-6):
Adam moves a weight by about lr·g/(|g| + eps), so a gradient at rounding
level, or near eps, may move it by any amount up to lr.  At ``n_micro`` 2
the parameters, m, v and master are held at R = max(2e-5, 4 × the case's
own sensitivity), as tests/test_torch_tp.py holds its cases: the largest
relative change of any m or v of the one-process run after a one-ulp
perturbation of its starting state, over three draws (gemma3-1b 9.7e-5,
olmoe-1b-7b 4.9e-5, internvl2-26b 1.7e-5: two microbatches carry fp32
rounding past 2e-5, which no summation order of the data-parallel step
can be held to).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models.moe import moe_sorted_local as jmoe_sorted_local  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.train.step import (  # noqa: E402
    TrainStepConfig as JTrainStepConfig, make_train_step as jmake_train_step,
)

import torch_mesh_worker as worker  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.train.step import TrainStepConfig, make_train_step  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

RTOL = 2e-5
AUX_ATOL = 1e-7
SETTLED = 1e-3
SETTLED_M = 1e-6
STEPS = 3
BATCH, SEQ = 4, 32
DATA_SIZES = (2, 4)
#: a vocabulary of 4096 makes the (V, d) tables 1 MiB, the ZeRO-1 threshold:
#: their m, v and master shard over data (the other smoke leaves are smaller)
V = {"vocab_size": 4096}
CASES = {
    "gemma3": ("gemma3-1b", V, {}),
    "mamba2": ("mamba2-780m", V, {}),
    "olmoe_g1": ("olmoe-1b-7b", {**V, "capacity_factor": 0.5}, {"moe_groups": 1}),
    "olmoe_gdata": ("olmoe-1b-7b", {**V, "capacity_factor": 0.5},
                    {"moe_groups": "data"}),
    "internvl2": ("internvl2-26b", V, {}),
}
#: microbatches that span the data ranks, on global batches of 8 rows
MICRO_CASES = {
    "gemma3_micro2": ("gemma3-1b", V, {"n_micro": 2}),
    "olmoe_g1_micro2": ("olmoe-1b-7b", {**V, "capacity_factor": 0.5},
                        {"moe_groups": 1, "n_micro": 2}),
    "internvl2_micro2": ("internvl2-26b", V, {"n_micro": 2}),
}
#: the cases whose grouping of rows into microbatches the reference's
#: numbers tell apart (not gemma3's: every label counts, so a grouping
#: moves only the rounding)
GROUPING_CASES = ("olmoe_g1_micro2", "internvl2_micro2")
ALL_CASES = {**CASES, **MICRO_CASES}
#: dp_microbatches' cases: (n_micro, rows a rank holds of a microbatch)
MICRO_ROWS = [(1, 2), (2, 1), (2, 3), (3, 1), (4, 2), (6, 1)]
#: the MICRO_CASES' bound on parameters, m, v and master, relative to each
#: leaf's largest element: R = max(RTOL, SENSITIVITY x the case's own
#: sensitivity, _sensitivity), as tests/test_torch_tp.py bounds its cases
SENSITIVITY = 4
ELASTIC_ARCH = "gemma3-1b"
RAGGED = dict(n_experts=8, top_k=2, act="silu", router_renorm=False,
              compute_dtype="float32")
RAGGED_AUX_WEIGHT = 0.37


def _rows(step_cfg):
    """A case's global batch: BATCH rows a microbatch."""
    return BATCH * step_cfg.get("n_micro", 1)


def _batch(cfg, seed, rows=BATCH):
    """A global (rows, SEQ) batch as numpy; internvl2's first rows carry
    more -100 labels than the others."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "mixed":
        npatch = min(cfg.n_patches, SEQ // 2)
        toks = rng.integers(0, cfg.vocab_size, (rows, SEQ - npatch))
        labels = np.concatenate([np.full((rows, npatch), -100),
                                 np.roll(toks, -1, axis=1)], axis=1)
        labels[0, :24] = -100
        labels[1, 10:20] = -100
        return {"tokens": toks.astype(np.int32),
                "patch_embeds": (rng.standard_normal((rows, npatch, cfg.d_model))
                                 * 0.1).astype(np.float32),
                "labels": labels.astype(np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (rows, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _state(arch, overrides):
    """(JAX config, whole numpy train state from the JAX init)."""
    jcfg = jget_smoke(arch, compute_dtype="float32", **overrides)
    params = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0)))
    jopt = JAdamW(schedule=jcosine(worker.LR, 2, 10))
    state = jax.device_get({"params": params, "opt": jopt.init(params),
                            "step": np.zeros((), np.int32)})
    return jcfg, jopt, state


def _step_cfg(step_cfg, data):
    return {k: (data if v == "data" else v) for k, v in step_cfg.items()}


def _one_process(arch, overrides, step_cfg, state, batches):
    """The port without a mesh on the global batches: each step's metrics,
    parameters, and the whole m, v, master after the last."""
    cfg = get_smoke(arch, compute_dtype="float32", **overrides)
    step = make_train_step(cfg, worker.optimizer(), TrainStepConfig(**step_cfg))
    st = worker.to_torch(state)
    metrics, params, settled = [], [], []
    for batch in batches:
        st, m = step(st, worker.to_torch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
        params.append({k: v.detach().numpy().copy()
                       for k, v in bridge.flatten(st["params"]).items()})
        now = {k: np.abs(v.numpy()) > max(SETTLED * np.abs(v.numpy()).max(), SETTLED_M)
               for k, v in bridge.flatten(st["opt"]["m"]).items()}
        settled.append({k: v & settled[-1][k] if settled else v for k, v in now.items()})
    opt = {f"{key}/{k}": v.numpy() for key in ("m", "v", "master")
           for k, v in bridge.flatten(st["opt"][key]).items()}
    return {"metrics": metrics, "params": params, "opt": opt, "settled": settled}


def _sensitivity(arch, overrides, step_cfg, state, batches, port, draws=3):
    """A case's own sensitivity: the largest change, relative to its leaf's
    largest element, of any m or v of the one-process run after a one-ulp
    perturbation (a random sign) of every float of its starting state, the
    largest over ``draws`` draws."""
    def ulp(rng):
        def one(x):
            x = np.asarray(x)
            if x.dtype != np.float32 or not x.ndim:
                return x
            return (x * (1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -23)
                    ).astype(np.float32)
        return one

    worst = 0.0
    for seed in range(draws):
        moved = _one_process(arch, overrides, step_cfg,
                             tree_map(ulp(np.random.default_rng(seed)), state), batches)
        worst = max([worst] + [np.abs(moved["opt"][k] - v).max() / max(np.abs(v).max(), 1e-30)
                               for k, v in port["opt"].items()
                               if k.split("/")[0] in ("m", "v")])
    return worst


def _jax(jcfg, jopt, step_cfg, state, batches):
    step = jax.jit(jmake_train_step(jcfg, jopt, JTrainStepConfig(**step_cfg)))
    metrics = []
    for batch in batches:
        state, m = step(state, {k: jax.numpy.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _in_one_rank_group(fn, tmp):
    """``fn(mesh)`` in a one-rank gloo group of this process, torn down
    after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'one_rank_store'}",
                            rank=0, world_size=1)
    try:
        return fn(init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


def _ragged_inputs():
    rng = np.random.default_rng(7)
    e, d, f = RAGGED["n_experts"], 64, 32
    # inputs with a mean along which expert 0's router column points: most
    # tokens choose it, so its queue passes Cl (128) and rows drop
    router = rng.standard_normal((d, e)).astype(np.float32) * 0.5
    router[:, 0] += 0.3
    params = {"router": router,
              "wi_gate": rng.standard_normal((e, d, f)).astype(np.float32) * 0.1,
              "wi_up": rng.standard_normal((e, d, f)).astype(np.float32) * 0.1,
              "wo": rng.standard_normal((e, f, d)).astype(np.float32) * 0.1}
    x = rng.standard_normal((4, 128, d)).astype(np.float32) + 0.3
    cot = rng.standard_normal((4, 128, d)).astype(np.float32)
    return x, params, cot


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run of the module, and the references, once."""
    tmp = tmp_path_factory.mktemp("mesh")
    refs, dp_jobs = {}, {data: [] for data in DATA_SIZES}
    for name, (arch, overrides, step_cfg) in ALL_CASES.items():
        cfg = get_smoke(arch, **overrides)
        batches = [_batch(cfg, seed, _rows(step_cfg)) for seed in range(STEPS)]
        jcfg, jopt, state = _state(arch, overrides)
        for data in DATA_SIZES:
            sc = _step_cfg(step_cfg, data)
            key = (name, data)
            ref_key = (name, sc.get("moe_groups", 1))
            if ref_key not in refs:
                refs[ref_key] = {
                    "port": _one_process(arch, overrides, sc, state, batches),
                    "jax": _jax(jcfg, jopt, sc, state, batches)}
                if name in MICRO_CASES:
                    refs[ref_key]["sensitivity"] = _sensitivity(
                        arch, overrides, sc, state, batches, refs[ref_key]["port"])
            dp_jobs[data].append({"key": key, "arch": arch,
                                  "overrides": {"compute_dtype": "float32", **overrides},
                                  "step_cfg": sc, "state": state, "batches": batches})

    # elastic: 1 rank saves after 2 steps, then 2 ranks resume from it; 2 ranks
    # save, then 1 rank resumes
    e_cfg = get_smoke(ELASTIC_ARCH)
    _, _, e_state = _state(ELASTIC_ARCH, {})
    e_batches = [_batch(e_cfg, 10 + seed) for seed in range(STEPS)]
    one_dir, two_dir = tmp / "ckpt_from_1", tmp / "ckpt_from_2"
    elastic = {"from_1": _in_one_rank_group(lambda mesh: worker.job_elastic(
        mesh, ELASTIC_ARCH, e_state, str(one_dir), 2, e_batches), tmp)}

    x, rparams, cot = _ragged_inputs()
    ragged_args = dict(x=x, params=rparams, cot=cot, cfg_args=RAGGED,
                       aux_weight=RAGGED_AUX_WEIGHT)
    Job = worker.Job
    two = worker.spawn(2, [
        Job("dp", {"cases": [{k: v for k, v in c.items() if k != "key"}
                             for c in dp_jobs[2]]}),
        Job("ragged", ragged_args, (1, 2)),
        Job("elastic", dict(arch=ELASTIC_ARCH, state=None, ckpt_dir=str(one_dir),
                            save_step=None, batches=e_batches[2:])),
        Job("elastic", dict(arch=ELASTIC_ARCH, state=e_state, ckpt_dir=str(two_dir),
                            save_step=2, batches=e_batches)),
        Job("launch_train", dict(argv=[
            "--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--log-every", "1",
            "--ckpt-dir", str(tmp / "launch")])),
        Job("refusals", {}),
        Job("microbatches", {"cases": MICRO_ROWS}),
        Job("step_collectives", {"n_micros": [1, 2]}),
        Job("launch_train", dict(argv=[
            "--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--log-every", "1", "--n-micro", "2"])),
    ], tmp / "two")
    elastic["to_1"] = _in_one_rank_group(lambda mesh: worker.job_elastic(
        mesh, ELASTIC_ARCH, None, str(two_dir), None, e_batches[2:]), tmp)

    arrays = {False: _placement_arrays(False), True: _placement_arrays(True)}
    four = worker.spawn(4, [
        Job("dp", {"cases": [{k: v for k, v in c.items() if k != "key"}
                             for c in dp_jobs[4]]}),
        Job("ragged", ragged_args, (2, 2)),
        Job("placements", {"arrays": arrays[False]}, (2, 2)),
        Job("placements", {"arrays": arrays[True]}, (2, 2, 1), ("pod", "data", "model")),
        Job("microbatches", {"cases": MICRO_ROWS}),
        Job("microbatches", {"cases": MICRO_ROWS}, (2, 2)),
        Job("microbatches", {"cases": MICRO_ROWS}, (2, 2, 1), ("pod", "data", "model")),
    ], tmp / "four")
    dp = {}
    for data, results in ((2, two), (4, four)):
        for i, case in enumerate(dp_jobs[data]):
            dp[case["key"]] = [r[0][i] for r in results]
    return {"dp": dp, "refs": refs, "two": two, "four": four, "elastic": elastic,
            "arrays": arrays, "ragged_inputs": (x, rparams, cot),
            "batches": {name: [_batch(get_smoke(a, **o), seed, _rows(sc)) for seed in range(STEPS)]
                        for name, (a, o, sc) in ALL_CASES.items()}}


def _ref(runs, name, data):
    sc = _step_cfg(ALL_CASES[name][2], data)
    return runs["refs"][(name, sc.get("moe_groups", 1))]


def _assert_metrics(got, want, keys):
    for k in keys:
        if k in ("load_balance", "router_z", "dropped"):
            assert got[k] == pytest.approx(want[k], rel=RTOL, abs=AUX_ATOL), k
        else:
            assert got[k] == pytest.approx(want[k], rel=RTOL), k


@pytest.mark.parametrize("data", DATA_SIZES)
@pytest.mark.parametrize("name", CASES)
def test_dp_metrics_match_one_process_and_jax(runs, name, data):
    """Every step's loss, ce, aux losses, grad_norm and lr, on every rank,
    against one process and JAX on the concatenated batch."""
    _metrics_match(runs, name, data)


def _metrics_match(runs, name, data):
    """test_dp_metrics_match_one_process_and_jax's checks."""
    ref = _ref(runs, name, data)
    for rank in runs["dp"][(name, data)]:
        assert rank["step"] == STEPS
        for step in range(STEPS):
            got = rank["metrics"][step]
            assert set(got) == set(ref["jax"][step])
            _assert_metrics(got, ref["port"]["metrics"][step], got)
            _assert_metrics(got, ref["jax"][step], got)


@pytest.mark.parametrize("data", DATA_SIZES)
@pytest.mark.parametrize("name", CASES)
def test_dp_params_and_zero1_shards_match_one_process(runs, name, data):
    """The replicated parameters after every step (the same bits on every
    rank), and each rank's m, v and master shard against the matching slice
    of the one-process tree; the shards of a large leaf really split."""
    _params_and_shards_match(runs, name, data, RTOL)


@pytest.mark.parametrize("data", DATA_SIZES)
@pytest.mark.parametrize("name", MICRO_CASES)
def test_dp_micro_metrics_match_one_process_and_jax(runs, name, data):
    """At n_micro = 2: every step's loss, ce, aux losses (the last
    microbatch's), grad_norm and lr, on every rank, within RTOL of one
    process and of JAX's make_train_step(n_micro=2) on the global batch."""
    _metrics_match(runs, name, data)


@pytest.mark.parametrize("data", DATA_SIZES)
@pytest.mark.parametrize("name", MICRO_CASES)
def test_dp_micro_params_and_zero1_shards_match_one_process(runs, name, data):
    """At n_micro = 2: the parameters after every step (the same bits on
    every rank) and each rank's m, v and master shards against the
    one-process tree, within R = max(RTOL, SENSITIVITY x the case's own
    sensitivity) of each leaf's largest element."""
    refs = _ref(runs, name, data)
    rel = max(RTOL, SENSITIVITY * refs["sensitivity"])
    _params_and_shards_match(runs, name, data, rel)


def _params_and_shards_match(runs, name, data, rel):
    """The parameters' and the ZeRO-1 shards' checks of
    test_dp_params_and_zero1_shards_match_one_process, relative to each
    leaf's largest element at ``rel``."""
    ref = _ref(runs, name, data)["port"]
    ranks = runs["dp"][(name, data)]
    split = 0
    for rank in ranks:
        for step in range(STEPS):
            settled = ref["settled"][step]
            for key, want in ref["params"][step].items():
                got = rank["params"][step][key]
                np.testing.assert_array_equal(got, ranks[0]["params"][step][key])
                err = np.abs(got - want)[settled[key]]
                assert err.max(initial=0) <= rel * np.abs(want).max(), (key, step)
        for key, (local, bounds) in rank["shards"].items():
            part, path = key.split("/", 1)
            sl = tuple(slice(a, b) for a, b in bounds)
            want = ref["opt"][key][sl]
            assert local.shape == want.shape, key
            split += local.size < ref["opt"][key].size
            scale = max(np.abs(ref["opt"][key]).max(), 1e-30)
            err = np.abs(local - want)
            if part == "master":
                err = err[ref["settled"][-1][path][sl]]
            assert err.max(initial=0) <= rel * scale, key
    assert split > 0


def test_dp_shards_tile_each_leaf(runs):
    """At data 4 the ranks' ZeRO-1 slices of a sharded leaf are disjoint and
    cover it."""
    ranks = runs["dp"][("gemma3", 4)]
    ref = _ref(runs, "gemma3", 4)["port"]["opt"]
    for key, full in ref.items():
        cover = np.zeros(full.shape, np.int64)
        for rank in ranks:
            cover[tuple(slice(a, b) for a, b in rank["shards"][key][1])] += 1
        assert (cover == 1).all() or (cover == len(ranks)).all(), key


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_ragged_sharded_matches_sorted_local_per_shard(runs, mesh):
    """moe_ragged_sharded at (data, model) against JAX's moe_sorted_local on
    each data shard with the whole experts: the output and aux on every
    rank, and the gradients of sum(out·cot) + w·Σaux/D: of x summed over
    model (Megatron's f), of the router, and of each rank's expert slice."""
    x, params, cot = runs["ragged_inputs"]
    results = runs["two"] if mesh == "1x2" else runs["four"]
    ranks = [r[1] for r in results]
    n_data = 1 if mesh == "1x2" else 2
    jparams = {k: jax.numpy.asarray(v) for k, v in params.items()}
    for rank in ranks:
        i, j = rank["data"], rank["model"]
        rows = slice(i * (x.shape[0] // n_data), (i + 1) * (x.shape[0] // n_data))
        xs = jax.numpy.asarray(x[rows])

        def loss(xs, p):
            b, s, d = xs.shape
            out, aux = jmoe_sorted_local(xs.reshape(b * s, d), p, **{
                **RAGGED, "compute_dtype": jax.numpy.float32})
            return ((out.reshape(b, s, d) * cot[rows]).sum()
                    + RAGGED_AUX_WEIGHT * sum(aux.values()) / n_data), (out, aux)

        (_, (out, aux)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1),
                                                       has_aux=True)(xs, jparams)
        np.testing.assert_allclose(rank["out"], np.asarray(out).reshape(rank["out"].shape),
                                   rtol=RTOL, atol=RTOL)
        for k, v in aux.items():
            assert rank["aux"][k] * n_data == pytest.approx(float(v), rel=RTOL, abs=AUX_ATOL)
        f = params["wo"].shape[1] // 2
        want = {"x": np.asarray(gx), "router": np.asarray(gp["router"]),
                "wi_gate": np.asarray(gp["wi_gate"])[:, :, j * f:(j + 1) * f],
                "wi_up": np.asarray(gp["wi_up"])[:, :, j * f:(j + 1) * f],
                "wo": np.asarray(gp["wo"])[:, j * f:(j + 1) * f, :]}
        for k, w in want.items():
            scale = np.abs(w).max()
            assert np.abs(rank["grads"][k] - w).max() <= RTOL * scale, k
    assert any(r["aux"]["dropped"] > 0 for r in ranks)


def _placement_arrays(pod):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 12, 6)).astype(np.float32)
    return {"dp_dim1": (a, [None, ["pod", "data"] if pod else "data"]),
            "data_dim0_model_dim2": (a, ["data", None, "model"]),
            "data_dim2": (a, [None, None, "data"]),
            "replicated": (a, [])}


def _expected_slice(shape, entries, coords, sizes):
    out = []
    for dim, size in enumerate(shape):
        entry = entries[dim] if dim < len(entries) else None
        axes = [] if entry is None else ([entry] if isinstance(entry, str) else entry)
        axes = [a for a in axes if a in sizes]
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        out.append(slice(idx * size // n, (idx + 1) * size // n))
    return tuple(out)


@pytest.mark.parametrize("mesh", ["2x2", "2x2x1"])
def test_placements_give_each_rank_its_numpy_slice(runs, mesh):
    """Each rank's DTensor chunk is the numpy slice that the spec names
    (("pod", "data") nested pod-major), local_slices says the same, and both
    the gather in place and full_tensor give back the whole array."""
    job = 2 if mesh == "2x2" else 3
    sizes = ({"data": 2, "model": 2} if mesh == "2x2"
             else {"pod": 2, "data": 2, "model": 1})
    for rank in runs["four"]:
        for name, out in rank[job].items():
            arr, entries = runs["arrays"][mesh != "2x2"][name]
            sl = _expected_slice(arr.shape, entries, out["coords"], sizes)
            np.testing.assert_array_equal(out["local"], arr[sl])
            assert [(s.start, s.stop) for s in sl] == out["slices"]
            np.testing.assert_array_equal(out["full"], arr)
            np.testing.assert_array_equal(out["gathered"], arr)


def test_elastic_restore_resumes_the_unbroken_run(runs):
    """Saved at data 1, resumed at data 2, and the other way round: the
    resumed step's loss is the unbroken run's, and the resumed step number
    is the saved one."""
    e = runs["elastic"]
    for rank in runs["two"]:
        resumed = rank[2]
        assert resumed["restored_step"] == 2
        assert resumed["losses"][0] == pytest.approx(e["from_1"]["losses"][2], rel=RTOL)
    unbroken_two = runs["two"][0][3]["losses"]
    assert e["to_1"]["restored_step"] == 2
    assert e["to_1"]["losses"][0] == pytest.approx(unbroken_two[2], rel=RTOL)
    # the two unbroken runs agree too: DP is the single program
    np.testing.assert_allclose(unbroken_two, e["from_1"]["losses"], rtol=RTOL)


def test_launch_train_runs_under_two_ranks(runs):
    """launch.train.main in two ranks of a running group: both ranks finish
    with the same finite loss, and the group is left running.  Its steps
    are not graphed (``graphed`` False): on the CPU no step is, and a mesh
    whose data axis runs over gloo could not be captured on a card either
    (``uncapturable`` names the axis and the backend)."""
    outs = [rank[4] for rank in runs["two"]]
    for out in outs:
        assert out["steps_run"] == 2 and out["group_alive"] and out["world"] == 2
        assert np.isfinite(out["metrics"]["loss"])
        assert out["metrics"]["loss"] == outs[0]["metrics"]["loss"]
        assert out["graphed"] is False
        assert "data axis of 2 ranks" in out["uncapturable"]
        assert "over gloo" in out["uncapturable"]


@pytest.mark.parametrize("arch,world,message", [
    ("olmoe-1b-7b", 1, r"needs ~201\.5 GB a device at a data size of 1 .* it fits at a "
                       r"data size of 8 \(torchrun --nproc-per-node 8"),
    ("olmoe-1b-7b", 4, r"needs ~94\.1 GB a device at a data size of 4 .* fits at a "
                       r"data size of 8"),
    ("internvl2-26b", 8, r"no data size fits \(the replicated float32 parameters and "
                         r"gradients alone are 159\.2 GB\); tensor parallelism fits "
                         r"it on 8 cards at \(data 1, model 8\), ~80\.3 GB a device; "
                         r"launch\.train on a \(data, model\) mesh is part 3"),
    ("gemma-7b", 1, r"needs ~232\.9 GB a device at a data size of 1 .* fits at a data "
                    r"size of 16 .*; tensor parallelism fits it on 4 cards at \(data 2, "
                    r"model 2\), ~77\.6 GB a device; scripts/tp_across_cards\.py trains "
                    r"it on 4 cards at \(data 1, model 4\), ~60\.5 GB a device: torchrun "
                    r"--nproc-per-node 4 scripts/tp_across_cards\.py --arch gemma-7b$"),
])
def test_launch_train_reckons_each_device_with_the_data_size(monkeypatch, arch, world,
                                                             message):
    """On a card, launch.train refuses before it builds a mesh or allocates,
    reckoning a device's memory with the data size of the world it runs in
    and naming the data size that fits, or, where none does, the (data,
    model) mesh that would and part 3, which runs it; where that mesh is
    4 cards, fewer than the data size (gemma-7b), the script that trains
    it there and the mesh it takes first, (data 1, model 4)."""
    import types
    from repro_torch.launch import train as train_cli
    monkeypatch.setattr(train_cli, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=85_000_000_000))
    monkeypatch.setattr(train_cli, "local_world", lambda: world)

    def builds(*args, **kwargs):
        raise AssertionError("launch.train went on past the refusal")

    monkeypatch.setattr(train_cli, "make_local_mesh", builds)
    with pytest.raises(SystemExit, match=message):
        train_cli.main(["--arch", arch, "--steps", "1"])


def test_dp_step_refuses_what_part_2_covers(runs):
    """What the mesh step once refused it now runs: n_micro = 2 over two
    data ranks (the reference's microbatch is a block of the global batch,
    which spans ranks) gives one process's numbers on the global batch,
    step by step on every rank; a sequence-parallel spec over another axis
    than model is still refused."""
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state
    cfg = get_smoke("gemma3-1b", compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(cfg, worker.optimizer(), gen)
    step = make_train_step(cfg, worker.optimizer(), TrainStepConfig(n_micro=2))
    want = []
    for batch in worker.refusal_batches(cfg):
        state, m = step(state, worker.to_torch(batch))
        want.append({k: float(v) for k, v in m.items()})
    for rank in runs["two"]:
        got = rank[5]["n_micro"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            _assert_metrics(g, w, g)
    with pytest.raises(NotImplementedError, match="seq_spec"):
        make_train_step(get_smoke("gemma3-1b"), AdamW(schedule=cosine_schedule(1e-3, 2, 10)),
                        TrainStepConfig(seq_spec="data"))


def test_dp_step_refuses_a_batch_that_does_not_split(runs):
    """A global batch of 4 rows at n_micro = 4 over two data ranks (4 is not
    a multiple of 4 x 2): a ValueError naming the rows, n_micro and the
    data ranks, on every rank, before any collective."""
    for rank in runs["two"]:
        message = rank[5]["indivisible"]
        assert message is not None
        assert "global batch of 4 rows" in message and "n_micro=4" in message
        assert "over 2 data ranks" in message and "= 8" in message


def _micro_results(runs, mesh):
    """dp_microbatches' results of every rank on ``mesh``."""
    spawn, job = {"2": ("two", 6), "4": ("four", 4), "2x2": ("four", 5),
                  "2x2x1": ("four", 6)}[mesh]
    return [r[job] for r in runs[spawn]]


@pytest.mark.parametrize("mesh", ["2", "4", "2x2", "2x2x1"])
def test_dp_microbatches_give_each_rank_its_share_of_the_reference_blocks(runs, mesh):
    """Each rank's share of microbatch i is the global rows i·B/n +
    r·B/(n·D) + [0, B/(n·D)) of the reference's reshape, at every (n, rows)
    of MICRO_ROWS, on data 2 and 4, (data 2, model 2) and (pod 2, data 2);
    the bytes reported are the rows that leave the rank, on the axes that
    move them (no all-to-all at n = 1: the reshape)."""
    for rank in _micro_results(runs, mesh):
        for (n, c), res in zip(MICRO_ROWS, rank):
            d, r = res["dp"], res["rank"]
            rows = n * d * c
            whole = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
            want = np.stack([whole[i * (rows // n) + r * c:i * (rows // n) + (r + 1) * c]
                             for i in range(n)])
            np.testing.assert_array_equal(res["got"], want)
            if n == 1:
                assert res["sent"] == {}, (n, c)
                continue
            # over one axis: a piece leaves its rank unless it is that
            # rank's own share; no all-to-all where none leaves any rank
            leave = sum((r * n + s) % d != r for s in range(n)) * c * 3 * 4
            moves = any((q * n + s) % d != q for q in range(d) for s in range(n))
            if mesh != "2x2x1":
                assert res["sent"] == ({"all-to-all data": leave} if moves else {}), (n, c)
            else:
                assert set(res["sent"]) <= {"all-to-all data", "all-to-all pod"}
                assert sum(res["sent"].values()) >= leave


def test_n_micro_one_posts_no_all_to_all(runs):
    """The mesh step at n_micro = 1 over two data ranks moves no rows (its
    collectives are the all-reduces and gathers of the step as it was); at
    n_micro = 2 it adds an all-to-all on data for each batch leaf (tokens
    and labels, int64), each of half a rank's rows (one of its two rows of
    8), and the second microbatch's label count."""
    for rank in runs["two"]:
        one, two = rank[7]
        assert not any(k.startswith("all-to-all") for k in one["collectives"])
        extra = {k: [a - b for a, b in zip(v, one["collectives"].get(k, [0, 0]))]
                 for k, v in two["collectives"].items()}
        assert extra.pop("all-to-all data") == [2, 2 * 8 * 8]
        assert extra == {k: [0, 0] for k in extra} | {"all-reduce data": [1, 8]}


def test_one_data_rank_n_micro_is_the_reshape_bit_for_bit(tmp_path):
    """On a one-rank mesh the step at n_micro = 2 is the step without a mesh
    at n_micro = 2, bit for bit: nothing moves, the microbatches are the
    reshape of the batch."""
    arch, overrides, step_cfg = MICRO_CASES["gemma3_micro2"]
    cfg = get_smoke(arch, **overrides)
    _, _, state = _state(arch, overrides)
    batches = [_batch(cfg, seed, _rows(step_cfg)) for seed in range(2)]
    port = _one_process(arch, overrides, step_cfg, state, batches)
    job = {"arch": arch, "overrides": {"compute_dtype": "float32", **overrides},
           "step_cfg": step_cfg, "state": state, "batches": batches}
    got = _in_one_rank_group(lambda mesh: worker.job_dp(mesh, [job])[0], tmp_path)
    for step in range(2):
        assert got["metrics"][step] == port["metrics"][step]
        for path, want in port["params"][step].items():
            np.testing.assert_array_equal(got["params"][step][path], want)


def _naive_order(rows, data, n):
    """The rows in the order that makes one process's microbatches the
    grouping in which each of ``data`` ranks splits its own block into
    ``n``: microbatch s is every rank's s-th piece."""
    b, c = rows // data, rows // data // n
    return np.concatenate([np.arange(r * b + s * c, r * b + (s + 1) * c)
                           for s in range(n) for r in range(data)])


@pytest.mark.parametrize("data", DATA_SIZES)
@pytest.mark.parametrize("name", GROUPING_CASES)
def test_the_per_rank_grouping_misses_the_reference(runs, name, data):
    """One process at n_micro = 2 on the global batch's rows permuted so
    that each microbatch is every rank's own piece (each rank splitting its
    rows): its first step misses the reference by more than RTOL (olmoe:
    the last microbatch's load balance and drops, from other tokens;
    internvl2: the microbatches' label counts), where the data-parallel
    step at n_micro = 2 meets it; so the parity tests tell the two
    groupings apart."""
    arch, overrides, step_cfg = MICRO_CASES[name]
    batch = runs["batches"][name][0]
    rows = next(iter(batch.values())).shape[0]
    order = _naive_order(rows, data, step_cfg["n_micro"])
    naive = {k: v[order] for k, v in batch.items()}
    _, _, state = _state(arch, overrides)
    got = _one_process(arch, overrides, step_cfg, state, [naive])["metrics"][0]
    want = _ref(runs, name, data)["jax"][0]
    missed = {k: abs(got[k] - want[k]) / max(abs(want[k]), AUX_ATOL)
              for k in want if k != "lr"}
    assert max(missed.values()) > 10 * RTOL, missed
    key = "load_balance" if name.startswith("olmoe") else "ce"
    assert missed[key] > RTOL, missed
    for rank in runs["dp"][(name, data)]:
        _assert_metrics(rank["metrics"][0], want, want)


def test_launch_train_runs_n_micro_under_two_ranks(runs):
    """launch.train.main at --n-micro 2 in two ranks: both ranks finish the
    two steps with the same finite loss."""
    outs = [rank[8] for rank in runs["two"]]
    for out in outs:
        assert out["steps_run"] == 2 and out["group_alive"] and out["world"] == 2
        assert np.isfinite(out["metrics"]["loss"])
        assert out["metrics"]["loss"] == outs[0]["metrics"]["loss"]


def test_meshes_refuse_a_world_of_another_size(monkeypatch):
    """The production meshes want 256 or 512 ranks and a local mesh a model
    axis that divides the world: each raises before it starts a group; with
    no ambient mesh the axis names are empty and the batch is one block."""
    import torch.distributed as dist
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch import mesh as lmesh
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks; the world has 1"):
            lmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        lmesh.make_local_mesh(model=3, device="cpu")
    assert not dist.is_initialized()
    assert mesh_ctx.mesh_axis_names() == () and mesh_ctx.dp_size() == 1
    assert mesh_ctx.dp_index() == 0
