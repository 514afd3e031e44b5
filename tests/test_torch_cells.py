"""The reference's cell options (``launch.dryrun.cell_config``: bf16
parameters, the CE in chunks, a padded vocabulary, streamed query blocks,
the sequence over ``model``) in the mesh step over 2 gloo ranks at (data 1,
model 2), against one process from the same seed and on the same batches,
on the CPU at smoke size (``tests/torch_mesh_worker.py`` ``job_cell``; the
ranks import no jax).

Every case runs at an fp32 ``compute_dtype``, as ``tests/test_torch_tp.py``
does.  Its first step starts from the same bf16 parameters on both sides
and is held to that file's gates where they hold: the loss, CE, aux losses
and lr to 2e-5 relative (the aux losses also 1e-7 absolute); each rank's
fp32 master shard against the one-process master's slice, where that
run's first moment is settled, to 2e-5 of the leaf's largest element plus
1e-3 of the learning rate.  The gradients are bf16 (the parameters'
dtype): the same fp32 gradient summed in another order may round to the
neighbouring bf16 value, 2^-8 of itself away, and a leaf whose gradient
sums over ``model`` (a norm scale on the sequence's shards) is summed from
bf16 partials, each rounded first, which may cancel.  So the gradient
norm is held to 2^-8 relative; m and v to 2^-6 and 2^-5 of their leaf's
largest element (a wrong slice or a sum missed over ``model`` reads 0.5 or
more); the master to 2^-7 of the learning rate more than 2e-5 of the
leaf's largest element and 1e-3 of lr (the rounding carried into
m̂ / √v̂, 2^-8 in m and 2^-9 in √v, a weight moving by lr at most).  Every step's bf16 parameters are each rank's master rounded to
bf16, bit for bit.  The later steps start from those roundings, which may
differ by a bf16 step where the masters straddle a rounding edge: their
loss, CE and gradient norm are held to 5e-3, the bf16 tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh as dp_tests  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch.dryrun import cell_config  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

RTOL, AUX_ATOL, STEP_TOL = 2e-5, 1e-7, 1e-3
BF16_ROUNDING, BF16_TOL, MOMENT_TOL = 2.0 ** -8, 5e-3, 2.0 ** -6
STEPS, BATCH, SEQ, LOSS_CHUNK = 3, 4, 32, 8
#: name: (arch, overrides of the cell options beside the fp32 compute)
CASES = {"gemma3": ("gemma3-1b", {}),
         "olmoe": ("olmoe-1b-7b", {"capacity_factor": 0.5}),
         "qwen2_moe": ("qwen2-moe-a2.7b", {}),
         "internvl2": ("internvl2-26b", {})}


def _case(name):
    arch, overrides = CASES[name]
    return {"arch": arch, "loss_chunk": LOSS_CHUNK, "seed": 3,
            "overrides": {"compute_dtype": "float32", "attn_q_chunk": 16, **overrides}}


def _batches(case):
    cfg = cell_config(case["arch"], True, case["loss_chunk"], case["overrides"])
    rng = np.random.default_rng(5)
    # internvl2's mixed input: its patch embeddings take the first
    # positions, all on the first rank's shard of the sequence, labels -100
    npatch = cfg.n_patches if cfg.input_mode == "mixed" else 0
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ - npatch)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        batch = {"tokens": tokens, "labels": labels}
        if npatch:
            batch["patch_embeds"] = (rng.standard_normal((BATCH, npatch, cfg.d_model))
                                     * 0.1).astype(np.float32)
            batch["labels"] = np.concatenate(
                [np.full((BATCH, npatch), -100, np.int32), labels], axis=1)
        out.append(batch)
    return cfg, out


def _one_process(case, cfg, batches):
    """The step without a mesh from the same seed: each step's metrics, and
    after the first its master, where its m is settled, and its m and v."""
    gen = torch.Generator()
    gen.manual_seed(case["seed"])
    state = init_train_state(cfg, worker.optimizer(), gen)
    step = make_train_step(cfg, worker.optimizer())
    metrics = []
    for i, batch in enumerate(batches):
        state, m = step(state, worker.to_torch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            master = {k: v.numpy().copy()
                      for k, v in bridge.flatten(state["opt"]["master"]).items()}
            settled = {k: np.abs(v.numpy()) > max(
                dp_tests.SETTLED * np.abs(v.numpy()).max(), dp_tests.SETTLED_M)
                for k, v in bridge.flatten(state["opt"]["m"]).items()}
            moments = {f"{key}/{k}": v.numpy().copy() for key in ("m", "v")
                       for k, v in bridge.flatten(state["opt"][key]).items()}
    return {"metrics": metrics, "master": master, "settled": settled,
            "moments": moments}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {name: _case(name) for name in CASES}
    data = {name: _batches(case) for name, case in cases.items()}
    jobs = [{**case, "batches": data[name][1]} for name, case in cases.items()]
    ranks = worker.spawn(2, [worker.Job("cell", {"cases": jobs}, (1, 2))],
                         tmp_path_factory.mktemp("cells"))
    return {name: {"ranks": [r[0][i] for r in ranks],
                   "ref": _one_process(cases[name], *data[name])}
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_the_cell_options_over_two_ranks_match_one_process(runs, name):
    ref = runs[name]["ref"]
    lr = ref["metrics"][0]["lr"]
    split = 0
    for rank in runs[name]["ranks"]:
        assert rank["dtypes"] == ["torch.bfloat16"]
        for k, w in ref["metrics"][0].items():
            atol = AUX_ATOL if k in ("load_balance", "router_z", "dropped") else 0.0
            rel = BF16_ROUNDING if k == "grad_norm" else RTOL
            assert rank["metrics"][0][k] == pytest.approx(w, rel=rel, abs=atol), k
        for step in range(1, STEPS):
            for k in ("loss", "ce", "grad_norm"):
                assert rank["metrics"][step][k] == pytest.approx(
                    ref["metrics"][step][k], rel=BF16_TOL), (k, step)
        for path, (local, bounds) in rank["master"][0].items():
            sl = tuple(slice(a, b) for a, b in bounds)
            whole = ref["master"][path]
            split += local.size < whole.size
            err = np.abs(local - whole[sl])[ref["settled"][path][sl]]
            bound = RTOL * np.abs(whole).max() + (STEP_TOL + 2 * BF16_ROUNDING) * lr
            assert err.max(initial=0) <= bound, path
        for key, (local, bounds) in rank["moments"][0].items():
            sl = tuple(slice(a, b) for a, b in bounds)
            whole = ref["moments"][key]
            bound = MOMENT_TOL * (1 if key.startswith("m/") else 2) * np.abs(whole).max()
            assert np.abs(local - whole[sl]).max() <= bound, key
        for params, master in zip(rank["params"], rank["master"]):
            for path, (local, _) in master.items():
                rounded = torch.from_numpy(local).to(torch.bfloat16).float().numpy()
                assert np.array_equal(params[path][0], rounded), path
    assert split > 0


@pytest.mark.parametrize("name", list(CASES))
def test_the_cell_step_matches_reference(name):
    """The one-process cell step the ranks are held to, against the
    reference's ``make_train_step`` at the same options, from the same
    bf16 parameters (each crossing as fp32, exact) on the same first
    batch: the loss, CE and gradient norm to 5e-3, the bf16 tolerance
    (``tests/test_torch_train.py``'s), the lr to 1e-6."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke as jget_smoke
    from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine
    from repro.train.step import make_train_step as jmake_train_step
    from repro_torch.configs import get_smoke
    case = _case(name)
    cfg, batches = _batches(case)
    smoke = get_smoke(case["arch"])
    jcfg = jget_smoke(case["arch"], **{
        f: getattr(cfg, f) for f in ("loss_chunk", "vocab_pad", "param_dtype",
                                     "attn_q_chunk", "seq_shard", "compute_dtype",
                                     "capacity_factor")
        if getattr(cfg, f) != getattr(smoke, f)})
    gen = torch.Generator()
    gen.manual_seed(case["seed"])
    state = init_train_state(cfg, worker.optimizer(), gen)
    # numpy has no bf16: each leaf crosses as fp32 (exact) and is cast back
    jp = tree_map(lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16), state["params"])
    jopt = JAdamW(schedule=jcosine(worker.LR, 2, 10))
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    _, jm = jax.jit(jmake_train_step(jcfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    _, tm = make_train_step(cfg, worker.optimizer())(state, worker.to_torch(batches[0]))
    for key in ("loss", "ce", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=BF16_TOL), key
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
