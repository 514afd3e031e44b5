"""Tensor parallelism over ``model`` and sequence-parallel activations on
the CPU: gloo ranks spawned with ``torch.multiprocessing``
(``tests/torch_mesh_worker.py``, which imports no jax), against one
process on the concatenated batch and against the JAX package's
``make_train_step`` on it.

Every case runs at an fp32 ``compute_dtype`` from weights made by the JAX
init and handed over as numpy; the global batches are numpy from seeds.
The meshes are (data, model) = (1, 2) and (2, 2), and (1, 4) for
gemma3-1b, olmoe-1b-7b (one head and f 8 a rank) and gemma-7b.  The cases
set the traps of the storage layout on purpose:

* gemma3-1b: MQA, one KV head for 2 query heads, ``qk_norm`` over a
  ``head_dim`` that the rules split mid-head (``wk``, ``wv`` column
  shards); at model 4 its 2 heads do not split and the block runs whole;
  with ``vocab_pad`` and ``loss_chunk``, pad columns on the last ranks;
* mamba2-780m: the packed ``in_proj`` and conv, split across z | x | B | C
  | dt, and the gated norm's sum over ``d_inner``;
* olmoe-1b-7b: the einsum dispatch (capacity factor 0.5, so tokens drop)
  with ``moe_groups`` 1 and equal to the data size, and the ragged one
  (at data 2 held against the data-parallel step, whose
  ``moe_sorted_local`` per rank is the same dispatch);
* hymba-1.5b with 5 query and 5 KV heads: the rules split the heads
  mid-head (40 of 80 columns), the ranks compute 3 and 2 whole heads;
* internvl2-26b with a vocabulary of 129: the odd-vocab fallback (``embed``
  sharded over d, ``lm_head`` whole) and masked patch labels; gemma3-1b
  with 129: the fallback's tied head, logits summed over ``model``, and
  the embedding's sqrt(d) of the whole d;
* hubert-xlarge: the encoder (LayerNorm, a GELU MLP with biases);
* qwen2-moe-a2.7b: the shared expert (a tensor-parallel MLP) and its
  token gate beside the routed experts;
* gemma-7b with 4 query and 4 KV heads: one head a rank at model 4, as
  its 16 split at full width over 4 cards (``scripts/tp_across_cards.py``),
  and its tied embedding split over the vocabulary;
* ``seq_spec`` (the sequence over ``model``) on gemma3, mamba2, olmoe,
  hymba, both odd vocabularies, hubert and qwen2-moe, against tensor
  parallelism alone;
* ``n_micro`` 2 at (2, 2) on gemma3-1b: each microbatch a block of the
  global batch, each rank's share of it by an all-to-all over ``data``;
* elastic checkpoints, (2, 2) → (1, 1) and (1, 1) → (1, 2), resuming with
  the unbroken run's loss.

Tolerances (fp32; tensor parallelism changes the order of sums and the
blocking of the products): metrics to 2e-5 relative (the aux losses and
``dropped`` also 1e-7 absolute).  The rest relative to each leaf's
largest element, at R = max(2e-5, 4 × the case's own sensitivity): the
largest change, relative to its leaf's largest element, of any m or v of
the one-process run after a one-ulp perturbation (a random sign) of every
float of its starting state, the largest over three draws (one draw
varies by 3× in this).  Each rank's m and v to R; its stored
parameter shards and master, where the one-process run's m has been
settled at every step (as ``tests/test_torch_mesh.py`` states it), to R
plus 1e-3 of the steps' learning rates summed (each AdamW step moves a
weight by up to lr · m̂ / √v̂, and a gradient whose terms cancel carries
its rounding into that ratio: a norm scale that starts at zero is a few
lr).  Most cases' sensitivity is below 2e-5/4 (gemma3: 5.8e-6); hymba's
smoke config with 5 heads moves its last layer's SSM leaves' m by 8.1e-5
that way, and tensor parallelism moves them by 1.2e-4.  A wrong slice or
a missing sum over ``model`` moves a weight by a good part of lr or by a
weight's size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh as dp_tests  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402

torch.set_num_threads(1)

RTOL = 2e-5
STEP_TOL = 1e-3
#: R's floor: this many times the case's own one-ulp sensitivity, the
#: largest over this many perturbations
SENSITIVITY, PERTURBATIONS = 4, 3
AUX_ATOL = 1e-7
STEPS = 3
BATCH, SEQ = 4, 32
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
#: name: (arch, config overrides, step config, meshes)
CASES = {
    "gemma3": ("gemma3-1b", {}, {}, ("1x2", "2x2", "1x4")),
    "gemma3_pad_chunk": ("gemma3-1b", {"vocab_pad": 96, "loss_chunk": 8}, {},
                         ("1x2", "2x2", "1x4")),
    "mamba2": ("mamba2-780m", {}, {}, ("1x2", "2x2")),
    "olmoe_g1": ("olmoe-1b-7b", {"capacity_factor": 0.5}, {"moe_groups": 1},
                 ("1x2", "2x2", "1x4")),
    "olmoe_gdata": ("olmoe-1b-7b", {"capacity_factor": 0.5}, {"moe_groups": "data"},
                    ("1x2", "2x2")),
    "olmoe_ragged": ("olmoe-1b-7b", {"moe_dispatch": "ragged"}, {}, ("1x2", "2x2")),
    "hymba_5_heads": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5}, {},
                      ("1x2", "2x2")),
    "internvl2_odd_vocab": ("internvl2-26b", {"vocab_size": 129}, {}, ("1x2", "2x2")),
    "gemma3_odd_vocab": ("gemma3-1b", {"vocab_size": 129}, {}, ("1x2", "2x2")),
    "hubert": ("hubert-xlarge", {}, {}, ("1x2", "2x2")),
    "qwen2_moe_shared": ("qwen2-moe-a2.7b", {}, {}, ("1x2",)),
    # heads that split one a rank at model 4, as gemma-7b's 16 do at full
    # width (the smoke config's 2 do not split over 4 ranks)
    "gemma7b_mha": ("gemma-7b", {"n_heads": 4, "n_kv_heads": 4}, {}, ("2x2", "1x4")),
    # microbatches that span the two data ranks, under tensor parallelism
    "gemma3_micro2": ("gemma3-1b", {}, {"n_micro": 2}, ("2x2",)),
}
#: the cases run again with the sequence over ``model``
SEQ_CASES = ("gemma3", "mamba2", "olmoe_g1", "hymba_5_heads", "internvl2_odd_vocab",
             "gemma3_odd_vocab", "hubert", "qwen2_moe_shared")
SEQ_MESHES = ("1x2", "2x2")
ELASTIC_ARCH = "gemma3-1b"


def _batch(cfg, seed):
    """A global (BATCH, SEQ) batch as numpy in the config's input mode."""
    if cfg.input_mode == "embeds":
        rng = np.random.default_rng(seed)
        return {"embeds": (rng.standard_normal((BATCH, SEQ, cfg.d_model)) * 0.5
                           ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    return dp_tests._batch(cfg, seed)


def _step_cfg(step_cfg, data, seq=False):
    out = {k: (data if v == "data" else v) for k, v in step_cfg.items()}
    if seq:
        out["seq_spec"] = ["data", "model", None]
    return out


def _case_job(name, mesh, seq, state, batches):
    arch, overrides, step_cfg, _ = CASES[name]
    return {"arch": arch, "overrides": {"compute_dtype": "float32", **overrides},
            "step_cfg": _step_cfg(step_cfg, MESHES[mesh][0], seq),
            "state": state, "batches": batches}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run of the module, and the references, once."""
    tmp = tmp_path_factory.mktemp("tp")
    refs = {}
    by_mesh = {mesh: [] for mesh in MESHES}      # mesh: [(key, job)]
    data = {}
    for name, (arch, overrides, step_cfg, meshes) in CASES.items():
        cfg = get_smoke(arch, **overrides)
        batches = [_batch(cfg, seed) for seed in range(STEPS)]
        jcfg, jopt, state = dp_tests._state(arch, overrides)
        data[name] = (state, batches)
        for mesh in meshes:
            sc = _step_cfg(step_cfg, MESHES[mesh][0])
            ref_key = (name, sc.get("moe_groups", 1))
            if ref_key not in refs:
                port = dp_tests._one_process(arch, overrides, sc, state, batches)
                refs[ref_key] = {
                    "port": port, "jax": dp_tests._jax(jcfg, jopt, sc, state, batches),
                    "sensitivity": dp_tests._sensitivity(arch, overrides, sc, state, batches,
                                                         port, PERTURBATIONS)}
            for seq in (False, True):
                if not seq or (name in SEQ_CASES and mesh in SEQ_MESHES):
                    by_mesh[mesh].append(((name, mesh, seq),
                                          _case_job(name, mesh, seq, state, batches)))

    # elastic: one rank saves after 2 steps and (1, 2) resumes; (2, 2)
    # saves and one rank resumes
    e_cfg = get_smoke(ELASTIC_ARCH)
    _, _, e_state = dp_tests._state(ELASTIC_ARCH, {})
    e_batches = [_batch(e_cfg, 20 + seed) for seed in range(STEPS)]
    one_dir, four_dir = tmp / "ckpt_from_1x1", tmp / "ckpt_from_2x2"
    elastic = {"from_1x1": dp_tests._in_one_rank_group(lambda mesh: worker.job_elastic(
        mesh, ELASTIC_ARCH, e_state, str(one_dir), 2, e_batches), tmp)}

    Job = worker.Job
    two_meshes, four_meshes = ["1x2"], ["2x2", "1x4"]

    def tp_jobs(meshes):
        return [Job("tp", {"cases": [job for _, job in by_mesh[m]]}, MESHES[m])
                for m in meshes]

    ragged_dp = _case_job("olmoe_ragged", "2x2", False, *data["olmoe_ragged"])
    two = worker.spawn(2, tp_jobs(two_meshes) + [
        Job("dp", {"cases": [ragged_dp]}, (2, 1)),
        Job("elastic", dict(arch=ELASTIC_ARCH, state=None, ckpt_dir=str(one_dir),
                            save_step=None, batches=e_batches[2:]), (1, 2)),
    ], tmp / "two")
    four = worker.spawn(4, tp_jobs(four_meshes) + [
        Job("elastic", dict(arch=ELASTIC_ARCH, state=e_state, ckpt_dir=str(four_dir),
                            save_step=2, batches=e_batches), (2, 2)),
    ], tmp / "four")
    elastic["to_1x1"] = dp_tests._in_one_rank_group(lambda mesh: worker.job_elastic(
        mesh, ELASTIC_ARCH, None, str(four_dir), None, e_batches[2:]), tmp)

    tp = {}
    for results, meshes in ((two, two_meshes), (four, four_meshes)):
        for j, mesh in enumerate(meshes):
            for i, (key, _) in enumerate(by_mesh[mesh]):
                tp[key] = [r[j][i] for r in results]
    return {"tp": tp, "refs": refs, "two": two, "four": four, "elastic": elastic,
            "n_two_tp": len(two_meshes), "n_four_tp": len(four_meshes)}


def _ref(runs, name, mesh):
    sc = _step_cfg(CASES[name][2], MESHES[mesh][0])
    return runs["refs"][(name, sc.get("moe_groups", 1))]


def _ragged_dp(runs):
    """The data-parallel step at data 2 on the ragged case (one rank's)."""
    return runs["two"][0][runs["n_two_tp"]][0]


def _assert_metrics(got, want, keys):
    for k in keys:
        if k in ("load_balance", "router_z", "dropped"):
            assert got[k] == pytest.approx(want[k], rel=RTOL, abs=AUX_ATOL), k
        else:
            assert got[k] == pytest.approx(want[k], rel=RTOL), k


def _tp_keys():
    return [(name, mesh) for name, (_, _, _, meshes) in CASES.items() for mesh in meshes]


@pytest.mark.parametrize("name,mesh", _tp_keys())
def test_tp_metrics_match_one_process_and_jax(runs, name, mesh):
    """Every step's loss, ce, aux losses, grad_norm and lr, on every rank,
    against one process and JAX on the concatenated batch (the ragged
    dispatch over two data ranks: against the data-parallel step, whose
    per-rank sort it shares)."""
    ref = _ref(runs, name, mesh)
    for rank in runs["tp"][(name, mesh, False)]:
        assert rank["step"] == STEPS
        for step in range(STEPS):
            got = rank["metrics"][step]
            assert set(got) == set(ref["jax"][step])
            if name == "olmoe_ragged" and mesh == "2x2":
                _assert_metrics(got, _ragged_dp(runs)["metrics"][step], got)
                continue
            _assert_metrics(got, ref["port"]["metrics"][step], got)
            _assert_metrics(got, ref["jax"][step], got)


def _rel_tol(refs):
    """R: 2e-5, or SENSITIVITY times the case's own sensitivity."""
    return max(RTOL, SENSITIVITY * refs["sensitivity"])


def _param_tol(refs, step, leaf):
    """A parameter's bound after ``step``: R of the leaf's largest element
    plus 1e-3 of the learning rates of the steps so far."""
    lrs = sum(m["lr"] for m in refs["port"]["metrics"][:step + 1])
    return _rel_tol(refs) * np.abs(leaf).max() + STEP_TOL * lrs


def _opt_tol(refs, key):
    """An optimizer leaf's bound: R of its largest element (master: as a
    parameter after the last step)."""
    full = refs["port"]["opt"][key]
    if key.startswith("master/"):
        return _param_tol(refs, STEPS - 1, full)
    return _rel_tol(refs) * max(np.abs(full).max(), 1e-30)


def _rules_slice(path, shape, coords, sizes):
    """The slice of a leaf of ``shape`` at ``path`` that the sharding rules
    give the rank at mesh ``coords``."""
    names = path.split("/")
    spec = shd.fit_spec(shd.param_spec(names, len(shape)), shape, shd.AxisSizes(sizes))
    return dp_tests._expected_slice(shape, list(spec), coords, sizes)


@pytest.mark.parametrize("name,mesh", _tp_keys())
def test_tp_shards_are_the_rules_slices_and_match_one_process(runs, name, mesh):
    """Each rank's stored parameter shards are the slices the sharding
    rules give it (a leaf split over ``model`` really is split), and after
    every step they match those slices of the one-process parameters; its
    m, v and master match the one-process optimizer state's slices."""
    refs = _ref(runs, name, mesh)
    ref = refs["port"]
    if name == "olmoe_ragged" and mesh == "2x2":
        ref = None
    data, model = MESHES[mesh]
    sizes = {"data": data, "model": model}
    split = 0
    for rank in runs["tp"][(name, mesh, False)]:
        for step in range(STEPS):
            for path, (local, bounds) in rank["params"][step].items():
                sl = tuple(slice(a, b) for a, b in bounds)
                if step == 0:
                    full_shape = tuple(_full_shape(runs, name, mesh, path))
                    assert sl == _rules_slice(path, full_shape, rank["coords"], sizes), path
                    split += local.size < np.prod(full_shape)
                if ref is None:
                    continue
                want = ref["params"][step][path]
                err = np.abs(local - want[sl])[ref["settled"][step][path][sl]]
                assert err.max(initial=0) <= _param_tol(refs, step, want), (path, step)
        if ref is None:
            continue
        for key, (local, bounds) in rank["shards"].items():
            part, path = key.split("/", 1)
            sl = tuple(slice(a, b) for a, b in bounds)
            want = ref["opt"][key][sl]
            assert local.shape == want.shape, key
            err = np.abs(local - want)
            if part == "master":
                err = err[ref["settled"][-1][path][sl]]
            assert err.max(initial=0) <= _opt_tol(refs, key), key
    assert split > 0


def _full_shape(runs, name, mesh, path):
    ref = _ref(runs, name, mesh)["port"]
    return ref["params"][0][path].shape


@pytest.mark.parametrize("name,mesh", [(n, m) for n in SEQ_CASES for m in SEQ_MESHES
                                       if m in CASES[n][3]])
def test_seq_spec_matches_tensor_parallelism_alone(runs, name, mesh):
    """With the sequence over ``model`` between blocks: every step's
    metrics and every rank's shards against tensor parallelism alone on
    the same mesh (and so against one process)."""
    refs = _ref(runs, name, mesh)
    ref = refs["port"]
    for seq_rank, tp_rank in zip(runs["tp"][(name, mesh, True)],
                                 runs["tp"][(name, mesh, False)]):
        for step in range(STEPS):
            _assert_metrics(seq_rank["metrics"][step], tp_rank["metrics"][step],
                            tp_rank["metrics"][step])
            for path, (local, bounds) in seq_rank["params"][step].items():
                want, want_bounds = tp_rank["params"][step][path]
                assert bounds == want_bounds, path
                sl = tuple(slice(a, b) for a, b in bounds)
                err = np.abs(local - want)[ref["settled"][step][path][sl]]
                tol = _param_tol(refs, step, ref["params"][step][path])
                assert err.max(initial=0) <= tol, (path, step)


def test_elastic_restore_across_mesh_shapes(runs):
    """Saved at (1, 1), resumed at (1, 2); saved at (2, 2), resumed at (1, 1):
    the resumed step's loss is the unbroken run's, and the resumed step
    number is the saved one."""
    e = runs["elastic"]
    for rank in runs["two"]:
        resumed = rank[runs["n_two_tp"] + 1]
        assert resumed["restored_step"] == 2
        assert resumed["losses"][0] == pytest.approx(e["from_1x1"]["losses"][2], rel=RTOL)
    unbroken = runs["four"][0][runs["n_four_tp"]]["losses"]
    assert e["to_1x1"]["restored_step"] == 2
    assert e["to_1x1"]["losses"][0] == pytest.approx(unbroken[2], rel=RTOL)
    np.testing.assert_allclose(unbroken, e["from_1x1"]["losses"], rtol=RTOL)


@pytest.mark.parametrize("compress_grads", [False, True])
def test_model_one_is_the_data_parallel_step_bit_for_bit(tmp_path, compress_grads):
    """A (1, 1) mesh takes the mesh step with every tensor-parallel site
    the identity: the same bits as the step without a mesh (with int8
    gradients too: the mesh step's round trip with scales over ``model``
    is then ``compress_int8``'s)."""
    name = "gemma3"
    arch, overrides, _, _ = CASES[name]
    cfg = get_smoke(arch, **overrides)
    _, _, state = dp_tests._state(arch, overrides)
    batches = [_batch(cfg, seed) for seed in range(2)]
    port = dp_tests._one_process(arch, overrides, {"compress_grads": compress_grads},
                                 state, batches)
    job = _case_job(name, "1x2", False, state, batches)
    job["step_cfg"] = {**job["step_cfg"], "compress_grads": compress_grads}
    got = dp_tests._in_one_rank_group(lambda mesh: worker.job_tp(mesh, [job])[0],
                                      tmp_path)
    for step in range(2):
        assert got["metrics"][step] == port["metrics"][step]
        for path, (local, _) in got["params"][step].items():
            np.testing.assert_array_equal(local, port["params"][step][path])
