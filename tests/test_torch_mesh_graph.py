"""The mesh step as the port captures it on the cards: a step that replays.
On a card whose mesh runs its collectives over NCCL, ``GraphedTrainStep``
captures the data-parallel, ``n_micro`` and tensor-parallel steps, their
collectives too, as one CUDA graph; a replay runs the captured kernels and
collectives on the same buffers and no host code.  So, as on one card
(``tests/test_torch_train_graph.py``), the step must read nothing on the
host, build nothing from host data and keep every state leaf's storage,
and its collectives must be the same at every step.

Held here on the CPU over gloo ranks (``tests/torch_mesh_worker.py``'s
``graph_step`` job, one spawn of 2 ranks for every case), at smoke size,
from weights made by the JAX init: data 2 at ``n_micro`` 1 and 2
(gemma3-1b, whose (V, d) tables of a vocabulary of 4096 shard their m, v
and master over data), and (data 1, model 2) (olmoe-1b-7b, the grouped
GEMM's experts split over ``model``):

* the step's aten ops, forward, backward and update, with their non-tensor
  arguments and their tensors' dtypes and shapes, are the same at steps 1
  and 2 and hold no ``aten.lift_fresh``, ``aten._local_scalar_dense`` or
  ``aten.nonzero``; each kernel launch is one op (the wrappers on their
  card's branches), and the step's collectives are c10d ops; the
  collectives ``repro_torch.events`` hears (kind, axis, bytes) are the
  same at steps 1 and 2;
* every leaf of the state, a DTensor, is kept across a step, with its
  local storage;
* ``GraphedTrainStep`` (eager on its fixed buffers on the CPU) is
  ``make_train_step``'s mesh step bit for bit over 3 steps: metrics, each
  rank's parameters after every step and its m, v and master shards;
* at data 2 and ``n_micro`` 1 the graphed step also matches the jitted JAX
  step on the global batches and one process of the port, at
  ``tests/test_torch_mesh.py``'s tolerances (its ``gemma3`` case).

On 4 cards the graphed mesh steps are held against the eager ones by
``scripts/dp_across_cards.py`` and ``scripts/tp_across_cards.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh as dp_tests  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402

torch.set_num_threads(1)

STEPS = 3
#: name: (arch, config overrides, step config, (data, model))
CASES = {
    "data2": ("gemma3-1b", dp_tests.V, {}, (2, 1)),
    "data2_micro2": ("gemma3-1b", dp_tests.V, {"n_micro": 2}, (2, 1)),
    "model2": ("olmoe-1b-7b", {}, {}, (1, 2)),
}
#: the case held against JAX, and its name among test_torch_mesh.py's cases
JAX_CASE, MESH_CASE = "data2", "gemma3"
#: what the collectives of each case's step must include, by (kind, axis)
COLLECTIVES = {
    "data2": {("all-reduce", "data"), ("all-gather", "data")},
    "data2_micro2": {("all-reduce", "data"), ("all-gather", "data"),
                     ("all-to-all", "data")},
    "model2": {("all-reduce", "model")},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's graph_step job in one spawn of 2 ranks, and the JAX
    case's references (test_torch_mesh.py's one process and JAX)."""
    tmp = tmp_path_factory.mktemp("mesh_graph")
    jobs, refs = [], {}
    for name, (arch, overrides, step_cfg, shape) in CASES.items():
        cfg = get_smoke(arch, **overrides)
        rows = dp_tests.BATCH * step_cfg.get("n_micro", 1)
        batches = [dp_tests._batch(cfg, seed, rows) for seed in range(STEPS)]
        jcfg, jopt, state = dp_tests._state(arch, overrides)
        if name == JAX_CASE:
            refs = {"port": dp_tests._one_process(arch, overrides, step_cfg, state, batches),
                    "jax": dp_tests._jax(jcfg, jopt, step_cfg, state, batches)}
        jobs.append(worker.Job("graph_step", dict(
            arch=arch, overrides={"compute_dtype": "float32", **overrides},
            step_cfg=step_cfg, state=state, batches=batches), shape))
    ranks = worker.spawn(2, jobs, tmp / "two")
    return {"cases": {name: [rank[i] for rank in ranks] for i, name in enumerate(CASES)},
            "refs": refs}


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_is_the_same_at_steps_one_and_two(runs, name):
    """Steps 1 and 2 run the same aten ops, clean, kernel launches and c10d
    collectives among them, and report the same collectives."""
    for rank in runs["cases"][name]:
        trace = rank["trace"]
        assert trace["differs"] is None, trace["differs"]
        assert trace["launches"] > 0 and trace["c10d"], trace
        first, second = trace["heard"]
        collectives = [e[1:] for e in first if e[0] == "collective"]
        assert collectives and first == second
        assert COLLECTIVES[name] <= {(kind, axis) for kind, axis, _ in collectives}
        assert all(nbytes > 0 for *_, nbytes in collectives)


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_keeps_every_state_leaf_and_its_storage(runs, name):
    for rank in runs["cases"][name]:
        assert rank["trace"]["kept"] and rank["trace"]["leaves"] > 0
        assert rank["trace"]["step"] == 2


@pytest.mark.parametrize("name", CASES)
def test_graphed_mesh_step_is_the_mesh_step_bit_for_bit(runs, name):
    """GraphedTrainStep against make_train_step's mesh step from the same
    state over 3 steps: every metric, every rank's parameters after every
    step and its m, v and master shards, equal."""
    for rank in runs["cases"][name]:
        got, want = rank["graphed"], rank["plain"]
        assert not got["graph"] and got["step"] == want["step"] == STEPS
        assert got["metrics"] == want["metrics"]
        for step in range(STEPS):
            assert set(got["params"][step]) == set(want["params"][step])
            for key, w in want["params"][step].items():
                np.testing.assert_array_equal(got["params"][step][key], w, err_msg=key)
        for key, (local, bounds) in want["shards"].items():
            assert got["shards"][key][1] == bounds, key
            np.testing.assert_array_equal(got["shards"][key][0], local, err_msg=key)


def test_graphed_mesh_step_matches_jax_and_one_process(runs):
    """At data 2 the graphed step's metrics match one process and the
    jitted JAX step on the global batches, and its parameters and ZeRO-1
    shards one process, at test_torch_mesh.py's tolerances."""
    ranks = [rank["graphed"] for rank in runs["cases"][JAX_CASE]]
    data = CASES[JAX_CASE][3][0]
    view = {"refs": {(MESH_CASE, 1): runs["refs"]}, "dp": {(MESH_CASE, data): ranks}}
    dp_tests._metrics_match(view, MESH_CASE, data)
    dp_tests._params_and_shards_match(view, MESH_CASE, data, dp_tests.RTOL)
