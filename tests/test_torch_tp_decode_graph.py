"""The decode step on a device mesh as the port captures it on the cards.
On a card whose ``model`` axis runs its collectives over NCCL,
``GraphedServeStep`` captures this rank's decode step, its collectives
too, as one CUDA graph, and replays it every token; a replay runs the
captured kernels and collectives on the same buffers and no host code.  So,
as on one card (``tests/test_torch_serve_graph.py``), the step must read
nothing on the host, build nothing from host data and keep every cache
leaf's storage, and its collectives must be the same at every token.

Held here on the CPU over gloo ranks (``tests/torch_mesh_worker.py``'s
``graph_decode`` job, one spawn of 2 ranks for every case), at smoke size
and fp32 compute, at (data 1, model 2), on ``tests/test_torch_tp_decode.py``'s
weights and tokens:

* gemma3-1b with a window of 4: its lone KV head split over the head dim
  (partial scores summed over ``model``: ``decode_sum``; each head's output
  slices gathered), its rings past their window;
* olmoe-1b-7b: KV heads split, the experts at f/2 (the grouped GEMM, one
  launch a product);
* mamba2-780m: SSM heads split, the conv cut across x | B | C.

For each:

* the step's aten ops, with their non-tensor arguments and their tensors'
  dtypes and shapes, are the same at tokens 1 and 2 and hold no
  ``aten.lift_fresh``, ``aten._local_scalar_dense`` or ``aten.nonzero``;
  the collectives ``repro_torch.events`` hears (kind, axis, bytes) are the
  same at tokens 1 and 2;
* every cache leaf keeps its local storage across a step, and ``pos`` is
  the same tensor, advanced;
* ``GraphedServeStep`` with the mesh (eager on the CPU, on its fixed
  buffers) is ``make_serve_step(cfg, mesh)`` bit for bit over 10 tokens,
  past gemma3's ring: each token's logits and every cache shard;
* gemma3's graphed step also matches JAX's ``decode_step`` on the whole
  tree, each rank's vocabulary columns, at ``test_torch_tp_decode.py``'s
  1e-5.

And on the mesh: a graphed step on a card refuses a gloo mesh, naming the
backend, and a capture that fails on one rank makes every rank raise.

On 4 cards the graphed mesh step is held against the eager one and one
card by ``scripts/tp_across_cards.py``'s decode phase.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_tp_decode as decode_tests  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

torch.set_num_threads(1)

#: name: (test_torch_tp_decode.py's case, what its step's collectives must
#: include, by (kind, axis))
CASES = {
    "gemma3_window": ("gemma3_window", {("all-reduce", "model"), ("all-gather", "model")}),
    "olmoe": ("olmoe", {("all-reduce", "model")}),
    "mamba2": ("mamba2", {("all-reduce", "model"), ("all-gather", "model")}),
}
#: the case held against JAX
JAX_CASE = "gemma3_window"
MODEL = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's graph_decode job in one spawn of 2 ranks at (1, 2)."""
    built = {name: decode_tests._case(case) for name, (case, _) in CASES.items()}
    ranks = worker.spawn(MODEL, [worker.Job("graph_decode", {
        "cases": [case for _, case in built.values()]}, (1, MODEL))],
        tmp_path_factory.mktemp("tp_decode_graph"))
    return built, [rank[0] for rank in ranks]


def _per_rank(runs, name):
    _, ranks = runs
    index = list(CASES).index(name)
    return [(rank, rank["cases"][index]) for rank in ranks]


@pytest.mark.parametrize("name", CASES)
def test_mesh_decode_is_the_same_at_tokens_one_and_two(runs, name):
    """Tokens 1 and 2 run the same aten ops, clean, c10d collectives among
    them (and olmoe's grouped GEMM as launches), and report the same
    collectives."""
    for _, case in _per_rank(runs, name):
        trace = case["trace"]
        assert trace["differs"] is None, trace["differs"]
        assert trace["c10d"], trace
        assert (trace["launches"] > 0) == (name == "olmoe")
        first, second = trace["heard"]
        collectives = [e[1:] for e in first if e[0] == "collective"]
        assert collectives and first == second
        assert CASES[name][1] <= {(kind, axis) for kind, axis, _ in collectives}
        assert all(nbytes > 0 for *_, nbytes in collectives)


@pytest.mark.parametrize("name", CASES)
def test_mesh_decode_keeps_every_cache_leaf_and_its_storage(runs, name):
    for _, case in _per_rank(runs, name):
        assert case["trace"]["kept"] and case["trace"]["leaves"] > 0


@pytest.mark.parametrize("name", CASES)
def test_graphed_mesh_decode_is_the_mesh_step_bit_for_bit(runs, name):
    """GraphedServeStep against make_serve_step(cfg, mesh), each on a cache
    of its own, fed the same tokens: every token's logits and every cache
    shard after the last, equal."""
    for _, case in _per_rank(runs, name):
        got, want = case["graphed"], case["plain"]
        assert not got["graph"]
        assert got["pos"] == want["pos"] == decode_tests.STEPS
        assert len(got["logits"]) == decode_tests.STEPS
        for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_array_equal(g, w, err_msg=f"token {t}")
        assert set(got["cache"]) == set(want["cache"])
        for path, w in want["cache"].items():
            np.testing.assert_array_equal(got["cache"][path], w, err_msg=path)


def test_graphed_mesh_decode_matches_jax(runs):
    """The graphed step's logits, each rank's vocabulary columns, against
    JAX's decode_step on the whole tree, at test_torch_tp_decode.py's
    tolerance."""
    built, _ = runs
    cfg, case = built[JAX_CASE]
    jcfg = dataclasses.replace(jget_smoke(case["arch"], **case["overrides"]),
                               compute_dtype="float32")
    jm = JModel(jcfg)
    jp = jax.tree.map(jnp.asarray, case["params"])
    jc = jm.init_cache(decode_tests.BATCH, decode_tests.MAX_LEN, dtype=jnp.float32)
    jstep = jax.jit(jm.decode_step)
    want = []
    for t in range(decode_tests.STEPS):
        logits, jc = jstep(jp, jc, jnp.asarray(case["tokens"][t, :, None], jnp.int32))
        want.append(np.asarray(logits))
    cols = -(-cfg.padded_vocab // MODEL)
    for rank, got in _per_rank(runs, JAX_CASE):
        for t, g in enumerate(got["graphed"]["logits"]):
            w = want[t]
            if g.shape[-1] != w.shape[-1]:          # this rank's vocabulary columns
                w = w[:, rank["model"] * cols:rank["model"] * cols + g.shape[-1]]
            np.testing.assert_allclose(g, w, rtol=decode_tests.TOL, atol=decode_tests.TOL,
                                       err_msg=f"rank {rank['model']} token {t}")


def test_a_graphed_step_refuses_a_gloo_mesh_naming_the_backend(runs):
    _, ranks = runs
    for rank in ranks:
        assert rank["refused"].startswith("a graphed step cannot be captured")
        assert "model axis of 2 ranks" in rank["refused"] and "over gloo" in rank["refused"]


def test_a_capture_that_fails_on_one_rank_raises_on_every_rank(runs):
    """Model rank 1's capture runs out of memory: it raises its own error,
    and rank 0, whose capture succeeded, learns it from the agreement and
    raises too, dropping its graph."""
    _, ranks = runs
    by_rank = {rank["model"]: rank["agreement"] for rank in ranks}
    assert by_rank[1] == ("OutOfMemoryError", "rank 1's capture does not fit")
    assert by_rank[0][0] == "RuntimeError"
    assert by_rank[0][1].startswith("another rank's capture of the mesh step failed")


def test_the_graphed_steps_share_one_capture_path():
    """The train step, the gang's step and the serve step all derive from
    repro_torch.capture.CapturedStep; the train step's module re-exports it."""
    from repro_torch.capture import CapturedStep
    from repro_torch.serve.engine import GraphedServeStep
    from repro_torch.train import step as train_step
    from repro_torch.train.ensemble import Gang
    assert train_step.CapturedStep is CapturedStep
    for cls in (train_step.GraphedTrainStep, GraphedServeStep, Gang):
        assert issubclass(cls, CapturedStep), cls
    assert "_capture" not in vars(train_step.GraphedTrainStep)
    assert "_capture" not in vars(GraphedServeStep)
