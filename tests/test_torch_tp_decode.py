"""Decode under a ``model`` axis on the CPU: gloo ranks spawned by
``tests/torch_mesh_worker.py`` (no jax in the ranks) at (data, model) =
(1, 2), (2, 2) and (1, 4), each holding its stored shards of the
parameters and only its shards of the cache (``init_cache`` with the
mesh), ``decode_step`` teacher-forced for STEPS tokens, against one
process on the same weights and tokens (the one-process decode is held
against JAX's ``decode_step`` in ``tests/test_torch_model.py``).

The smoke configs hit each placement of the cache:

* gemma3-1b: its lone KV head split over the head dim (q, k, v formed
  whole, RoPE and ``qk_norm`` on whole heads, partial scores summed over
  ``model``), and with a window of 4 its SWA rings go past the window;
* olmoe-1b-7b: KV heads split (a rank's heads from its own columns), and
  the MoE einsum on each rank's f / M of every expert;
* hymba-1.5b: at model 2 KV heads split, at 4 (2 KV heads) the head dim;
  its SSM heads split, the conv channels cut across x | B | C;
* mamba2-780m: SSM heads split with the conv cut across x | B | C; with
  d_model 48 (6 heads) at model 4 the SSM state is stored whole: every
  rank steps every head, and ``out_proj``'s rows are split.

fp32 compute: the logits (each rank's vocabulary columns) and every cache
leaf within 1e-5 (relative and absolute) of one process's (the order of
the sums changes: the scores over a head-dim split are summed over
``model``; measured up to 1.5e-6).  Each rank's cache leaves have exactly
its shard's shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.transformer import decode_step, init_cache, init_params  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

STEPS, BATCH, MAX_LEN = 10, 4, 24
TOL = 1e-5
#: name: (arch, config overrides, meshes)
CASES = {
    "gemma3_window": ("gemma3-1b", {"window": 4}, ("1x2", "2x2", "1x4")),
    "olmoe": ("olmoe-1b-7b", {}, ("1x2", "2x2", "1x4")),
    "hymba": ("hymba-1.5b", {}, ("1x2", "2x2", "1x4")),
    "mamba2": ("mamba2-780m", {}, ("1x2", "2x2")),
    "mamba2_whole_state": ("mamba2-780m", {"d_model": 48}, ("1x4",)),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}


def _case(name):
    arch, overrides, _ = CASES[name]
    ov = {"compute_dtype": "float32", **overrides}
    cfg = get_smoke(arch, **ov)
    gen = torch.Generator()
    gen.manual_seed(0)
    rng = np.random.default_rng(sum(map(ord, name)))
    params = tree_map(lambda t: (t.numpy() + 0.05 * rng.standard_normal(t.shape)
                                 ).astype(np.float32), init_params(cfg, gen))
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, BATCH))
    return cfg, {"arch": arch, "overrides": ov, "params": params, "tokens": tokens,
                 "max_len": MAX_LEN, "cache_dtype": "float32"}


def _one_process(cfg, case):
    params = tree_map(torch.from_numpy, case["params"])
    cache = init_cache(cfg, BATCH, MAX_LEN, "float32", "cpu")
    logits = []
    with torch.no_grad():
        for t in range(STEPS):
            lg, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(case["tokens"][t, :, None]))
            logits.append(lg.numpy())
    return logits, {k: v.numpy() for k, v in bridge.flatten(cache).items()
                    if isinstance(v, torch.Tensor)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on each of its meshes: one spawn a mesh shape."""
    built = {name: _case(name) for name in CASES}
    out = {}
    for mesh_name, shape in MESHES.items():
        names = [n for n, (_, _, meshes) in CASES.items() if mesh_name in meshes]
        res = worker.spawn(shape[0] * shape[1],
                           [worker.Job("decode", {"cases": [built[n][1] for n in names]},
                                       shape)],
                           tmp_path_factory.mktemp(f"decode_{mesh_name}"))
        for i, n in enumerate(names):
            out[(n, mesh_name)] = [rank[0][i] for rank in res]
    return built, out


PAIRS = [(n, m) for n, (_, _, meshes) in CASES.items() for m in meshes]


@pytest.mark.parametrize("name,mesh", PAIRS)
def test_decode_matches_one_process(runs, name, mesh):
    built, out = runs
    cfg, case = built[name]
    want_logits, want_cache = _one_process(cfg, case)
    data, model = MESHES[mesh]
    rows = BATCH // data
    for rank in out[(name, mesh)]:
        i, j = rank["data"], rank["model"]
        assert rank["pos"] == STEPS
        for t, got in enumerate(rank["logits"]):
            want = want_logits[t][i * rows:(i + 1) * rows]
            if got.shape[-1] != want.shape[-1]:      # this rank's vocab columns
                cols = -(-cfg.padded_vocab // model)
                want = want[:, j * cols:j * cols + got.shape[-1]]
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {mesh} rank {i},{j} step {t}")
        for path, (arr, bounds) in rank["cache"].items():
            sl = tuple(slice(a, b) for a, b in bounds)
            assert arr.shape == tuple(b - a for a, b in bounds), path
            np.testing.assert_allclose(arr, want_cache[path][sl], rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {mesh} {path}")


@pytest.mark.parametrize("name,mesh", PAIRS)
def test_each_rank_holds_only_its_cache_shards(runs, name, mesh):
    """A rank's cache leaves are its blocks: together the ranks of one data
    row cover each leaf once (or each hold it whole)."""
    built, out = runs
    cfg, _ = built[name]
    data, model = MESHES[mesh]
    ranks = out[(name, mesh)]
    for path in ranks[0]["cache"]:
        whole = init_cache(cfg, BATCH, MAX_LEN, "float32", "meta")
        full = bridge.flatten(whole)[path].numel()
        held = [int(np.prod(r["cache"][path][0].shape)) for r in ranks if r["data"] == 0]
        assert sum(held) in (full // data, model * full // data), path


def test_cases_cover_each_placement(runs):
    built, out = runs
    splits = {(out[k][0]["view"].get("attn") or {}).get("split") for k in out}
    assert {"heads", "d"} <= splits
    ssm = [out[k][0]["view"]["ssm"] for k in out if "ssm" in out[k][0]["view"]]
    assert any(v["whole"] for v in ssm) and any(not v["whole"] for v in ssm)
    assert all(v["conv_split"] for v in ssm)
