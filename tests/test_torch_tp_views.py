"""The pieces of tensor parallelism alone: the compute views of
``repro_torch.distributed.sharding`` (pure functions of the config, the
``model`` size and the rank) and the differentiable collectives of
``repro_torch.distributed.context`` in two spawned gloo ranks, each held
against what it is in numpy.  The model and the step built on them are
held against the JAX package in ``tests/test_torch_tp.py``."""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


@pytest.mark.parametrize("n,m", [(7, 2), (8, 4), (5, 3), (48, 16), (3, 4)])
def test_split_range_tiles_in_order(n, m):
    """The ranks' blocks are contiguous, in rank order, cover 0..n and
    differ in length by at most one (numpy's array_split)."""
    blocks = [shd.split_range(n, m, j) for j in range(m)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert [b - a for a, b in blocks] == [len(p) for p in np.array_split(np.arange(n), m)]


@pytest.mark.parametrize("heads,groups,m", [
    (h, g, m) for h, g, m in itertools.product(
        (1, 2, 4, 5, 8, 16, 25, 32, 48, 50), (1, 2, 5, 8, 16, 32), (2, 4, 8, 16))
    if h % g == 0])
def test_head_split_keeps_groups_whole_or_reads_one(heads, groups, m):
    """Wherever a split is given, the ranks' heads tile 0..H in order; each
    rank reads the groups its heads belong to, either whole groups (GQA's
    kernel maps its heads onto them) or a part of one group; a split is
    given exactly where one of the two is possible."""
    per = heads // groups
    splits = [shd.head_split(heads, groups, m, j) for j in range(m)]
    possible = groups >= m or (m % groups == 0 and per >= m // groups)
    assert (splits[0] is not None) == possible
    if not possible:
        assert all(s is None for s in splits)
        return
    assert splits[0][0][0] == 0 and splits[-1][0][1] == heads
    for (h, g), (h2, _) in zip(splits, splits[1:]):
        assert h[1] == h2[0]
    for (h0, h1), (g0, g1) in splits:
        assert h1 > h0 and g1 > g0
        assert g0 == h0 // per and g1 == -(-h1 // per)
        whole = (h1 - h0) == (g1 - g0) * per and h0 % per == 0
        assert whole or g1 - g0 == 1


@pytest.mark.parametrize("arch,m,want", [
    # gemma3-1b: 4 query heads over 1 KV head of 256
    ("gemma3-1b", 2, [((0, 2), (0, 1)), ((2, 4), (0, 1))]),
    ("gemma3-1b", 4, [((j, j + 1), (0, 1)) for j in range(4)]),
    # hymba-1.5b: 25 heads in 5 groups at model 2 → 3 and 2 groups
    ("hymba-1.5b", 2, [((0, 15), (0, 3)), ((15, 25), (3, 5))]),
    ("deepseek-7b", 4, [((8 * j, 8 * j + 8), (8 * j, 8 * j + 8)) for j in range(4)]),
    # internvl2-26b at model 16: 8 KV heads, each group's 6 heads over 2 ranks
    ("internvl2-26b", 16, [((6 * (j // 2) + 3 * (j % 2), 6 * (j // 2) + 3 * (j % 2) + 3),
                            (j // 2, j // 2 + 1)) for j in range(16)]),
])
def test_attn_view_at_full_size(arch, m, want):
    """The attention views of full configs: heads, KV heads and the column
    ranges of wq, wk, wv (and wo's rows) in units of head_dim."""
    cfg = get(arch)
    d = cfg.head_dim
    for j, (heads, kv) in enumerate(want):
        v = shd.attn_view(cfg.n_heads, cfg.n_kv_heads, d, m, j)
        assert (v["heads"], v["kv_heads"]) == (heads, kv)
        assert v["wq"] == v["wo"] == ((heads[0] * d, heads[1] * d),)
        assert v["wk"] == v["wv"] == ((kv[0] * d, kv[1] * d),)


def test_attn_view_is_none_where_heads_do_not_split():
    """gemma3-1b's smoke config at model 4: 2 query heads over 1 KV head."""
    cfg = get("gemma3-1b")
    assert all(shd.attn_view(2, 1, cfg.head_dim, 4, j) is None for j in range(4))


@pytest.mark.parametrize("arch,m", [("mamba2-780m", 2), ("mamba2-780m", 4),
                                    ("hymba-1.5b", 2), ("hymba-1.5b", 4)])
def test_ssm_view_picks_each_piece_of_the_packed_leaves(arch, m):
    """in_proj's columns are [z | x | B | C | dt] and the conv's [x | B | C]:
    the view's ranges, concatenated, give the rank's z, x and dt columns and
    the B and C of its group, in that order, and the ranks' heads tile
    the mixer's."""
    cfg = get(arch)
    di, p, n, g = cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    h, gn = cfg.ssm_heads, g * n
    labels = ([("z", i) for i in range(di)] + [("x", i) for i in range(di)]
              + [("B", i) for i in range(gn)] + [("C", i) for i in range(gn)]
              + [("dt", i) for i in range(h)])
    conv = labels[di:di + di + 2 * gn]
    covered = []
    for j in range(m):
        v = shd.ssm_view(di, p, n, g, m, j)
        (h0, h1), (g0, g1) = v["heads"], v["groups"]
        covered += list(range(h0, h1))
        inner = [(k, i) for k in ("z", "x") for i in range(h0 * p, h1 * p)]
        bc = [(k, i) for k in ("B", "C") for i in range(g0 * n, g1 * n)]
        want = inner[:(h1 - h0) * p] + inner[(h1 - h0) * p:] + bc + [
            ("dt", i) for i in range(h0, h1)]
        assert [lab for a, b in v["in_proj"] for lab in labels[a:b]] == want
        assert [lab for a, b in v["conv"] for lab in conv[a:b]] == want[(h1 - h0) * p:-(h1 - h0)]
        assert v["inner"] == ((h0 * p, h1 * p),)
    assert covered == list(range(h))


def test_views_are_the_stored_shards_where_the_rules_allow():
    """deepseek-7b at model 4: every attention range and the MLP's hidden
    block are the rank's stored shard (no gather); mamba2-780m's packed
    in_proj is not (its shard holds all of z and a part of x)."""
    sizes = shd.AxisSizes({"data": 1, "model": 4})
    cfg = get("deepseek-7b")

    def stored(shape, spec, dim, j):
        spec = shd.fit_spec(spec, shape, sizes)
        assert spec[dim] == "model"
        k = shape[dim] // 4
        return ((j * k, (j + 1) * k),)

    d = cfg.d_model
    for j in range(4):
        v = shd.attn_view(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4, j)
        assert v["wq"] == stored((d, cfg.attn_dim), shd.param_spec(["wq"], 2), 1, j)
        assert v["wo"] == stored((cfg.attn_dim, d), shd.param_spec(["wo"], 2), 0, j)
        assert shd.hidden_view(cfg.d_ff, 4, j) == stored(
            (d, cfg.d_ff), shd.param_spec(["wi_gate"], 2), 1, j)
    mamba = get("mamba2-780m")
    v = shd.ssm_view(mamba.d_inner, mamba.ssm_head_dim, mamba.ssm_state,
                     mamba.ssm_groups, 2, 0)
    assert v["in_proj"][0] == (0, mamba.d_inner // 2)
    assert len(v["in_proj"]) == 5


@pytest.mark.parametrize("arch", all_archs())
@pytest.mark.parametrize("m", [2, 4])
def test_vocab_view_follows_the_rules(arch, m):
    """Where the rules shard the vocabulary the table and the head are
    vocab-parallel; an odd vocabulary falls back to d (hymba-1.5b's 32001,
    internvl2-26b's 92553), its tied head then summed over ``model``,
    internvl2's untied head whole."""
    cfg = get(arch)
    got = shd.vocab_view(cfg, m)
    if cfg.padded_vocab % m == 0:
        assert got["embed"] == "vocab"
        assert got["head"] == "vocab"
    else:
        assert got["embed"] == "d"
        assert got["head"] == ("d" if cfg.tie_embeddings else "whole")
    assert {"hymba-1.5b": "d", "internvl2-26b": "d"}.get(arch, "vocab") == got["embed"]


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    cots = rng.standard_normal((2, 4, 8)).astype(np.float32)
    out = worker.spawn(2, [worker.Job("collectives", {"x": x, "cots": cots}, (1, 2))],
                       tmp_path_factory.mktemp("collectives"))
    return x, cots, [r[0] for r in out]


def test_model_collectives_and_their_gradients(collectives):
    """Each collective over two ``model`` ranks: its forward, and the
    gradient its backward gives (a gather for sliced work: the sum of the
    ranks' gradients, this rank's part; for replicated work: this rank's
    part; a reduce-scatter and a slice: the all-gather; a statistic: the
    sum both ways; f and g; a view across the shards' boundary)."""
    x, cots, ranks = collectives
    k = 4
    own = [slice(j * k, (j + 1) * k) for j in range(2)]
    first = np.concatenate([cots[0][:, :k], cots[1][:, :k]], axis=1)
    for r in ranks:
        j = r["model"]
        ops = r["ops"]
        want = {
            "gather_summed": (x, (cots[0] + cots[1])[:, own[j]]),
            "gather_slice": (x, cots[j][:, own[j]]),
            "reduce_scatter": (3 * x[:, own[j]], (j + 1) * first),
            "slice": (x[:, own[j]], first),
            "stat_sum": (3 * x, (j + 1) * (cots[0] + cots[1])),
            "copy": (x, cots[0] + cots[1]),
            "sum": (3 * x, (j + 1) * cots[j]),
        }
        view_grad = np.zeros_like(x)
        view_grad[:, 2:6] = cots[0][:, :4] + cots[1][:, :4]
        want["view"] = (x[:, 2:6], view_grad[:, own[j]])
        for name, (y, g) in want.items():
            np.testing.assert_allclose(ops[name][0], y, rtol=1e-6, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(ops[name][1], g, rtol=1e-6, atol=1e-6, err_msg=name)
        assert ops["max"] == 1.0


def test_one_model_rank_is_the_identity():
    """With no mesh every tensor-parallel site hands its input back."""
    from repro_torch.distributed import context as mesh_ctx
    t = torch.ones(3, 4)
    for fn in (lambda v: mesh_ctx.model_gather(v, 1, summed=True),
               lambda v: mesh_ctx.model_reduce_scatter(v, 1),
               lambda v: mesh_ctx.model_slice(v, 1), mesh_ctx.model_stat_sum,
               mesh_ctx.model_max, lambda v: mesh_ctx.enter(v, True),
               lambda v: mesh_ctx.leave(v, True),
               lambda v: mesh_ctx.enter_replicated(v, True),
               lambda v: mesh_ctx.leave_replicated(v, True),
               lambda v: mesh_ctx.model_view(v, 1, ((0, 4),), 4)):
        assert fn(t) is t
    assert mesh_ctx.model_rank() == 0


# ---------------------------------------------------------------------------
# Each tensor-parallel site of the model alone, at (data 1, model 2)
# ---------------------------------------------------------------------------

D, B, S = 64, 2, 16
BLOCK_RTOL = 2e-5


def _normal(rng, shape, scale=0.1):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _block_cases():
    """(name, module, kwargs, x, params by rule path) at smoke widths: the
    MLP (gated, with d_ff split evenly, and odd, which the rules keep whole;
    GELU with biases), the embedding (vocabulary rows; an odd vocabulary's
    d columns), attention (MQA with qk_norm, 2 query heads a rank over the
    one KV head; 5 heads as 3 and 2; 1 head, run whole), the Mamba2 mixer
    (packed in_proj and conv) and the MoE layer (einsum, tokens dropped,
    with a shared expert)."""
    rng = np.random.default_rng(17)
    x = _normal(rng, (B, S, D), 1.0)
    cases = []
    for name, ff in (("mlp_even", 96), ("mlp_odd", 99)):
        cases.append((name, "mlp", {"act": "silu", "compute_dtype": "float32", "d_ff": ff},
                      x, {"mlp/wi_gate": _normal(rng, (D, ff)),
                          "mlp/wi_up": _normal(rng, (D, ff)),
                          "mlp/wo": _normal(rng, (ff, D))}))
    cases.append(("mlp_gelu_biases", "mlp",
                  {"act": "gelu_nogate", "compute_dtype": "float32", "d_ff": 96}, x,
                  {"mlp/wi": _normal(rng, (D, 96)), "mlp/bi": _normal(rng, (96,)),
                   "mlp/wo": _normal(rng, (96, D)), "mlp/bo": _normal(rng, (D,))}))
    for name, v in (("embed_rows", 256), ("embed_odd_vocab", 129)):
        tokens = rng.integers(0, v, (B, S)).astype(np.int64)
        cases.append((name, "embed", {"vocab": v, "d": D, "scale": True}, tokens,
                      {"embed": _normal(rng, (v, D), 1.0)}))
    for name, hq, hkv, hd in (("attn_mqa", 4, 1, 32), ("attn_5_heads", 5, 5, 16),
                              ("attn_whole", 1, 1, 32)):
        cases.append((name, "attn", {
            "n_heads": hq, "n_kv_heads": hkv, "head_dim": hd, "kind": "attn",
            "window": 0, "rope_theta": 1e4, "qk_norm": True, "compute_dtype": "float32"},
            x, {"attn/wq": _normal(rng, (D, hq * hd)), "attn/wk": _normal(rng, (D, hkv * hd)),
                "attn/wv": _normal(rng, (D, hkv * hd)), "attn/wo": _normal(rng, (hq * hd, D)),
                "attn/q_norm": _normal(rng, (hd,)), "attn/k_norm": _normal(rng, (hd,))}))
    di, n, hdim = 128, 16, 16
    h, conv_ch = di // hdim, di + 2 * n
    cases.append(("ssm_packed", "ssm", {
        "d_inner": di, "state_dim": n, "head_dim": hdim, "n_groups": 1, "conv_width": 4,
        "chunk": 8, "compute_dtype": "float32"}, x, {
        "ssm/in_proj": _normal(rng, (D, 2 * di + 2 * n + h)),
        "ssm/conv_w": _normal(rng, (4, conv_ch), 0.2), "ssm/conv_b": _normal(rng, (conv_ch,)),
        "ssm/dt_bias": _normal(rng, (h,)), "ssm/A_log": np.log(np.linspace(1, 8, h)).astype(
            np.float32), "ssm/D": _normal(rng, (h,), 1.0), "ssm/norm": _normal(rng, (di,)),
        "ssm/out_proj": _normal(rng, (di, D))}))
    e, f, fs = 8, 32, 48
    cases.append(("moe_einsum_shared", "moe", {
        "n_experts": e, "n_shared": 1, "top_k": 2, "capacity_factor": 0.5, "act": "silu",
        "router_renorm": False, "dispatch": "einsum", "groups": 1,
        "compute_dtype": "float32", "moe_d_ff": f, "d_ff": fs}, x, {
        "moe/router": _normal(rng, (D, e), 0.5), "moe/wi_gate": _normal(rng, (e, D, f)),
        "moe/wi_up": _normal(rng, (e, D, f)), "moe/wo": _normal(rng, (e, f, D)),
        "moe/shared/wi_gate": _normal(rng, (D, fs)), "moe/shared/wi_up": _normal(rng, (D, fs)),
        "moe/shared/wo": _normal(rng, (fs, D)), "moe/shared/gate": _normal(rng, (D, 1))}))
    return cases


BLOCK_CASES = _block_cases()


#: prefill's ``forward`` under model 2: (arch, overrides) with each head
#: layout (vocab-parallel, a tied head over d, an untied head whole)
FORWARD_CASES = {"vocab_head": ("gemma3-1b", {}),
                 "tied_d_head": ("gemma3-1b", {"vocab_size": 129}),
                 "whole_head": ("internvl2-26b", {"vocab_size": 129})}


def _forward_case(arch, overrides):
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_params
    cfg = get_smoke(arch, compute_dtype="float32", **overrides)
    gen = torch.Generator()
    gen.manual_seed(3)
    params = tree_map(lambda t: t.numpy().copy(), init_params(cfg, gen))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)}
    if cfg.input_mode == "mixed":
        batch["patch_embeds"] = _normal(rng, (B, cfg.n_patches, cfg.d_model), 1.0)
    return {"arch": arch, "overrides": {"compute_dtype": "float32", **overrides},
            "params": params, "batch": batch}


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import forward
    rng = np.random.default_rng(23)
    jobs, refs = [], {}
    for name, module, kwargs, x, params in BLOCK_CASES:
        cot = rng.standard_normal((B, S, D)).astype(np.float32)
        case = {"name": module, "kwargs": kwargs, "x": x, "params": params, "cot": cot}
        refs[name] = worker.run_block(**case)
        jobs.append(case)
    fwd_jobs = [_forward_case(*c) for c in FORWARD_CASES.values()]
    for name, case in zip(FORWARD_CASES, fwd_jobs):
        cfg = get_smoke(case["arch"], **case["overrides"])
        with torch.no_grad():
            refs[name] = forward(cfg, worker.to_torch(case["params"]),
                                 worker.to_torch(case["batch"])).numpy()
    out = worker.spawn(2, [worker.Job("blocks", {"cases": jobs}, (1, 2)),
                           worker.Job("forward", {"cases": fwd_jobs}, (1, 2))],
                       tmp_path_factory.mktemp("blocks"))
    results = {name: [r[0][i] for r in out] for i, (name, *_) in enumerate(BLOCK_CASES)}
    results.update({name: [r[1][i] for r in out] for i, name in enumerate(FORWARD_CASES)})
    return refs, results


@pytest.mark.parametrize("name", [c[0] for c in BLOCK_CASES])
def test_block_under_model_2_matches_one_process(blocks, name):
    """Each site on its stored shards at model 2 against the same function
    on the whole weights in one process (itself held against JAX by the
    module's parity tests): the output on every rank, the gradient of the
    input (the same on every rank, after f's sum), and each rank's
    gradient of its stored shard of every weight, to 2e-5 of the largest
    element (fp32, the sums' order only)."""
    refs, results = blocks
    ref = refs[name]
    for rank in results[name]:
        np.testing.assert_allclose(rank["out"], ref["out"], rtol=0,
                                   atol=BLOCK_RTOL * np.abs(ref["out"]).max())
        for path, want in ref["grads"].items():
            got = rank["grads"][path]
            assert got is not None, path
            if path != "x":
                want = want[tuple(slice(a, b) for a, b in rank["slices"][path])]
            assert got.shape == want.shape, path
            scale = max(np.abs(ref["grads"][path]).max(), 1e-30)
            assert np.abs(got - want).max() <= BLOCK_RTOL * scale, path


def test_seq_must_divide_by_the_model_ranks():
    """A sequence that the model ranks do not divide is refused, naming
    both sizes (never split unevenly in silence)."""
    from repro_torch.distributed import context as mesh_ctx
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           size=lambda i: (1, 2)[i])
    mesh_ctx.check_seq(32, mesh)
    with pytest.raises(ValueError, match="33 positions does not split over 2 model"):
        mesh_ctx.check_seq(33, mesh)


@pytest.mark.parametrize("site", ["mlp", "experts"])
def test_hidden_blocks_need_the_whole_hidden_size(site):
    """Over model ranks an MLP's or the experts' hidden block is cut from
    the whole leaf's hidden size: left out, the block raises before any
    communication (a block of 0 units would be a wrong answer, not an
    error)."""
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.models import layers, moe
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           size=lambda i: (1, 2)[i])
    x = torch.ones(1, 4, 8)
    w = {"wi_gate": torch.ones(8, 6), "wi_up": torch.ones(8, 6), "wo": torch.ones(6, 8)}
    with mesh_ctx.set_mesh(mesh):
        if site == "mlp":
            with pytest.raises(ValueError, match="mlp over 2 model ranks needs"):
                layers.mlp(x, w, "silu", "float32")
        else:
            experts = {"router": torch.ones(8, 2),
                       **{k: v.expand(2, *v.shape) for k, v in w.items()}}
            with pytest.raises(ValueError, match="experts over 2 model ranks need"):
                moe.moe_ragged_sharded(x, experts, n_experts=2, top_k=1, act="silu",
                                       router_renorm=False, compute_dtype="float32",
                                       moe_d_ff=0)


@pytest.mark.parametrize("name", FORWARD_CASES)
def test_prefill_forward_under_model_2_matches_one_process(blocks, name):
    """``transformer.forward`` (prefill's logits) on each rank's stored
    shards at model 2 gives every rank the whole logits of one process,
    to 2e-5 of their largest, for each head layout."""
    refs, results = blocks
    for logits in results[name]:
        assert logits.shape == refs[name].shape
        np.testing.assert_allclose(logits, refs[name], rtol=0,
                                   atol=BLOCK_RTOL * np.abs(refs[name]).max())
