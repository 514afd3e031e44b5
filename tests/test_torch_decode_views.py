"""The cache views of decode under a ``model`` axis, at full size, with no
allocation: for every architecture with a decode step and every mesh, the
``model`` ranks' views (``sharding.cache_view``) tile each cache leaf's
stored shard exactly (``cache_shardings`` on the decode cell's meta
cache), and each is the whole dim where the spec keeps it whole."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import SHAPES, cache_specs  # noqa: E402

MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = [a for a in all_archs() if get(a).has_decode()]


def _tiles(ranges, n, split, m):
    """The ranks' ranges tile [0, n) in rank order, 1/m each (split), or
    are each the whole (not split)."""
    if not split:
        return all(r == (0, n) for r in ranges)
    return (all(b - a == n // m for a, b in ranges) and ranges[0][0] == 0
            and all(ranges[i][1] == ranges[i + 1][0] for i in range(m - 1))
            and ranges[-1][1] == n)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_views_tile_the_stored_shards(arch, mesh_name):
    cfg = get(arch)
    sizes = shd.AxisSizes(MESHES[mesh_name])
    m = MESHES[mesh_name]["model"]
    cache = cache_specs(cfg, SHAPES["decode_32k"])
    assert all(leaf.device.type == "meta" for leaf in bridge.flatten(cache).values())
    specs = dict(zip(bridge.flatten(cache), shd.spec_leaves(shd.cache_shardings(cache, sizes))))
    views = [shd.cache_view(cfg, m, j) for j in range(m)]
    seen = set()
    for path, leaf in bridge.flatten(cache).items():
        name, spec = path.split("/")[-1], specs[path]
        if name in ("k", "v"):
            a = [v["attn"] for v in views]
            assert _tiles([v["kv_heads"] for v in a], cfg.n_kv_heads,
                          spec[-2] == "model", m), path
            assert _tiles([v["d"] for v in a], cfg.head_dim, spec[-1] == "model", m), path
            split = {"heads": spec[-2] == "model", "d": spec[-1] == "model"}
            assert all(v["split"] == next((k for k, s in split.items() if s), "whole")
                       for v in a)
            g = cfg.n_heads // cfg.n_kv_heads
            assert all(v["q_heads"] == (v["kv_heads"][0] * g, v["kv_heads"][1] * g)
                       for v in a)
        elif name == "ssm":
            s = [v["ssm"] for v in views]
            assert _tiles([v["heads"] for v in s], leaf.shape[-3],
                          spec[-3] == "model", m), path
            assert all(v["whole"] == (spec[-3] != "model") for v in s)
        elif name == "conv":
            s = [v["ssm"] for v in views]
            assert _tiles([v["conv"] for v in s], leaf.shape[-1],
                          spec[-1] == "model", m), path
            assert all(v["conv_split"] == (spec[-1] == "model") for v in s)
        else:
            assert name == "pos" and tuple(spec) == (), path
            continue
        seen.add(name)
    want = ({"k", "v"} if cfg.n_heads else set()) | ({"ssm", "conv"} if cfg.ssm_state
                                                      else set())
    assert seen == want


@pytest.mark.parametrize("m", [2, 4, 16])
def test_leaf_block_is_the_rules_block_or_the_whole(m):
    for j in range(m):
        assert shd.leaf_block(64, 64 // m, m, j) == (j * 64 // m, (j + 1) * 64 // m)
        assert shd.leaf_block(64, 64, m, j) == (0, 64)


def test_the_placements_decode_is_written_for():
    """The placements the decode paths are written for (full configs)."""
    def attn(arch, m):
        v = shd.cache_view(get(arch), m, 0)["attn"]
        return v["split"], v["kv_heads"], v["d"]

    assert attn("gemma3-1b", 2) == ("d", (0, 1), (0, 128))
    assert attn("gemma3-1b", 16) == ("d", (0, 1), (0, 16))
    assert attn("hymba-1.5b", 16) == ("d", (0, 5), (0, 4))
    assert attn("h2o-danube-1.8b", 2) == ("heads", (0, 4), (0, 80))
    assert attn("internvl2-26b", 16) == ("d", (0, 8), (0, 8))
    assert attn("olmoe-1b-7b", 16) == ("heads", (0, 1), (0, 128))
    hymba = [shd.cache_view(get("hymba-1.5b"), m, 0)["ssm"] for m in (2, 16)]
    assert (hymba[0]["heads"], hymba[0]["whole"], hymba[0]["conv"]) == ((0, 25), False,
                                                                        (0, 1616))
    assert (hymba[1]["heads"], hymba[1]["whole"], hymba[1]["conv"]) == ((0, 50), True,
                                                                        (0, 202))
    mamba = shd.cache_view(get("mamba2-780m"), 16, 15)["ssm"]
    assert (mamba["heads"], mamba["conv"]) == ((45, 48), (3120, 3328))
