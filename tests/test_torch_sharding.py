"""The port's sharding rules and abstract specs against the JAX package's,
with no allocation and no device.

For every architecture at full size, both sides' trees are abstract (JAX's
``eval_shape``, the port's meta tensors), and both sides get the same mesh
object: a ``jax.sharding.AbstractMesh`` of the shape under test, which has
axis sizes and no devices.  Every leaf's spec of the parameters, the
optimizer state (ZeRO-1), the step, each cell's batch and each decode
cell's cache must equal the reference's ``PartitionSpec`` entries exactly;
the abstract trees, ``input_specs`` and ``cache_specs`` must equal the
reference's in path, shape and dtype, and ``cell_applicable`` must agree.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro.configs import get as jget  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.config import cell_applicable as jcell_applicable  # noqa: E402
from repro.models.model import cache_specs as jcache_specs  # noqa: E402
from repro.models.model import input_specs as jinput_specs  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.train.step import abstract_train_state as jabstract_state  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import SHAPES, Model, cache_specs, cell_applicable, input_specs  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train.step import abstract_train_state  # noqa: E402

ARCHS = all_archs()
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, shape) for arch in ARCHS for shape in SHAPES]


def _mesh(name):
    return AbstractMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    return jabstract_state(jget(arch), JAdamW(schedule=jcosine(1e-3, 2, 10)))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return abstract_train_state(get(arch), AdamW(schedule=cosine_schedule(1e-3, 2, 10)))


def _flat(tree) -> dict:
    """Leaves by checkpoint path, for a JAX or a port tree."""
    return bridge.flatten(tree)


def _jax_specs(shardings) -> dict:
    """{path: PartitionSpec entries} of a tree of NamedShardings."""
    return {k: tuple(v.spec) for k, v in _flat(shardings).items()}


def _port_specs(specs, like) -> dict:
    """{path: Spec entries} of the port's spec tree (a Spec is a leaf: the
    paths come from the tree it was made for)."""
    keys, leaves = list(_flat(like)), shd.spec_leaves(specs)
    assert len(keys) == len(leaves)
    return {k: tuple(v) for k, v in zip(keys, leaves)}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _assert_same_abstract(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.device.type == "meta", key
        assert tuple(g.shape) == tuple(w.shape), key
        assert _dtype(g) == _dtype(w), key


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_matches_eval_shape(arch):
    """Params, m, v, master, count and step: the same paths, shapes and
    dtypes as ``jax.eval_shape``, all on the meta device."""
    _assert_same_abstract(_port_state(arch), _jax_state(arch))
    _assert_same_abstract(Model(get(arch), "cpu").init_abstract(),
                          JModel(jget(arch)).init_abstract())


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch, mesh_name):
    """Every leaf of params (fit_spec, the odd-vocab fallback), opt (ZeRO-1
    past 1 MiB) and step, at full size."""
    mesh = _mesh(mesh_name)
    want = _jax_specs(jshd.state_shardings(_jax_state(arch), mesh))
    state = _port_state(arch)
    got = _port_specs(shd.state_shardings(state, mesh), state)
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_match_reference(arch, shape):
    """``cell_applicable``, and for each applicable cell ``input_specs`` (and
    for a decode cell ``cache_specs``) in path, shape and dtype, and their
    batch and cache specs on every mesh."""
    cfg, jcfg = get(arch), jget(arch)
    ok = cell_applicable(cfg, SHAPES[shape])
    assert ok == jcell_applicable(jcfg, JSHAPES[shape])
    if not ok[0]:
        return
    inputs, jinputs = input_specs(cfg, SHAPES[shape]), jinput_specs(jcfg, JSHAPES[shape])
    _assert_same_abstract(inputs, jinputs)
    cache = jcache = None
    if SHAPES[shape].kind == "decode":
        cache, jcache = cache_specs(cfg, SHAPES[shape]), jcache_specs(jcfg, JSHAPES[shape])
        _assert_same_abstract(cache, jcache)
    for mesh_name in MESHES:
        mesh = _mesh(mesh_name)
        assert (_port_specs(shd.batch_shardings(inputs, mesh), inputs)
                == _jax_specs(jshd.batch_shardings(jinputs, mesh))), mesh_name
        if cache is not None:
            assert (_port_specs(shd.cache_shardings(cache, mesh), cache)
                    == _jax_specs(jshd.cache_shardings(jcache, mesh))), mesh_name


def test_shapes_match_reference():
    assert {k: (v.seq_len, v.global_batch, v.kind, v.tokens) for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind, v.tokens) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_derived_counts_match_reference(arch):
    cfg, jcfg = get(arch), jget(arch)
    assert cfg.subquadratic() == jcfg.subquadratic()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("mesh_name", MESHES)
def test_single_rules_match_reference(mesh_name):
    """fit_spec (tuple axes, the odd-vocab fallback, batch of one),
    zero1_spec (largest free axis, the 1 MiB threshold) and batch_spec, one
    leaf at a time."""
    from jax.sharding import PartitionSpec as P
    mesh = _mesh(mesh_name)
    dp = ("pod", "data") if "pod" in mesh.axis_names else "data"
    cases = [(("model", None), (92553, 6144)), (("model", None), (92672, 6144)),
             ((dp,), (512,)), ((dp,), (100,)), (("data", None), (1, 1)),
             ((None, "model"), (1024, 4096)), ((None,), (8,)),
             ((None, None, "model"), (3, 64, 2048))]
    for spec, shape in cases:
        want = tuple(jshd.fit_spec(P(*spec), shape, mesh))
        assert tuple(shd.fit_spec(shd.Spec(spec), shape, mesh)) == want, (spec, shape)
        leaf = jax.ShapeDtypeStruct(shape, "float32")
        fitted = jshd.fit_spec(P(*spec), shape, mesh)
        assert (tuple(shd.zero1_spec(shd.Spec(tuple(fitted)), shape, mesh))
                == tuple(jshd.zero1_spec(fitted, leaf, mesh))), (spec, shape)
    assert tuple(shd.batch_spec(mesh)) == tuple(jshd.batch_spec(mesh))


def test_placements_follow_mesh_order():
    """A dim over ("pod", "data") is Shard on both mesh dims; an entry out of
    mesh order, or a mesh axis on two dims, raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Names:                     # placements reads the axis names only
        mesh_dim_names = ("pod", "data", "model")

    assert shd.placements(shd.Spec(((("pod", "data")), None, "model")), Names()) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.Spec((None, "model")), Names()) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(shd.Spec(((("data", "pod")),)), Names())
    with pytest.raises(ValueError, match="two dims"):
        shd.placements(shd.Spec(("model", "model")), Names())
