"""The serving init (``Model.init(serving=True)``,
``transformer.init_serving_params``) on the CPU, for every ported
architecture at smoke size: the tree ``compute_copy(init_params(...))``
would give (paths, shapes, dtypes), made without the fp32 tree.

* deterministic for a seed;
* each drawn leaf's std within 10% of its init's (0.02; 0.2 for the SSM
  conv) and its mean within five standard errors of 0, every other leaf
  the fp32 init's constant;
* no fp32 draw larger than one block (``_DRAW_ELEMENTS``, patched small
  here, or one slice of a stacked leaf's leading axis);
* ``ServeEngine`` serves from the tree without copying a leaf.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import all_archs, get_smoke  # noqa: E402
from repro_torch.models import Model, compute_copy  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)   # the suite runs under 6 xdist workers

ARCHS = all_archs()
#: leaves the init draws (the rest are constants) and their std
DRAWN = {"conv_w": 0.2, "router": 0.02, "gate": 0.02, "embed": 0.02,
         "lm_head": 0.02, "frontend_proj": 0.02, "wq": 0.02, "wk": 0.02,
         "wv": 0.02, "wo": 0.02, "wi_gate": 0.02, "wi_up": 0.02, "wi": 0.02,
         "in_proj": 0.02, "out_proj": 0.02}
STD_REL_TOL = 0.10


def _inits(arch, seed=0):
    model = Model(get_smoke(arch), "cpu")
    return model, bridge.flatten(model.init(seed, serving=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_tree_is_the_compute_copys_layout(arch):
    model, got = _inits(arch)
    want = bridge.flatten(compute_copy(model.cfg, model.init(0)))
    assert list(got) == list(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert got[key].dtype == w.dtype, key
    # the cast leaves are in the compute dtype (bf16), the rest in fp32
    assert got["embed"].dtype == torch.bfloat16
    assert any(t.dtype == torch.float32 for t in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_init_is_deterministic_for_a_seed(arch):
    _, a = _inits(arch, seed=3)
    _, b = _inits(arch, seed=3)
    _, c = _inits(arch, seed=4)
    assert all(torch.equal(a[key], b[key]) for key in a)
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("arch", ARCHS)
def test_drawn_leaves_have_the_inits_spread_and_the_rest_its_constants(arch):
    model, got = _inits(arch)
    fp32 = bridge.flatten(model.init(0))
    for key, leaf in got.items():
        name = key.rsplit("/", 1)[-1]
        if name in DRAWN:
            std = leaf.float().std().item()
            assert abs(std - DRAWN[name]) <= STD_REL_TOL * DRAWN[name], (key, std)
            # five standard errors of the mean of n draws
            assert abs(leaf.float().mean().item()) <= 5 * DRAWN[name] / leaf.numel() ** 0.5, key
        else:
            torch.testing.assert_close(leaf, fp32[key].to(leaf.dtype), atol=0, rtol=0,
                                       msg=key)


@pytest.mark.parametrize("arch", ["internvl2-26b", "qwen2-moe-a2.7b", "hubert-xlarge",
                                  "hymba-1.5b"])
def test_no_draw_is_larger_than_a_block(monkeypatch, arch):
    """With blocks of 4096 elements, a leaf the serving tree casts is drawn
    a block of its leading axis at a time (one layer, or rows of the
    embedding and the head), never whole."""
    monkeypatch.setattr(tfm, "_DRAW_ELEMENTS", 4096)
    sizes = []
    randn = torch.randn

    def recording(*args, **kwargs):
        out = randn(*args, **kwargs)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", recording)
    cfg = get_smoke(arch)
    tree = bridge.flatten(Model(cfg, "cpu").init(0, serving=True))
    cast = {k: t for k, t in tree.items() if k.rsplit("/", 1)[-1] in tfm._CAST_ON_USE}
    slice_of = max(math.prod(t.shape[1:]) for t in cast.values())
    other = max(t.numel() for k, t in tree.items() if k not in cast)
    assert max(sizes) <= max(4096, slice_of, other)


def test_a_leaf_is_drawn_a_block_of_its_leading_axis_at_a_time(monkeypatch):
    """A stacked leaf one layer a draw when a layer passes the block; a
    table of rows as many rows a draw as fit the block."""
    monkeypatch.setattr(tfm, "_DRAW_ELEMENTS", 4096)
    sizes = []
    randn = torch.randn

    def recording(*args, **kwargs):
        out = randn(*args, **kwargs)
        sizes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "randn", recording)
    gen = torch.Generator()
    gen.manual_seed(0)
    leaves = tfm._Leaves(get_smoke("gemma3-1b"), gen, serving=True)
    stacked = leaves.normal("wi_gate", (3, 64, 128))
    assert sizes == [(1, 64, 128)] * 3 and stacked.dtype == torch.bfloat16
    sizes.clear()
    table = leaves.normal("embed", (1000, 64))
    assert sizes == [(64, 64)] * 15 + [(40, 64)] and table.shape == (1000, 64)
    assert abs(table.float().std().item() - 0.02) <= STD_REL_TOL * 0.02


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_keeps_the_trees_storage(arch):
    model, _ = _inits(arch)
    params = model.init(0, serving=True)
    kept = compute_copy(model.cfg, params)
    ptrs = {k: t.data_ptr() for k, t in bridge.flatten(params).items()}
    assert {k: t.data_ptr() for k, t in bridge.flatten(kept).items()} == ptrs
    if not model.cfg.has_decode():
        with pytest.raises(ValueError, match="encoder-only"):
            ServeEngine(model.cfg, params, slots=2, max_len=8, device="cpu")
        return
    engine = ServeEngine(model.cfg, params, slots=2, max_len=8, device="cpu")
    assert {k: t.data_ptr() for k, t in bridge.flatten(engine.params).items()} == ptrs
    engine.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    done = engine.run()
    assert len(done) == 1 and len(done[0].generated) == 2
    assert np.all(np.asarray(done[0].generated) >= 0)
