"""The reference's decode cells (``decode_32k``: 128 sequences on a
32,768-deep cache; ``long_500k``: one on 524,288) at its cell options
(``launch.dryrun.cell_config``: bf16 parameters, the vocabulary padded to
256), held against the JAX package on the CPU at smoke widths and the
cells' depths:

* a deep cache: 12,288 positions, three of the flash-decode's 4096-entry
  blocks under its online softmax, every ring of a windowed layer wrapped
  many times over; filled from a numpy seed, the same values handed to
  both packages with the same bf16 parameters; 3 tokens decoded from
  position 12,285, so the last writes the cache's last entry;
* past the cache's end, where the write index clamps as the reference's
  ``dynamic_update_slice`` does;
* at position 524,285 for the smoke configs whose caches stay small there
  (h2o-danube: rings only; mamba2: SSM state only);
* a vocabulary the padding lengthens (300 columns, padded to 512).

Tolerance: 2e-2 absolute and relative, ``test_torch_model.py``'s bf16
decode tolerance, on the logits and on every cache leaf (a K entry of
|k| ~ 3 written a bf16 step apart is 0.016 away).

Then ``chip_smoke.py``'s decode_cells phase in its CPU form, at smoke size:
the cache-fill helper, the graphed step against the eager one (on the CPU
``GraphedServeStep`` runs the step eagerly on its own buffers; bit-equal),
the decode attention at depth against a dense fp32 softmax, the rounding
gate and the engine at the cell's slots.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.launch.dryrun import cell_config  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step, init_cache, init_serving_params, promote_conv,
)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_parity import assert_close  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TOL = 2e-2
#: the reference's cell options, as its ``run_cell`` sets them
OPTS = dict(loss_chunk=1024, vocab_pad=256, param_dtype="bfloat16",
            attn_q_chunk=1024, seq_shard=True)
DECODERS = [a for a in all_archs() if get(a).has_decode()]
BATCH, TOKENS = 2, 3
DEEP = 3 * 4096
LONG = SHAPES["long_500k"].seq_len


def _to_port(tree):
    """A JAX tree as CPU tensors of the same dtypes (bf16 through fp32, which
    holds every bf16 value)."""
    def one(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x, copy=True))
    return tree_map(one, jax.device_get(tree))


def _decode_both(arch, length, start, overrides=None, seed=0):
    """Both packages' decode of TOKENS tokens on ``arch``'s smoke config at
    the cell options (with ``overrides``) from one cache of ``length``
    positions filled from a numpy seed at ``start``: [(port logits, JAX
    logits)] a token and the two caches after."""
    cfg = cell_config(arch, True, overrides=overrides)
    jcfg = dataclasses.replace(jget_smoke(arch), **OPTS, **(overrides or {}))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = _to_port(jp)
    rng = np.random.default_rng(seed)
    segments = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32)
                                 ).astype(leaf.dtype),
        jm.init_cache(BATCH, length)["segments"])
    jc = {"pos": jnp.asarray(start, jnp.int32), "segments": segments}
    cache = _to_port(jc)
    cache["pos"] = torch.tensor(start, dtype=torch.int32)
    promote_conv(cfg, cache)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (BATCH, TOKENS))
    jstep = jax.jit(jm.decode_step)
    out = []
    for t in range(TOKENS):
        want, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        with torch.inference_mode():
            got, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]))
        out.append((got, want))
    return cfg, out, cache, jc


def _assert_agree(cfg, out, cache, jc, end):
    for got, want in out:
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (BATCH, cfg.vocab_size)
        assert_close(got, want, TOL)
    assert int(cache["pos"]) == int(jc["pos"]) == end
    want = bridge.flatten(jax.device_get(jc["segments"]))
    got = bridge.flatten(cache["segments"])
    assert set(got) == set(want)
    for key, w in want.items():
        assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype), key
        assert_close(got[key], w, TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_deep_cache_decode_matches_jax(arch):
    """Three 4096-entry blocks, the rings wrapped, the last entry written."""
    cfg, out, cache, jc = _decode_both(arch, DEEP, DEEP - TOKENS)
    _assert_agree(cfg, out, cache, jc, DEEP)


def test_decode_past_the_cache_end_matches_jax():
    """From the last entry on: the global layer's write clamps to it and
    its valid length stays the cache's, the windowed layers' rings wrap."""
    cfg, out, cache, jc = _decode_both("gemma3-1b", DEEP, DEEP - 1)
    _assert_agree(cfg, out, cache, jc, DEEP - 1 + TOKENS)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m"])
def test_long_500k_position_matches_jax(arch):
    """long_500k's last positions, where the smoke config's cache is small:
    danube's rings, mamba2's state; RoPE at positions past 2**19."""
    cfg, out, cache, jc = _decode_both(arch, LONG, LONG - TOKENS)
    assert all(leaf.shape[2] < 64 for leaf in tree_leaves(cache["segments"]))
    _assert_agree(cfg, out, cache, jc, LONG)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_padded_vocabulary_decode_matches_jax(arch):
    """300 columns, padded to 512 at the cell options: the padding never
    reaches the logits."""
    cfg, out, cache, jc = _decode_both(arch, 8192, 8192 - TOKENS, {"vocab_size": 300})
    assert cfg.padded_vocab == 512
    _assert_agree(cfg, out, cache, jc, 8192)


# -- chip_smoke.py's decode_cells phase, its CPU form ----------------------


def test_the_cells_and_the_rounding_gates_cut():
    """Each arch of the phase takes both cells (each has an SSM or a
    window); a full-attention arch only decode_32k.  The rounding gate's cut
    holds every kind of layer: gemma3-1b's first global layer is its
    sixth."""
    for arch in cs.DECODE_CELL_ARCHS:
        assert [s.name for s in cs.decode_cell_shapes(cell_config(arch))] == [
            "decode_32k", "long_500k"]
    assert [s.name for s in cs.decode_cell_shapes(cell_config("gemma-7b"))] == ["decode_32k"]
    assert {arch: cs.decode_cell_depth(get(arch)) for arch in cs.DECODE_CELL_ARCHS} == {
        "gemma3-1b": 6, "mamba2-780m": 4, "hymba-1.5b": 4, "h2o-danube-1.8b": 4}
    assert (SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len) == (128, 32768)
    assert (SHAPES["long_500k"].global_batch, LONG) == (1, 524288)


@pytest.mark.parametrize("arch", cs.DECODE_CELL_ARCHS)
def test_fill_cache_draws_every_leaf_in_place(arch):
    """Every K, V, conv and SSM leaf drawn from N(0, 1) in its own dtype and
    storage, the same values from the same seed, other values from another;
    ``pos`` where asked."""
    cfg = cell_config(arch, True)
    cache = init_cache(cfg, 3, 40, device="cpu")
    storages = [leaf.untyped_storage().data_ptr() for leaf in tree_leaves(cache)]
    dtypes = [leaf.dtype for leaf in tree_leaves(cache)]
    assert cs.fill_cache(cache, 5, 37) is cache
    assert [leaf.untyped_storage().data_ptr() for leaf in tree_leaves(cache)] == storages
    assert [leaf.dtype for leaf in tree_leaves(cache)] == dtypes
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 37
    first = {k: v.clone() for k, v in bridge.flatten(cache["segments"]).items()}
    for key, leaf in first.items():
        x = leaf.float()
        assert bool((x != 0).all()), key              # every slab drawn
        assert abs(x.mean().item()) < 0.1 and 0.9 < x.std().item() < 1.1, key
        # no two slabs alike
        flat = x.reshape(x.shape[0] * x.shape[1], -1)
        assert len({tuple(r[:4].tolist()) for r in flat}) == flat.shape[0], key
    cs.fill_cache(cache, 5, 3)
    assert int(cache["pos"]) == 3
    for key, leaf in bridge.flatten(cache["segments"]).items():
        assert torch.equal(leaf, first[key]), key
    cs.fill_cache(cache, 6, 3)
    assert not any(torch.equal(leaf, first[key])
                   for key, leaf in bridge.flatten(cache["segments"]).items())


def test_caches_equal_sees_one_element():
    cfg = cell_config("hymba-1.5b", True)
    a = cs.fill_cache(init_cache(cfg, 2, 24, device="cpu"), 1, 20)
    b = cs.fill_cache(init_cache(cfg, 2, 24, device="cpu"), 1, 20)
    assert cs.caches_equal(a, b)
    b["segments"][0]["ssm"]["ssm"][0, 1, 0, 0, 0] += 1
    assert not cs.caches_equal(a, b)
    b = cs.fill_cache(b, 1, 21)
    assert not cs.caches_equal(a, b)


def test_moving_by_a_bf16_step():
    """Every element moved up or down by one step at random, in place."""
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.ones(1000, dtype=torch.bfloat16)
    tree = {"x": x, "n": torch.arange(3)}
    cs.move_by_a_bf16_step(tree, gen)
    assert set(x.float().tolist()) == {1 + cs.DECODE_CELL_MOVE, 1 - cs.DECODE_CELL_MOVE}
    assert 400 < int((x > 1).sum()) < 600
    assert torch.equal(tree["n"], torch.arange(3))


SMALL = {"decode_32k": ShapeConfig("decode_32k", 48, 4, "decode"),
         "long_500k": ShapeConfig("long_500k", 8192, 1, "decode")}


@pytest.mark.parametrize("arch", cs.DECODE_CELL_ARCHS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_phase_graphed_against_eager_on_the_cpu(arch, cell, capsys):
    """``decode_cell_case`` at smoke size: the graphed step (eager on its own
    buffers on the CPU) bit-equal to the eager step on a second cache filled
    alike, launches and collectives equal (none), finite logits of the
    cell's shape, the attention at depth within the kernel gates' scale of
    a dense fp32 softmax, the rounding gate, no failure; one decode_cell
    line."""
    cfg = cell_config(arch, True)
    gen = torch.Generator()
    gen.manual_seed(cs.DECODE_CELL_SEED)
    params = init_serving_params(cfg, gen)
    shape = SMALL[cell]
    out = cs.decode_cell_case(cfg, params, torch.device("cpu"), None, shape, 0)
    assert out["failures"] == [] and out["bit_equal"] and out["logits_finite"]
    assert out["logits_shape"] == [cs.DECODE_CELL_TOKENS * shape.global_batch, cfg.vocab_size]
    assert out["start_pos"] == shape.seq_len - cs.DECODE_CELL_TOKENS
    assert out["collectives_a_step"] == {} and not out["graph"]
    assert out["rounding"]["within_bounds"]
    assert out["rounding"]["layers"] == cs.decode_cell_depth(cfg)
    depth = out["attention_at_depth"]
    if arch == "mamba2-780m":
        assert depth is None
    else:
        assert depth["within"] and depth["row_rel_err"] <= cs.KERNEL_TOL
        assert depth["shape"][1] == min(shape.seq_len, cfg.window if arch == "h2o-danube-1.8b"
                                        else shape.seq_len)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if '"phase": "decode_cell"' in line]
    assert len(lines) == 1


def test_attention_at_depth_sees_a_wrong_block():
    """The dense reference reads far off a decode attention that skips a
    block of the cache."""
    from repro_torch.models import attention
    cfg = cell_config("gemma3-1b", True)
    cache = cs.fill_cache(init_cache(cfg, 2, 8192, device="cpu"), 3, 8190)
    assert cs.attention_at_depth(cfg, cache, torch.device("cpu"))["within"]
    real = attention.decode_attention

    def skips_a_block(q, k, v, lengths, softcap=0.0, **kw):
        return real(q, k[:, 4096:], v[:, 4096:], lengths - 4096, softcap, **kw)

    attention.decode_attention = skips_a_block
    try:
        assert not cs.attention_at_depth(cfg, cache, torch.device("cpu"))["within"]
    finally:
        attention.decode_attention = real


def test_the_engine_at_the_cells_slots_on_the_cpu():
    """``decode_cell_engine``: one request a slot, DECODE_CELL_NEW new tokens
    each, in 1 + DECODE_CELL_NEW - 1 ticks (the prompt's token gives the
    first)."""
    cfg = cell_config("hymba-1.5b", True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_serving_params(cfg, gen)
    out = cs.decode_cell_engine(cfg, params, torch.device("cpu"), SMALL["decode_32k"])
    assert out["ok"] and out["requests"] == 4 and out["ticks"] == cs.DECODE_CELL_NEW
    assert out["new_tokens"] == 4 * cs.DECODE_CELL_NEW and out["graph_launches"] is None
