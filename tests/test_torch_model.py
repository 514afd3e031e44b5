"""Whole-model parity of the port against the JAX package, on the smoke
configs of every ported architecture (dense, mamba2, MoE, hymba, the
hubert encoder on frame embeddings, the internvl2 backbone on patch
embeddings and tokens), with the JAX weights bridged across.  hubert is
encoder-only: its decode cases hold that both packages refuse to decode.

Tolerances on the logits (|logits| ≲ 1 here):
* fp32 compute: 1e-4 (summation order only, over a few layers);
* bf16 compute: 2e-2 — the logits are bf16, whose step is 2**-7 ≈ 7.8e-3
  between 1 and 2, and the residual stream is rounded to bf16 after every
  layer; measured differences are one step (3.9e-3 at |logits| ≤ 1.5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt  # noqa: E402
from repro.configs import (  # noqa: E402
    all_archs as jall_archs, get as jget, get_smoke as jget_smoke,
)
from repro.models import Model as JModel  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import NOT_PORTED, all_archs, get, get_smoke  # noqa: E402
from repro_torch.models import Model, compute_copy  # noqa: E402
from torch_parity import assert_close, both, np32  # noqa: E402

ARCHS = all_archs()
TOLS = {"float32": 1e-4, "bfloat16": 2e-2}
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arch, **overrides):
    """(JAX model, JAX params, port model, port params) with shared weights."""
    jcfg = jget_smoke(arch, **overrides)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke(arch, **overrides), device="cpu")
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    return jm, jp, tm, tp


def _tokens(cfg, b, s, seed=0):
    return both(np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)))


def _inputs(cfg, b, s, seed=0):
    """(JAX batch, port batch) of ``s`` positions by the input mode: tokens;
    frame embeddings (``embeds``); or min(n_patches, s // 2) patch
    embeddings then tokens (``mixed``)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        pairs = {"embeds": both(rng.standard_normal((b, s, cfg.d_model)) * 0.1)}
    elif cfg.input_mode == "mixed":
        npatch = min(cfg.n_patches, s // 2)
        pairs = {"patch_embeds": both(rng.standard_normal((b, npatch, cfg.d_model)) * 0.1),
                 "tokens": both(rng.integers(0, cfg.vocab_size, (b, s - npatch)))}
    else:
        pairs = {"tokens": both(rng.integers(0, cfg.vocab_size, (b, s)))}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


SSM_KINDS = ("ssm", "hyb_g", "hyb_l")


def _prefill_len(cfg):
    """24 for the dense archs (past the smoke window of 16); for an arch
    with SSM layers (mamba2, hymba's hybrid layers) two chunks (32 at the
    smoke chunk of 16, past hymba's smoke window of 16), since the
    reference rejects a sequence that is not a multiple of its chunk."""
    if any(kind in SSM_KINDS for kind in cfg.layer_types):
        return 2 * cfg.ssm_chunk
    return 24


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for port, ref in ((get(arch), jget(arch)), (get_smoke(arch), jget_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.segments() == ref.segments()
        assert port.param_count() == ref.param_count()
        assert port.padded_vocab == ref.padded_vocab
        assert port.has_decode() == ref.has_decode()


def test_unported_arch_raises():
    """Every architecture of the reference is ported; an unknown id raises."""
    assert NOT_PORTED == ()
    assert set(all_archs()) == set(jall_archs())
    with pytest.raises(KeyError):
        get("no-such-arch")
    with pytest.raises(KeyError):
        get_smoke("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,use_kernels", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_forward_matches_jax(arch, dtype, use_kernels):
    jm, jp, tm, tp = _pair(arch, compute_dtype=dtype, use_kernels=use_kernels)
    s = _prefill_len(tm.cfg)
    jb, tb = _inputs(tm.cfg, 2, s)
    want, _ = jax.jit(jm.forward)(jp, jb)
    with torch.inference_mode():
        got = tm.forward(tp, tb)
    assert got.shape == (2, s, tm.cfg.vocab_size)
    assert_close(got, want, TOLS[dtype])
    # serving from the compute-dtype copy gives the same logits
    with torch.inference_mode():
        again = tm.forward(compute_copy(tm.cfg, tp), tb)
    torch.testing.assert_close(again, got, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, compute_dtype=dtype)
    tj, tt = _tokens(tm.cfg, 2, 8, seed=1)
    jc = jm.init_cache(2, 12, dtype=JNP_DT[dtype])
    jstep = jax.jit(jm.decode_step)
    if not tm.cfg.has_decode():
        # encoder-only: the reference refuses the step, the port its cache
        with pytest.raises(ValueError, match="encoder-only"):
            jstep(jp, jc, tj[:, :1])
        with pytest.raises(ValueError, match="encoder-only"):
            tm.init_cache(2, 12, dtype=dtype)
        with pytest.raises(ValueError, match="encoder-only"):
            tm.decode_step(tp, {"pos": 0, "segments": []}, tt[:, :1])
        return
    tc = tm.init_cache(2, 12, dtype=dtype)
    for t in range(8):
        want, jc = jstep(jp, jc, tj[:, t:t + 1])
        with torch.inference_mode():
            got, tc = tm.decode_step(tp, tc, tt[:, t:t + 1])
        assert_close(got, want, TOLS[dtype])
        assert tc["pos"] == int(jc["pos"]) == t + 1
    assert_caches_match(tc, jc, TOLS[dtype])


def assert_caches_match(tc, jc, tol):
    """Every tensor of the port's cache (nested for a hybrid layer: attn k
    and v, ssm conv and ssm) has the JAX cache's dtype and values."""
    want = bridge.flatten(jax.device_get(jc["segments"]))
    got = bridge.flatten(tc["segments"])
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == TORCH_DT[str(w.dtype)], key
        assert_close(got[key], w, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces the forward logits (the port alone,
    as tests/test_archs_smoke.py checks the reference), threshold 0.1.  A
    VLM's prompt is text alone here (no patch embeddings: decode takes
    tokens only); an encoder-only model has no decode to compare."""
    tm = Model(get_smoke(arch), device="cpu")
    params = tm.init(0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (1, 8)))
    if not tm.cfg.has_decode():
        with pytest.raises(ValueError, match="encoder-only"):
            tm.init_cache(1, 16, dtype="float32")
        return
    batch = {"tokens": toks}
    if tm.cfg.input_mode == "mixed":
        batch["patch_embeds"] = torch.zeros((1, 0, tm.cfg.d_model))
    with torch.inference_mode():
        logits_all = tm.forward(params, batch)
        cache = tm.init_cache(1, 16, dtype="float32")
        outs = []
        for t in range(8):
            lg, cache = tm.decode_step(params, cache, toks[:, t:t + 1])
            outs.append(lg)
    err = (torch.stack(outs, dim=1).float() - logits_all.float()).abs().max()
    assert float(err) < 0.1, f"decode/prefill mismatch {float(err)}"


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_keys(arch):
    jp = jax.device_get(JModel(jget_smoke(arch)).init(jax.random.PRNGKey(3)))
    tp = bridge.params_from_numpy(jp, "cpu")
    back = bridge.params_to_numpy(tp)
    want = ckpt._flatten(jp)
    got = bridge.flatten(back)
    assert set(got) == set(want)
    assert set(bridge.flatten(tp)) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(got[key], np.asarray(arr))
    # the port's own init has the same layout as the reference's
    own = Model(get_smoke(arch), device="cpu").init(0)
    own_flat = bridge.flatten(own)
    assert set(own_flat) == set(want)
    for key, arr in want.items():
        assert tuple(own_flat[key].shape) == np.asarray(arr).shape, key
        assert own_flat[key].dtype == torch.float32
