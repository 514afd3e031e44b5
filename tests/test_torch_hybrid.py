"""hymba's hybrid layers (``hyb_g``, ``hyb_l``: an attention branch and a
Mamba2 branch on the same normed input, fused as the mean of their
RMS-normed outputs) in the port, against the JAX package on the smoke
config with the JAX weights bridged across.

* the whole forward, and ``layer_body`` of each hybrid kind: a prefill
  past the smoke window and one decode step on a filled cache (the
  ``hyb_l`` ring past its wrap), fp32 within 2e-5 and bf16 within 2e-2
  (the model tests' bf16 bound: one bf16 step of |x| ≲ 2 is 7.8e-3);
* decode token by token past the window (``max_len`` 24, 20 steps: the
  ``hyb_l`` ring of 16 wraps at step 16), logits and every cache tensor's
  dtype and values at every step;
* the bridge's paths for the branch norms.

The norm scales are drawn at random on both sides (the init's zeros would
let a swapped pair of branch norms pass).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.transformer import layer_body as jlayer_body  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_parity import JNP, TORCH, assert_close, both, randn  # noqa: E402

ARCH = "hymba-1.5b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
NORMS = ("norm1", "norm2", "branch_norm_attn", "branch_norm_ssm")


def _numpy_params(dtype, seed=0, **overrides):
    """The JAX init of the smoke config as numpy, every layer norm scale
    (and the SSM's gated norm) redrawn at random."""
    jcfg = jget_smoke(ARCH, compute_dtype=dtype, **overrides)
    params = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for seg in params["segments"]:
        for name in NORMS:
            seg[name] = (rng.standard_normal(seg[name].shape) * 0.3).astype(np.float32)
        seg["ssm"]["norm"] = (rng.standard_normal(seg["ssm"]["norm"].shape)
                              * 0.3).astype(np.float32)
    return jcfg, params


def _pair(dtype, **overrides):
    """(JAX config, JAX params, port config, port params) with shared weights."""
    jcfg, params = _numpy_params(dtype, **overrides)
    jp = jax.tree.map(jnp.asarray, params)
    cfg = get_smoke(ARCH, compute_dtype=dtype, **overrides)
    return jcfg, jp, cfg, bridge.params_from_numpy(params, "cpu")


def _segment_of(cfg, kind):
    return next(i for i, (k, _) in enumerate(cfg.segments()) if k == kind)


def _layer(tree, i=0):
    """Layer ``i`` of a stacked segment (either framework's leaves)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _filled_cache(cfg, kind, b, max_len, pos, dtype, seed):
    """One hybrid layer's cache, filled at random as if ``pos`` tokens had
    gone through it: (JAX cache, port cache), each with ``pos``."""
    t = min(cfg.window, max_len) if kind == "hyb_l" else max_len
    kv = (b, t, cfg.n_kv_heads, cfg.head_dim)
    conv = (b, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    ssm = (b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    vals = {("attn", "k"): (randn(seed, *kv), dtype),
            ("attn", "v"): (randn(seed + 1, *kv), dtype),
            ("ssm", "conv"): (randn(seed + 2, *conv, scale=0.5), dtype),
            ("ssm", "ssm"): (randn(seed + 3, *ssm, scale=0.2), "float32")}
    jc = {"attn": {"pos": jnp.int32(pos)}, "ssm": {"pos": jnp.int32(pos)}}
    tc = {"attn": {"pos": pos}, "ssm": {"pos": pos}}
    for (half, name), (arr, dt) in vals.items():
        jc[half][name], tc[half][name] = both(arr, dt)
    return jc, tc


@pytest.mark.parametrize("dtype,use_kernels", [
    ("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True)])
def test_forward_matches_jax(dtype, use_kernels):
    """The whole model on 32 tokens (two chunks, past the window of 16),
    with and without the kernels' plain versions on both sides."""
    jcfg, jp, cfg, tp = _pair(dtype, use_kernels=use_kernels)
    s = 2 * cfg.ssm_chunk
    tj, tt = both(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, s)))
    want, _ = jax.jit(JModel(jcfg).forward)(jp, {"tokens": tj})
    with torch.inference_mode():
        got = Model(cfg, "cpu").forward(tp, {"tokens": tt})
    assert got.shape == (2, s, cfg.vocab_size)
    assert_close(got, want, TOLS[dtype])


@pytest.mark.parametrize("kind", ["hyb_g", "hyb_l"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_body_prefill_matches_jax(kind, dtype):
    jcfg, jp, cfg, tp = _pair(dtype)
    i = _segment_of(cfg, kind)
    jlp, tlp = _layer(jp["segments"][i]), _layer(tp["segments"][i])
    b, s = 2, 2 * cfg.ssm_chunk          # past the smoke window of 16
    assert s > cfg.window
    jx, tx = both(randn(1, b, s, cfg.d_model), dtype)
    jpos, tpos = both(np.broadcast_to(np.arange(s), (b, s)))
    want, _, jcache = jax.jit(lambda x, lp: jlayer_body(
        jcfg, kind, x, lp, jpos, 1))(jx, jlp)
    with torch.inference_mode():
        got, aux, tcache = tfm.layer_body(cfg, kind, tx, tlp, tpos)
    assert aux is None and tcache is None and jcache is None
    assert got.dtype == TORCH[dtype] and got.shape == (b, s, cfg.d_model)
    assert_close(got, want, TOLS[dtype])


@pytest.mark.parametrize("kind,pos", [("hyb_g", 7), ("hyb_l", 21)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_body_decode_step_matches_jax(kind, pos, dtype):
    """One decode step on a filled cache; for ``hyb_l`` at a position past
    its ring's wrap (slot 21 % 16).  The new cache's every tensor, and
    ``pos`` + 1 in both halves."""
    jcfg, jp, cfg, tp = _pair(dtype)
    i = _segment_of(cfg, kind)
    jlp, tlp = _layer(jp["segments"][i]), _layer(tp["segments"][i])
    b, max_len = 2, 24
    jc, tc = _filled_cache(cfg, kind, b, max_len, pos, dtype, seed=10)
    jx, tx = both(randn(2, b, 1, cfg.d_model), dtype)
    jpos, tpos = both(np.full((b, 1), pos))
    want, _, jnew = jax.jit(lambda x, lp, c: jlayer_body(
        jcfg, kind, x, lp, jpos, 1, cache=c))(jx, jlp, jc)
    with torch.inference_mode():
        got, _, tnew = tfm.layer_body(cfg, kind, tx, tlp, tpos, cache=tc)
    assert_close(got, want, TOLS[dtype])
    assert set(tnew) == {"attn", "ssm"}
    for half in ("attn", "ssm"):
        assert tnew[half]["pos"] == int(jnew[half]["pos"]) == pos + 1
        for name, w in jnew[half].items():
            if name == "pos":
                continue
            assert tnew[half][name].dtype == TORCH[str(w.dtype)], (half, name)
            assert_close(tnew[half][name], w, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_past_the_window_matches_jax(dtype):
    """20 decode steps into caches of 24: the ``hyb_g`` layers keep every
    position, the ``hyb_l`` layer's ring of 16 wraps at step 16.  Logits
    and every cache tensor (K and V, conv and SSM state) at every step."""
    jcfg, jp, cfg, tp = _pair(dtype)
    jm, tm = JModel(jcfg), Model(cfg, device="cpu")
    steps, max_len = 20, 24
    jc = jm.init_cache(2, max_len, dtype=JNP[dtype])
    tc = tm.init_cache(2, max_len, dtype=dtype)
    ring = tc["segments"][_segment_of(cfg, "hyb_l")]["attn"]["k"]
    assert ring.shape[2] == cfg.window < steps
    tj, tt = both(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, steps)))
    jstep = jax.jit(jm.decode_step)
    for t in range(steps):
        want, jc = jstep(jp, jc, tj[:, t:t + 1])
        with torch.inference_mode():
            got, tc = tm.decode_step(tp, tc, tt[:, t:t + 1])
        assert_close(got, want, TOLS[dtype])
        assert tc["pos"] == int(jc["pos"]) == t + 1
        want_cache = bridge.flatten(jax.device_get(jc["segments"]))
        got_cache = bridge.flatten(tc["segments"])
        assert set(got_cache) == set(want_cache)
        for key, w in want_cache.items():
            assert got_cache[key].dtype == TORCH[str(w.dtype)], key
            assert_close(got_cache[key], w, TOLS[dtype])


def test_hybrid_cache_nests_both_halves_under_one_pos():
    """A hybrid segment's cache is ``{"attn": {k, v}, "ssm": {conv, ssm}}``
    stacked on the layer axis; ``pos`` stays one Python int outside the
    tensors, and a bf16 conv state under fp32 compute is promoted at the
    first step, as the reference's concatenation gives it."""
    cfg = get_smoke(ARCH, compute_dtype="float32")
    model = Model(cfg, device="cpu")
    cache = model.init_cache(2, 24, dtype="bfloat16")
    assert cache["pos"] == 0
    for (kind, count), seg in zip(cfg.segments(), cache["segments"]):
        t = cfg.window if kind == "hyb_l" else 24
        assert set(seg) == {"attn", "ssm"}
        assert set(seg["attn"]) == {"k", "v"} and set(seg["ssm"]) == {"conv", "ssm"}
        assert seg["attn"]["k"].shape == (count, 2, t, cfg.n_kv_heads, cfg.head_dim)
        assert seg["attn"]["k"].dtype == seg["ssm"]["conv"].dtype == torch.bfloat16
        assert seg["ssm"]["ssm"].dtype == torch.float32
    params = model.init(0)
    with torch.inference_mode():
        _, cache = model.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.long))
    assert cache["pos"] == 1
    for seg in cache["segments"]:
        assert seg["ssm"]["conv"].dtype == torch.float32
        assert seg["attn"]["k"].dtype == torch.bfloat16


def test_bridge_paths_of_the_branch_norms():
    """The branch norms cross under the reference's checkpoint paths, one
    (layers, d) leaf per hybrid segment, exactly and both ways; the port's
    own init has the same leaves."""
    jcfg, params = _numpy_params("float32", seed=4)
    want = jckpt._flatten(params)
    tp = bridge.params_from_numpy(params, "cpu")
    got = bridge.flatten(tp)
    back = bridge.flatten(bridge.params_to_numpy(tp))
    own = bridge.flatten(Model(get_smoke(ARCH), device="cpu").init(0))
    for i, (kind, count) in enumerate(jcfg.segments()):
        assert kind in ("hyb_g", "hyb_l")
        for name in ("branch_norm_attn", "branch_norm_ssm"):
            key = f"segments/[{i}]/{name}"
            assert key in want
            assert tuple(got[key].shape) == tuple(own[key].shape) == (count, jcfg.d_model)
            np.testing.assert_array_equal(got[key].numpy(), want[key])
            np.testing.assert_array_equal(back[key], want[key])
        assert {k.split("/")[2] for k in want if k.startswith(f"segments/[{i}]/")} == {
            "norm1", "norm2", "attn", "ssm", "mlp", "branch_norm_attn",
            "branch_norm_ssm"}
    assert set(own) == set(want)


def test_swapped_branch_norms_change_the_layer():
    """The two branch norms are not interchangeable: swapping them moves
    the output (so the parity tests above see a swap)."""
    _, _, cfg, tp = _pair("float32")
    lp = _layer(tp["segments"][0])
    lp2 = {**lp, "branch_norm_attn": lp["branch_norm_ssm"],
           "branch_norm_ssm": lp["branch_norm_attn"]}
    x = torch.from_numpy(randn(5, 1, 16, cfg.d_model))
    pos = torch.arange(16).expand(1, 16)
    with torch.inference_mode():
        a, _, _ = tfm.layer_body(cfg, "hyb_g", x, lp, pos)
        b, _, _ = tfm.layer_body(cfg, "hyb_g", x, lp2, pos)
    assert float((a - b).abs().max()) > 1e-3
