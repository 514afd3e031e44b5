"""hubert-xlarge's encoder in the port (the ``enc`` kind: bidirectional
attention, LayerNorm, a non-gated GELU MLP with biases; frame embeddings
in through ``frontend_proj``), against the JAX package on the smoke config
with the JAX weights bridged across.

* ``layer_norm``, the ``gelu_nogate`` MLP and an ``enc`` ``layer_body``;
* the whole forward, ``loss_fn`` and its gradients (``jax.value_and_grad``
  against ``torch.autograd``), in fp32 and bf16;
* bidirectionality: the last frame moves position 0's output, in both;
* the init's leaves, checkpoints both ways, ``launch.train`` run and
  resumed, ``launch.serve``, the gang and ``decode_step`` refusing it.

Tolerances (ROADMAP): the logits 1e-4 in fp32 and 2e-2 in bf16 (one bf16
step of |x| < 2 is 7.8e-3); a layer's output 2e-5 in fp32; the loss 1e-5
(relative) in fp32 and 5e-3 in bf16; the fp32 gradients 1e-4 of each
leaf's largest |g| (summation order only); the bf16 gradient norm 5e-2
(relative: chip_smoke's bound for two bf16 paths of one step).  The
LayerNorm scales and biases and the MLP biases are drawn at random on both
sides (the init's ones and zeros would let a swapped pair pass).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import layer_body as jlayer_body  # noqa: E402
from repro.models.transformer import loss_fn as jloss  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.adamw import global_norm, value_and_grad  # noqa: E402
from repro_torch.train import ensemble  # noqa: E402
from torch_parity import JNP, assert_close, both, np32, randn  # noqa: E402

ARCH = "hubert-xlarge"
ROOT = Path(__file__).resolve().parents[1]
TOLS = {"float32": 1e-4, "bfloat16": 2e-2}
LAYER_TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
GRAD_TOL = 1e-4
BF16_GNORM_TOL = 5e-2


def _numpy_params(dtype, seed=0):
    """The JAX init of the smoke config as numpy, the LayerNorm scales and
    biases and the MLP biases redrawn at random."""
    jcfg = jget_smoke(ARCH, compute_dtype=dtype)
    params = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def redraw(norm):
        norm["scale"] = (1 + rng.standard_normal(norm["scale"].shape) * 0.3).astype(np.float32)
        norm["bias"] = (rng.standard_normal(norm["bias"].shape) * 0.3).astype(np.float32)

    for seg in params["segments"]:
        redraw(seg["norm1"])
        redraw(seg["norm2"])
        for name in ("bi", "bo"):
            seg["mlp"][name] = (rng.standard_normal(seg["mlp"][name].shape)
                                * 0.1).astype(np.float32)
    redraw(params["final_norm"])
    return jcfg, params


def _pair(dtype):
    """(JAX config, JAX params, port config, port params), shared weights."""
    jcfg, params = _numpy_params(dtype)
    return (jcfg, jax.tree.map(jnp.asarray, params),
            get_smoke(ARCH, compute_dtype=dtype), bridge.params_from_numpy(params, "cpu"))


def _batch(cfg, b=2, s=24, seed=0):
    """(JAX batch, port batch): frame embeddings and random labels, some -100."""
    rng = np.random.default_rng(seed)
    emb = randn(seed, b, s, cfg.d_model, scale=0.1)
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    labels[0, :3] = -100
    ej, et = both(emb)
    lj, lt = both(labels)
    return {"embeds": ej, "labels": lj}, {"embeds": et, "labels": lt}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    xj, xt = both(randn(1, 3, 7, 48, scale=2.0) + 0.5, dtype)
    sj, st = both(1 + randn(2, 48, scale=0.3))
    bj, bt = both(randn(3, 48, scale=0.3))
    got = layers.layer_norm(xt, st, bt, 1e-6)
    want = jlayers.layer_norm(xj, sj, bj, 1e-6)
    assert got.dtype == xt.dtype
    assert_close(got, want, LAYER_TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_nogate_mlp_matches_reference(dtype):
    xj, xt = both(randn(4, 2, 5, 32), dtype)
    p = {"wi": randn(5, 32, 64, scale=0.1), "bi": randn(6, 64, scale=0.1),
         "wo": randn(7, 64, 32, scale=0.1), "bo": randn(8, 32, scale=0.1)}
    pj = {k: both(v)[0] for k, v in p.items()}
    pt = {k: both(v)[1] for k, v in p.items()}
    got = layers.mlp(xt, pt, "gelu_nogate", dtype)
    want = jlayers.mlp(xj, pj, "gelu_nogate", JNP[dtype])
    assert got.dtype == layers.as_dtype(dtype)
    assert_close(got, want, LAYER_TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_enc_layer_body_matches_reference(dtype):
    jcfg, jp, cfg, tp = _pair(dtype)
    lj = jax.tree.map(lambda a: a[1], jp["segments"][0])
    lt = tfm._layers(tp["segments"][0], cfg.n_layers)[1]
    xj, xt = both(randn(9, 2, 20, cfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    pj, pt = both(pos)
    want, _, _ = jlayer_body(jcfg, "enc", xj, lj, pj, 1)
    got, aux, cache = tfm.layer_body(cfg, "enc", xt, lt, pt)
    assert aux is None and cache is None
    assert_close(got, want, LAYER_TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_reference(dtype):
    jcfg, jp, cfg, tp = _pair(dtype)
    jb, tb = _batch(cfg)
    want, _ = jax.jit(JModel(jcfg).forward)(jp, {"embeds": jb["embeds"]})
    with torch.no_grad():
        got = Model(cfg, "cpu").forward(tp, {"embeds": tb["embeds"]})
    assert got.shape == (2, 24, cfg.vocab_size)
    assert_close(got, want, TOLS[dtype])

    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(jcfg, p, jb), has_aux=True))(jp)
    (tl, taux), tg = value_and_grad(lambda p, b: tfm.loss_fn(cfg, p, b), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]), rtol=LOSS_TOL[dtype])
    got_g = {k: np32(v) for k, v in bridge.flatten(tg).items()}
    want_g = {k: np32(v) for k, v in bridge.flatten(jg).items()}
    assert set(got_g) == set(want_g)
    # frontend_proj, the LayerNorm scales and biases, the MLP biases all
    # receive a gradient; embed, which nothing reads in embeds mode, none
    assert np.abs(got_g["frontend_proj"]).max() > 0
    assert np.abs(got_g["segments/[0]/norm1/bias"]).max() > 0
    assert np.abs(got_g["embed"]).max() == np.abs(want_g["embed"]).max() == 0
    if dtype == "float32":
        for key, w in want_g.items():
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(got_g[key] - w).max() <= GRAD_TOL * scale, key
    else:
        want_norm = float(np.sqrt(sum(np.square(w.astype(np.float64)).sum()
                                      for w in want_g.values())))
        got_norm = float(global_norm(tg))
        assert abs(got_norm - want_norm) <= BF16_GNORM_TOL * want_norm


def test_the_last_frame_moves_position_zero_in_both_packages():
    """Bidirectional attention: position 0 sees the last frame."""
    jcfg, jp, cfg, tp = _pair("float32")
    emb = randn(11, 1, 16, cfg.d_model, scale=0.1)
    moved = emb.copy()
    moved[0, -1] += 1.0
    outs = {}
    for name, x in (("base", emb), ("moved", moved)):
        xj, xt = both(x)
        outs[name] = (np.asarray(JModel(jcfg).forward(jp, {"embeds": xj})[0]),
                      np32(Model(cfg, "cpu").forward(tp, {"embeds": xt})))
    for side in (0, 1):
        assert np.abs(outs["moved"][side][0, 0] - outs["base"][side][0, 0]).max() > 1e-3
    assert_close(outs["moved"][1], outs["moved"][0], TOLS["float32"])


def test_init_tree_matches_reference_layout():
    """Paths, shapes and dtypes of the port's own init equal the JAX
    init's: nested ``{scale, bias}`` norms, the MLP's biases,
    ``frontend_proj``, and ``embed`` kept though nothing reads it."""
    want = {k: np.asarray(v) for k, v in bridge.flatten(jax.device_get(
        JModel(jget_smoke(ARCH)).init(jax.random.PRNGKey(0)))).items()}
    got = bridge.flatten(Model(get_smoke(ARCH), "cpu").init(0))
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype), key
    assert {"frontend_proj", "embed", "final_norm/scale", "final_norm/bias",
            "segments/[0]/norm1/scale", "segments/[0]/mlp/bi",
            "segments/[0]/mlp/bo"} <= set(got)
    assert torch.equal(got["segments/[0]/norm2/scale"],
                       torch.ones_like(got["segments/[0]/norm2/scale"]))


def _states():
    """A JAX train state (numpy) of the smoke config and the port's copy."""
    from repro.train.step import init_train_state as jinit_train_state
    opt = JAdamW(schedule=jcosine(1e-3, 2, 10))
    jstate = jax.device_get(jinit_train_state(jget_smoke(ARCH), opt,
                                              jax.random.PRNGKey(4)))
    jstate["step"] = np.asarray(3, np.int32)
    return jstate, bridge.params_from_numpy(jstate, "cpu")


def _assert_same(tstate, jstate):
    got = bridge.flatten(bridge.params_to_numpy(tstate))
    want = bridge.flatten(jax.device_get(jstate))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)


def test_checkpoints_cross_both_ways(tmp_path):
    jstate, tstate = _states()
    ckpt.save(tstate, tmp_path / "port", 3)
    _assert_same(tstate, jckpt.restore(jax.tree.map(jnp.zeros_like, jstate),
                                       tmp_path / "port"))
    jckpt.save(jax.tree.map(jnp.asarray, jstate), tmp_path / "jax", 3)
    _assert_same(ckpt.restore(jax.tree.map(torch.zeros_like, tstate), tmp_path / "jax"),
                 jstate)


def _train(ckpt_dir, steps):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", str(steps), "--batch", "2", "--seq", "16",
         "--warmup", "1", "--ckpt-every", "2", "--log-every", "1",
         "--ckpt-dir", str(ckpt_dir)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_launch_train_runs_and_resumes(tmp_path):
    first = _train(tmp_path, 2)
    assert first.returncode == 0, first.stderr
    assert "done: final loss" in first.stdout and ckpt.latest_step(tmp_path) == 2
    again = _train(tmp_path, 4)
    assert again.returncode == 0, again.stderr
    assert "[restore] resumed from step 2" in again.stdout
    assert ckpt.latest_step(tmp_path) == 4
    # the checkpoint restores into a train state whose LayerNorms nest
    # {scale, bias}, the trained scales moved off their init
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state
    gen = torch.Generator()
    gen.manual_seed(0)
    target = init_train_state(get_smoke(ARCH), AdamW(schedule=cosine_schedule(3e-4, 1, 4)),
                              gen)
    state = ckpt.restore(target, tmp_path)
    norm = state["params"]["segments"][0]["norm1"]
    assert set(norm) == {"scale", "bias"} and int(state["step"]) == 4
    assert not torch.equal(norm["scale"], torch.ones_like(norm["scale"]))


def test_launch_serve_exits_as_the_reference_does(monkeypatch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert str(got.value) == str(want.value) == "hubert-xlarge-smoke is encoder-only; nothing to decode"


def test_the_gang_refuses_it():
    with pytest.raises(ValueError, match="token batches only"):
        ensemble.init_members(get_smoke(ARCH), [0], 2, 2, 16, "cpu")


def test_decode_step_raises_in_both_packages():
    jcfg, jp, cfg, tp = _pair("float32")
    tok_j, tok_t = both(np.zeros((1, 1), np.int64))
    with pytest.raises(ValueError, match="encoder-only"):
        JModel(jcfg).decode_step(jp, JModel(jcfg).init_cache(1, 4), tok_j)
    with pytest.raises(ValueError, match="encoder-only"):
        tfm.decode_step(cfg, tp, {"pos": 0, "segments": []}, tok_t)
    with pytest.raises(ValueError, match="encoder-only"):
        Model(cfg, "cpu").init_cache(1, 4)
