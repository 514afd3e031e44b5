"""The port's training path against the JAX package, on the CPU at smoke
sizes: ``loss_fn`` and its gradient, remat, one train step, the
``tests/test_train_integration.py`` checks on the port, and a killed and
resumed ``python -m repro_torch.launch.train``.

Weights, states and batches cross as numpy arrays (``repro_torch.bridge``);
the JAX side runs its default plain path.  Tolerances, fixed up front:

* float32 ``compute_dtype``: the loss to 1e-5 relative, each gradient leaf
  to 1e-4 of that leaf's largest |g| (summation order only);
* bfloat16: the loss to 5e-3 (the reference's model-loss tolerance);
* a train step (float32): loss and grad_norm to 1e-5 relative, m and v as
  gradients (1e-4 of the leaf's largest element), and the new parameters
  to 1e-6 wherever the gradient's sign is settled at the gradient tolerance:
  Adam's first step moves each weight by lr·sign(g), so a gradient within
  the tolerance of 0 may take the other sign in the other framework.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models.transformer import init_params as jinit, loss_fn as jloss  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.train.step import (  # noqa: E402
    TrainStepConfig as JTrainStepConfig, make_train_step as jmake_train_step,
)

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import SyntheticStream  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamW, cosine_schedule, value_and_grad,
)
from repro_torch.train.step import (  # noqa: E402
    TrainStepConfig, init_train_state, make_train_step,
)
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)   # the suite runs under 6 xdist workers

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-4
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _batches(cfg, b, s, seed=0, ignore=False):
    """(JAX batch, port batch) of ``s`` positions by the input mode: tokens
    and next-token labels; frame embeddings and random labels
    (``embeds``); or min(n_patches, s // 2) patch embeddings, then tokens,
    the patches' labels -100 (``mixed``).  With ``ignore`` some labels are
    -100."""
    rng = np.random.default_rng(seed)
    host = {}
    if cfg.input_mode == "embeds":
        host["embeds"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    elif cfg.input_mode == "mixed":
        npatch = min(cfg.n_patches, s // 2)
        host["patch_embeds"] = (rng.standard_normal((b, npatch, cfg.d_model))
                                * 0.1).astype(np.float32)
        host["tokens"] = rng.integers(0, cfg.vocab_size, (b, s - npatch)).astype(np.int32)
        labels = np.concatenate([np.full((b, npatch), -100, np.int32),
                                 np.roll(host["tokens"], -1, axis=1)], axis=1)
    else:
        host["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        labels = np.roll(host["tokens"], -1, axis=1)
    if ignore:
        labels[0, :5] = -100
        labels[-1, -3:] = -100
    host["labels"] = labels
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
          for k, v in host.items()}
    return jb, tb


def _params(arch, **overrides):
    """(JAX config, port config, JAX params as numpy, port params)."""
    jcfg = jget_smoke(arch, **overrides)
    jp = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0)))
    return jcfg, get_smoke(arch, **overrides), jp, bridge.params_from_numpy(jp, "cpu")


def _flat(tree) -> dict[str, np.ndarray]:
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = bridge.params_to_numpy(tree)
    return {k: np.asarray(v, np.float64) for k, v in
            bridge.flatten(jax.device_get(tree)).items()}


def _assert_leaves_close(got, want, tol):
    """Each leaf to ``tol`` of that leaf's largest |element|."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[key] - w).max()
        assert err <= tol * scale, (key, err, scale)


CASES = [
    ("gemma3-1b", {}, False),
    ("gemma3-1b", {"loss_chunk": 8}, True),
    ("gemma3-1b", {"vocab_pad": 96}, True),        # padded_vocab 288 > 256
    ("mamba2-780m", {}, True),
    ("mamba2-780m", {"loss_chunk": 16}, False),
    ("olmoe-1b-7b", {}, True),
    ("olmoe-1b-7b", {"loss_chunk": 8, "moe_dispatch": "ragged"}, False),
    ("hymba-1.5b", {}, True),
    ("hymba-1.5b", {"loss_chunk": 16}, False),
    ("hubert-xlarge", {}, True),
    ("hubert-xlarge", {"loss_chunk": 8, "remat": "dots"}, False),
    ("internvl2-26b", {}, False),
    ("internvl2-26b", {"loss_chunk": 8}, True),
]


@pytest.mark.parametrize("arch,overrides,ignore", CASES)
def test_loss_and_grad_match_reference(arch, overrides, ignore):
    jcfg, cfg, jp, tp = _params(arch, compute_dtype="float32", **overrides)
    if overrides.get("vocab_pad"):
        assert cfg.padded_vocab > cfg.vocab_size
    jb, tb = _batches(cfg, 2, 32, ignore=ignore)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(jcfg, p, jb), has_aux=True))(jp)
    (tl, taux), tg = value_and_grad(lambda p, b: tfm.loss_fn(cfg, p, b), tp, tb)
    assert set(taux) == set(jaux)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL["float32"])
    for key in ("ce", "load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=LOSS_TOL["float32"], atol=1e-7)
    _assert_leaves_close(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m", "olmoe-1b-7b",
                                  "hymba-1.5b", "hubert-xlarge", "internvl2-26b"])
def test_bf16_loss_matches_reference(arch):
    jcfg, cfg, jp, tp = _params(arch)
    assert cfg.compute_dtype == "bfloat16"
    jb, tb = _batches(cfg, 2, 32, ignore=True)
    jl, jaux = jax.jit(lambda p: jloss(jcfg, p, jb))(jp)
    with torch.no_grad():
        tl, taux = tfm.loss_fn(cfg, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL["bfloat16"])
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=LOSS_TOL["bfloat16"])


def test_loss_ignores_every_label_below_zero():
    """All labels ignored: the denominator is 1 and the CE 0, as in the
    reference (max(#labels >= 0, 1))."""
    jcfg, cfg, jp, tp = _params("gemma3-1b", compute_dtype="float32")
    jb, tb = _batches(cfg, 2, 16)
    jb["labels"] = jnp.full_like(jb["labels"], -100)
    tb["labels"] = torch.full_like(tb["labels"], -100)
    jl, _ = jloss(jcfg, jp, jb)
    tl, _ = tfm.loss_fn(cfg, tp, tb)
    assert float(tl) == float(jl) == 0.0


def test_remat_modes_give_the_same_grads():
    """none, full and dots recompute the same values: the same loss and
    gradients (bit for bit on the CPU)."""
    _, cfg, jp, _ = _params("gemma3-1b", compute_dtype="float32")
    _, tb = _batches(cfg, 2, 32)
    out = {}
    for mode in ("none", "full", "dots"):
        mcfg = dataclasses.replace(cfg, remat=mode)
        tp = bridge.params_from_numpy(jp, "cpu")
        out[mode] = value_and_grad(lambda p, b: tfm.loss_fn(mcfg, p, b), tp, tb)
    (l0, _), g0 = out["none"]
    for mode in ("full", "dots"):
        (lm, _), gm = out[mode]
        assert float(lm) == float(l0)
        _assert_leaves_close(gm, g0, 1e-6)


def test_forward_and_loss_share_the_backbone():
    """``forward`` still returns logits only, and the loss is the mean NLL of
    those logits."""
    _, cfg, _, tp = _params("gemma3-1b", compute_dtype="float32")
    _, tb = _batches(cfg, 2, 16)
    with torch.no_grad():
        logits = tfm.forward(cfg, tp, tb)
        loss, _ = Model(cfg, "cpu").loss(tp, tb)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), tb["labels"].reshape(-1))
    assert torch.is_tensor(logits) and logits.shape == (2, 16, cfg.vocab_size)
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)


def _states(jcfg, jp, lr=1e-3):
    jopt = JAdamW(schedule=jcosine(lr, 2, 10))
    opt = AdamW(schedule=cosine_schedule(lr, 2, 10))
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = bridge.params_from_numpy(jax.device_get(jstate), "cpu")
    return jopt, opt, jstate, tstate


@pytest.mark.parametrize("arch,step_cfg", [
    ("gemma3-1b", {}), ("gemma3-1b", {"n_micro": 2}),
    ("gemma3-1b", {"compress_grads": True}), ("mamba2-780m", {}),
    ("olmoe-1b-7b", {"n_micro": 2}), ("hymba-1.5b", {}),
    ("hubert-xlarge", {"n_micro": 2}), ("internvl2-26b", {})])
def test_train_step_matches_reference(arch, step_cfg):
    jcfg, cfg, jp, _ = _params(arch, compute_dtype="float32")
    jopt, opt, jstate, tstate = _states(jcfg, jp)
    jb, tb = _batches(cfg, 4, 32, ignore=True)
    js, jm = jax.jit(jmake_train_step(jcfg, jopt, JTrainStepConfig(**step_cfg)))(jstate, jb)
    ts, tm = make_train_step(cfg, opt, TrainStepConfig(**step_cfg))(tstate, tb)
    assert set(tm) == set(jm)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 1
    assert int(ts["opt"]["count"]) == 1
    m_ref = _flat(js["opt"]["m"])
    if step_cfg.get("compress_grads"):
        # a gradient within the tolerance of a rounding edge of the int8
        # levels may land on the neighbouring level: m = 0.1·g, whose
        # largest element is 127 levels, may be one level apart
        got = _flat(ts["opt"]["m"])
        for key, w in m_ref.items():
            top = np.abs(w).max()
            assert np.abs(got[key] - w).max() <= top / 127 * 1.01 + GRAD_TOL * top, key
        return
    _assert_leaves_close(ts["opt"]["m"], js["opt"]["m"], GRAD_TOL)
    _assert_leaves_close(ts["opt"]["v"], js["opt"]["v"], 2 * GRAD_TOL)
    for part in (["params"], ["opt", "master"]):
        got, want = ts, js
        for p in part:
            got, want = got[p], want[p]
        got, want = _flat(got), _flat(want)
        for key, w in want.items():
            g = m_ref[key.replace("params/", "").replace("opt/master/", "")]
            settled = np.abs(g) > GRAD_TOL * np.abs(g).max()
            off = np.abs(got[key] - w) > 1e-6
            assert not (off & settled).any(), key


# ---------------------------------------------------------------------------
# tests/test_train_integration.py, on the port
# ---------------------------------------------------------------------------

def _gen(seed=11):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def _fixed_batch(cfg, b, s):
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, s)))
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def test_loss_decreases_on_learnable_data():
    """Tiny LM on a fixed repeating batch must overfit."""
    cfg = get_smoke("deepseek-7b")
    opt = AdamW(schedule=cosine_schedule(3e-3, 5, 60), weight_decay=0.0)
    state = init_train_state(cfg, opt, _gen())
    step = make_train_step(cfg, opt)
    batch = _fixed_batch(cfg, 4, 32)
    losses = []
    for _ in range(60):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_microbatching_matches_full_batch_grads():
    """n_micro=2 gives (numerically) the same step as n_micro=1."""
    cfg = get_smoke("gemma-7b")
    opt = AdamW(schedule=cosine_schedule(1e-3, 2, 10), clip_norm=0.0)
    state1 = init_train_state(cfg, opt, _gen())
    state2 = tree_map(torch.clone, state1)
    stream = SyntheticStream(cfg, global_batch=4, seq_len=16, seed=0)
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in stream.batch_at(0).items()}
    s1, m1 = make_train_step(cfg, opt)(state1, batch)
    s2, m2 = make_train_step(cfg, opt, TrainStepConfig(n_micro=2))(state2, batch)
    # bf16 compute reassociates across the micro split: ~1% slack
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-2)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(s1["params"])),
                    jax.tree.leaves(bridge.params_to_numpy(s2["params"]))):
        np.testing.assert_allclose(a, b, atol=2e-2)


def test_compressed_grads_still_train():
    cfg = get_smoke("deepseek-7b")
    opt = AdamW(schedule=cosine_schedule(3e-3, 5, 40), weight_decay=0.0)
    state = init_train_state(cfg, opt, _gen())
    step = make_train_step(cfg, opt, TrainStepConfig(compress_grads=True))
    batch = _fixed_batch(cfg, 4, 32)
    losses = []
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.85


def test_master_does_not_alias_fp32_params():
    """fp32 params: the master is a copy, before and after a step (the step
    writes both in place)."""
    cfg = get_smoke("gemma3-1b")           # param_dtype float32
    opt = AdamW(schedule=cosine_schedule(1e-3, 2, 10))
    state = init_train_state(cfg, opt, _gen())

    def shared(state):
        ptrs = {t.untyped_storage().data_ptr()
                for t in jax.tree.leaves(state["params"])}
        return [k for k, t in bridge.flatten(state["opt"]["master"]).items()
                if t.untyped_storage().data_ptr() in ptrs]

    assert not shared(state)
    state, m = make_train_step(cfg, opt)(state, _fixed_batch(cfg, 2, 16))
    assert bool(torch.isfinite(m["loss"]))
    assert not shared(state)


def test_sequence_parallel_is_not_ported():
    cfg = get_smoke("gemma3-1b")
    opt = AdamW(schedule=cosine_schedule(1e-3, 2, 10))
    with pytest.raises(NotImplementedError, match="seq_spec"):
        make_train_step(cfg, opt, TrainStepConfig(seq_spec="data"))


# ---------------------------------------------------------------------------
# launch.train: kill and resume
# ---------------------------------------------------------------------------

def _train_cmd(ckpt_dir, steps):
    return [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", "--steps", str(steps), "--batch", "2", "--seq",
            "16", "--warmup", "2", "--ckpt-every", "2", "--log-every", "1",
            "--ckpt-dir", str(ckpt_dir)]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def test_killed_and_resumed_run_ends_as_an_uninterrupted_one(tmp_path):
    steps = 16
    whole = subprocess.run(_train_cmd(tmp_path / "whole", steps), env=_env(),
                           capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert whole.returncode == 0, whole.stderr
    assert "done: final loss" in whole.stdout

    # killed as soon as its step-4 checkpoint is down, then run again
    cut = tmp_path / "cut"
    proc = subprocess.Popen(_train_cmd(cut, steps), env=_env(), cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 240
        while (ckpt.latest_step(cut) or 0) < 4 and proc.poll() is None:
            assert time.time() < deadline, "no step-4 checkpoint"
            time.sleep(0.02)
    finally:
        proc.kill()
        proc.wait()
    killed_at = ckpt.latest_step(cut)
    assert killed_at is not None and killed_at < steps
    again = subprocess.run(_train_cmd(cut, steps), env=_env(),
                           capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert again.returncode == 0, again.stderr
    assert f"[restore] resumed from step {killed_at}" in again.stdout
    assert ckpt.latest_step(cut) == ckpt.latest_step(tmp_path / "whole") == steps

    cfg = get_smoke("gemma3-1b")
    opt = AdamW(schedule=cosine_schedule(3e-4, 2, steps))
    target = init_train_state(cfg, opt, _gen())
    a = bridge.flatten(ckpt.restore(target, tmp_path / "whole"))
    b = bridge.flatten(ckpt.restore(target, cut))
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert whole.stdout.splitlines()[-1] == again.stdout.splitlines()[-1]
