"""internvl2-26b's backbone in the port (``input_mode="mixed"``: patch
embeddings through ``frontend_proj``, then token embeddings, on the
sequence axis), against the JAX package on the smoke config with the JAX
weights bridged across.

* ``_embed_inputs``'s mixed branch, the forward and ``loss_fn`` with -100
  labels on the patch positions, and the gradients, ``frontend_proj``'s
  included (``jax.value_and_grad`` against ``torch.autograd``);
* ``synthetic_batch``'s mixed batch: min(n_patches, seq // 2) patches
  first, their labels -100, as the reference's;
* the init's leaves; ``launch.train`` on the full config refusing a card
  before it allocates anything (its ~503 GB train state).

Tolerances (ROADMAP): the inputs and logits 1e-4 in fp32 and 2e-2 in bf16;
the loss 1e-5 (relative) in fp32 and 5e-3 in bf16; the fp32 gradients 1e-4
of each leaf's largest |g|.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.model import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro.models.transformer import _embed_inputs as jembed_inputs  # noqa: E402
from repro.models.transformer import loss_fn as jloss  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get, get_smoke  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model, synthetic_batch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.adamw import value_and_grad  # noqa: E402
from repro_torch.train.step import train_memory_gb  # noqa: E402
from torch_parity import assert_close, both, np32, randn  # noqa: E402

ARCH = "internvl2-26b"
TOLS = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
GRAD_TOL = 1e-4


def _pair(dtype):
    jcfg = jget_smoke(ARCH, compute_dtype=dtype)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, jp, get_smoke(ARCH, compute_dtype=dtype),
            bridge.params_from_numpy(jax.device_get(jp), "cpu"))


def _batch(cfg, b=2, s=24, seed=0):
    """(JAX batch, port batch): min(n_patches, s // 2) patch embeddings,
    then tokens; the patches' labels -100, the tokens' the next token."""
    rng = np.random.default_rng(seed)
    npatch = min(cfg.n_patches, s // 2)
    toks = rng.integers(0, cfg.vocab_size, (b, s - npatch))
    labels = np.concatenate([np.full((b, npatch), -100), np.roll(toks, -1, axis=1)],
                            axis=1)
    pairs = {"patch_embeds": both(randn(seed, b, npatch, cfg.d_model, scale=0.1)),
             "tokens": both(toks), "labels": both(labels)}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_inputs_match_reference(dtype):
    jcfg, jp, cfg, tp = _pair(dtype)
    jb, tb = _batch(cfg)
    want = jembed_inputs(jcfg, jp, jb)
    got = tfm._embed_inputs(cfg, tp, tb)
    assert got.shape == (2, 24, cfg.d_model) and got.dtype == tfm.as_dtype(dtype)
    assert_close(got, want, TOLS[dtype])
    # the patches come first, through frontend_proj
    np.testing.assert_allclose(
        np32(got[:, :cfg.n_patches]),
        np32((tb["patch_embeds"].to(got.dtype) @ tp["frontend_proj"].to(got.dtype))),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_reference(dtype):
    jcfg, jp, cfg, tp = _pair(dtype)
    jb, tb = _batch(cfg)
    inputs_j = {k: v for k, v in jb.items() if k != "labels"}
    inputs_t = {k: v for k, v in tb.items() if k != "labels"}
    want, _ = jax.jit(JModel(jcfg).forward)(jp, inputs_j)
    with torch.no_grad():
        got = Model(cfg, "cpu").forward(tp, inputs_t)
    assert got.shape == (2, 24, cfg.vocab_size)
    assert_close(got, want, TOLS[dtype])

    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(jcfg, p, jb), has_aux=True))(jp)
    (tl, taux), tg = value_and_grad(lambda p, b: tfm.loss_fn(cfg, p, b), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]), rtol=LOSS_TOL[dtype])
    # the -100 patch labels are out of the mean: the CE is the mean over
    # the token positions only
    with torch.no_grad():
        lp = torch.log_softmax(got.float(), dim=-1)[:, cfg.n_patches:]
        nll = -lp.gather(-1, tb["labels"][:, cfg.n_patches:, None]).mean()
    np.testing.assert_allclose(float(taux["ce"]), float(nll), rtol=1e-5 if dtype == "float32"
                               else LOSS_TOL[dtype])
    got_g = {k: np32(v) for k, v in bridge.flatten(tg).items()}
    want_g = {k: np32(v) for k, v in bridge.flatten(jg).items()}
    assert set(got_g) == set(want_g)
    assert np.abs(got_g["frontend_proj"]).max() > 0
    if dtype == "float32":
        for key, w in want_g.items():
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(got_g[key] - w).max() <= GRAD_TOL * scale, key


def test_synthetic_batch_lays_out_patches_first():
    cfg = get_smoke(ARCH)
    for seq in (24, 6):
        got = synthetic_batch(cfg, 2, seq, np.random.default_rng(0), "cpu")
        want = jsynthetic_batch(jget_smoke(ARCH), 2, seq, jax.random.PRNGKey(0))
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, key
        npatch = min(cfg.n_patches, seq // 2)
        assert got["patch_embeds"].dtype == torch.bfloat16
        assert bool((got["labels"][:, :npatch] == -100).all())
        assert bool((got["labels"][:, npatch:] >= 0).all())
    # a torch generator gives the same layout
    gen = torch.Generator()
    gen.manual_seed(0)
    again = synthetic_batch(cfg, 2, 24, gen, "cpu")
    assert {k: tuple(v.shape) for k, v in again.items()} == {
        "tokens": (2, 20), "patch_embeds": (2, 4, 64), "labels": (2, 24)}


def test_init_tree_matches_reference_layout():
    want = {k: np.asarray(v) for k, v in bridge.flatten(jax.device_get(
        JModel(jget_smoke(ARCH)).init(jax.random.PRNGKey(0)))).items()}
    got = bridge.flatten(Model(get_smoke(ARCH), "cpu").init(0))
    assert set(got) == set(want) and "frontend_proj" in got
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype), key


def test_launch_train_refuses_a_card_it_does_not_fit(monkeypatch):
    """On a card, launch.train reckons the train state first and exits,
    naming the memory, before it allocates anything: internvl2-26b's 19.9 B
    parameters need ~398 GB of fp32 state alone, ~536 GB in all at the
    default batch of 8 x 128."""
    need = train_memory_gb(get(ARCH))
    assert need["state_gb"] == pytest.approx(20 * 19_899_009_024 / 1e9)
    assert need["total_gb"] > 400
    monkeypatch.setattr(train_cli, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=85_000_000_000))

    def allocates(*args, **kwargs):
        raise AssertionError("launch.train allocated before refusing")

    monkeypatch.setattr(train_cli, "init_train_state", allocates)
    with pytest.raises(SystemExit, match=r"needs ~536\.3 GB .* the card has 85\.0 GB"):
        train_cli.main(["--arch", ARCH, "--steps", "1"])
    # a config that fits goes on to build its mesh and allocate (the mesh and
    # the generator made on the CPU here)
    real_mesh = train_cli.make_local_mesh
    monkeypatch.setattr(train_cli, "make_local_mesh",
                        lambda model=1, device=None: real_mesh(model, "cpu"))
    cpu_generator = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device: cpu_generator())
    with pytest.raises(AssertionError, match="allocated before refusing"):
        train_cli.main(["--arch", "hubert-xlarge", "--steps", "1"])
