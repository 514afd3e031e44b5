"""The port's gang trainer (``repro_torch.train.ensemble``) on the CPU at
smoke sizes, against the JAX package's ``repro.train.ensemble``.

* The counterparts of ``tests/test_train_integration.py::TestEnsembleGang``:
  members one by one against the gang (atol 1e-4), heterogeneous members
  rejected.
* Parity through the seam: the JAX side's initial parameters and tokens,
  derived exactly as its ``train_one`` derives them, cross as numpy into
  :func:`train_gang`; each member's last loss is held against
  ``repro.train.ensemble.train_ensemble``'s: 5e-3 in the default bf16
  compute, 1e-4 in fp32 (the JAX module's ``get_smoke`` lookup is
  monkeypatched to an fp32 config; the JAX package is not edited).
* The kernels' member-axis rules (``FlashAttention.vmap``,
  ``SSDScan.vmap``) under ``torch.func.vmap`` with the launches replaced
  by the plain versions: one call per kernel for all members, results as a
  loop over the members.
* The grouped GEMM's member-axis rule (``GroupedMatmul.vmap``) in an
  olmoe gang: its launches a step do not grow with the members, and a gang
  of two gives each member's losses alone.
* A hymba gang (both kernel families in one layer, one checkpoint and one
  ``vmap``): against JAX, and its launches a step for M = 3 as for M = 1.
* A mamba2 gang, and the unchanged engine's ``GangExecutor`` dispatching
  the port's ``train_ensemble`` once for four members.
* hubert (frame embeddings) and internvl2 (patch embeddings, then tokens):
  the reference's gang draws token batches only and fails on them; the
  port's refuses them up front.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.train import ensemble as jens  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.train import ensemble  # noqa: E402
from torch_parity import patch_plain_launches  # noqa: E402

torch.set_num_threads(1)   # the suite runs under 6 xdist workers

LOSS_TOL = {"float32": 1e-4, "bfloat16": 5e-3}


def _members(arch="gemma3-1b", lrs=(1e-3, 3e-3), seeds=(0, 0), steps=4,
             batch=2, seq=16):
    return [{"args:lr": lr, "args:seed": seed, "args:arch": arch,
             "args:steps": steps, "args:batch": batch, "args:seq": seq}
            for lr, seed in zip(lrs, seeds)]


class TestEnsembleGang:
    def test_vmap_stack_matches_per_member(self):
        members = _members()
        a = ensemble.train_members(members, device="cpu")
        b = ensemble.train_ensemble(members, device="cpu")
        np.testing.assert_allclose(a, b, atol=1e-4)

    def test_heterogeneous_members_rejected(self):
        members = [{"args:arch": "gemma3-1b", "args:seq": 16},
                   {"args:arch": "gemma3-1b", "args:seq": 32}]
        with pytest.raises(ValueError):
            ensemble.train_ensemble(members, device="cpu")


def test_bare_and_args_keys_and_defaults():
    """Keys bare or ``args:``-prefixed, the reference's defaults, warmup
    max(1, steps // 10)."""
    got = ensemble._common([{"lr": 2e-3, "args:seed": 3, "steps": 30},
                            {"args:lr": 1e-3, "seed": 1, "args:steps": 30}])
    assert got == {"arch": "gemma3-1b", "steps": 30, "batch": 4, "seq": 64,
                   "warmup": 3, "lrs": [2e-3, 1e-3], "seeds": [3, 1]}
    assert ensemble._common([{}])["warmup"] == 2


def _jax_seam(jcfg, seeds, steps, batch, seq):
    """Each member's initial parameters and tokens as the JAX ``train_one``
    derives them: (stacked port parameters, tokens (M, steps, B, S))."""
    params, tokens = [], []
    for seed in seeds:
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        params.append(bridge.params_from_numpy(
            jax.device_get(jinit(jcfg, key)), "cpu"))
        keys = jax.random.split(jax.random.fold_in(key, 1), steps)
        tokens.append(np.stack([np.asarray(jax.random.randint(
            k, (batch, seq), 0, jcfg.vocab_size)) for k in keys]))
    return (ensemble.stack_members(params),
            torch.from_numpy(np.stack(tokens).astype(np.int64)))


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m", "olmoe-1b-7b",
                                  "hymba-1.5b", "hubert-xlarge", "internvl2-26b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gang_matches_jax_from_the_same_init_and_tokens(monkeypatch, arch, dtype):
    steps, batch, seq = 4, 2, 16
    lrs, seeds = (1e-3, 3e-3), (0, 1)
    jcfg = jget_smoke(arch, compute_dtype=dtype)
    monkeypatch.setattr(jens, "get_smoke", lambda a: jget_smoke(a, compute_dtype=dtype))
    if jcfg.input_mode != "tokens":
        # the reference's gang draws tokens and misses the embeddings its
        # loss reads; the port's gang refuses the config up front
        with pytest.raises(KeyError, match="embeds"):
            jens.train_ensemble(_members(arch, lrs, seeds, steps, batch, seq))
        with pytest.raises(ValueError, match="token batches only"):
            ensemble.train_ensemble(_members(arch, lrs, seeds, steps, batch, seq),
                                    device="cpu")
        cfg = get_smoke(arch, compute_dtype=dtype)
        with pytest.raises(ValueError, match="token batches only"):
            ensemble.train_gang(cfg, {}, torch.zeros((2, steps, batch, seq),
                                                     dtype=torch.int64),
                                list(lrs), warmup=1)
        return
    want = jens.train_ensemble(_members(arch, lrs, seeds, steps, batch, seq))
    params, tokens = _jax_seam(jcfg, seeds, steps, batch, seq)
    got = ensemble.train_gang(get_smoke(arch, compute_dtype=dtype), params,
                              tokens, list(lrs), warmup=max(1, steps // 10))
    assert got.shape == (steps, len(lrs))
    np.testing.assert_allclose(got[-1].numpy(), want, atol=LOSS_TOL[dtype],
                               rtol=LOSS_TOL[dtype])


def test_gang_of_one_is_a_plain_training_run():
    """M = 1 through the gang is the single-member train step of
    ``repro_torch.train.step`` with the member's lr on the same schedule."""
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import make_train_step
    cfg = get_smoke("gemma3-1b", compute_dtype="float32")
    params, tokens = ensemble.init_members(cfg, [5], 3, 2, 16, "cpu")
    single = ensemble.tree_map(lambda t: t[0].clone(), params)
    got = ensemble.train_gang(cfg, params, tokens, [2e-3], warmup=1)
    opt = AdamW(schedule=cosine_schedule(2e-3, 1, 3))
    step = make_train_step(cfg, opt)
    state = {"params": single, "opt": opt.init(single),
             "step": torch.zeros((), dtype=torch.int32)}
    want = []
    for i in range(3):
        toks = tokens[0, i]
        state, metrics = step(state, {"tokens": toks,
                                      "labels": torch.roll(toks, -1, dims=-1)})
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-6, atol=1e-6)
    for key, leaf in bridge.flatten(params).items():
        np.testing.assert_allclose(leaf[0].detach(), bridge.flatten(state["params"])[key].detach(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_gang_chunked_cross_entropy_matches_unchunked():
    """``loss_chunk`` under the member axis: each CE chunk vmapped inside
    its checkpoint gives the unchunked losses."""
    losses = []
    for chunk in (0, 8):
        cfg = get_smoke("gemma3-1b", compute_dtype="float32", loss_chunk=chunk)
        params, tokens = ensemble.init_members(cfg, [0, 1], 2, 2, 16, "cpu")
        losses.append(ensemble.train_gang(cfg, params, tokens, [1e-3, 3e-3], warmup=1))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5, atol=1e-5)


@pytest.fixture
def plain_launches(monkeypatch):
    return patch_plain_launches(monkeypatch)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen)


def test_flash_attention_vmap_rule_launches_once_for_all_members(plain_launches):
    m, b, s, hq, hkv, d = 3, 2, 24, 4, 2, 16
    gen = torch.Generator().manual_seed(0)
    q, k, v = (_randn(gen, m, b, s, h, d).requires_grad_() for h in (hq, hkv, hkv))
    do = _randn(gen, m, b, s, hq, d)

    def attend(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, window=8)

    out = torch.func.vmap(attend)(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert plain_launches["fa"] == 1 and plain_launches["fa_bwd"] == 1
    for i in range(m):
        qi, ki, vi = (t[i].detach().requires_grad_() for t in (q, k, v))
        want = fa.flash_attention_plain(qi, ki, vi, causal=True, window=8)
        want_grads = torch.autograd.grad(want, (qi, ki, vi), do[i])
        np.testing.assert_allclose(out[i].detach(), want.detach(), atol=1e-5)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g[i], w, atol=1e-5)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_vmap_rule_launches_once_for_all_members(plain_launches, with_init):
    m, b, s, h, p, g, n, chunk = 3, 2, 32, 4, 8, 2, 8, 16
    gen = torch.Generator().manual_seed(1)
    x = _randn(gen, m, b, s, h, p).requires_grad_()
    la = (-torch.rand((m, b, s, h), generator=gen)).requires_grad_()
    bm, cm = (_randn(gen, m, b, s, g, n).requires_grad_() for _ in range(2))
    init = _randn(gen, m, b, h, p, n).requires_grad_() if with_init else None
    dy, dfin = _randn(gen, m, b, s, h, p), _randn(gen, m, b, h, p, n)
    ins = [x, la, bm, cm] + ([init] if with_init else [])

    def scan(x, la, bm, cm, *init):
        return kssd.ssd_scan(x, la, bm, cm, chunk=chunk,
                             initial_state=init[0] if init else None)

    y, final = torch.func.vmap(scan)(*ins)
    grads = torch.autograd.grad((y, final), ins, (dy, dfin))
    assert {k: plain_launches[k] for k in ("state", "scan", "state_bwd", "scan_bwd")} == \
        {"state": 1, "scan": 1, "state_bwd": 1, "scan_bwd": 1}
    for i in range(m):
        mine = [t[i].detach().requires_grad_() for t in ins]
        wy, wf = kssd.ssd_scan_plain(*mine[:4], chunk=chunk,
                                     initial_state=mine[4] if with_init else None)
        want = torch.autograd.grad((wy, wf), mine, (dy[i], dfin[i]))
        np.testing.assert_allclose(y[i].detach(), wy.detach(), atol=1e-4)
        np.testing.assert_allclose(final[i].detach(), wf.detach(), atol=1e-4)
        for got, w in zip(grads, want):
            np.testing.assert_allclose(got[i], w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,seq", [("gemma3-1b", 16), ("mamba2-780m", 32),
                                      ("olmoe-1b-7b", 16), ("hymba-1.5b", 16),
                                      ("hymba-1.5b", 32)])
def test_gang_step_launches_do_not_grow_with_members(plain_launches, arch, seq):
    """One gang step through the kernels' branches (plain launches;
    ``use_kernels`` sends CPU tensors there, and gemma3's smoke window of
    16 covers the sequence): the launches for M = 3 are those for M = 1,
    and the losses match.  hymba's smoke window of 16 covers a sequence of
    16 (one chunk); at 32 (two chunks) its one ``hyb_l`` layer attends by
    the windowed plain attention on the CPU, and only the two ``hyb_g``
    layers launch flash attention."""
    cfg = get_smoke(arch, compute_dtype="float32", use_kernels=True)
    counts, losses = {}, {}
    for m in (1, 3):
        params, tokens = ensemble.init_members(cfg, list(range(m)), 1, 2, seq, "cpu")
        for key in plain_launches:
            plain_launches[key] = 0
        losses[m] = ensemble.train_gang(cfg, params, tokens, [1e-3] * m, warmup=1)
        counts[m] = dict(plain_launches)
    assert counts[1] == counts[3]
    # the full remat runs each layer's forward twice; one backward a layer
    n = cfg.n_layers
    ssd = {"state": 2 * n, "scan": 2 * n, "state_bwd": n, "scan_bwd": n}
    attn = n if seq <= cfg.window else cfg.layer_types.count("hyb_g")
    want = {"gemma3-1b": {"fa": 2 * n, "fa_bwd": n},
            "mamba2-780m": ssd,
            "hymba-1.5b": {"fa": 2 * attn, "fa_bwd": attn, **ssd},
            # 3 grouped GEMMs a layer, each with a dx and a dw
            "olmoe-1b-7b": {"fa": 2 * n, "fa_bwd": n, "gmm": 6 * n,
                            "gmm_dx": 3 * n, "gmm_dw": 3 * n}}[arch]
    assert {k: v for k, v in counts[1].items() if v} == want
    np.testing.assert_allclose(losses[3][:, 0], losses[1][:, 0], atol=1e-5)


def test_mamba2_gang_learns():
    """A smoke mamba2 gang: finite losses that fall on repeated tokens."""
    cfg = get_smoke("mamba2-780m")
    params, tokens = ensemble.init_members(cfg, [0, 1], 1, 2, 32, "cpu")
    losses = ensemble.train_gang(cfg, params, tokens.expand(2, 6, 2, 32),
                                 [3e-3, 1e-2], warmup=1)
    assert bool(torch.isfinite(losses).all())
    assert bool((losses[-1] < losses[0]).all())


@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_moe_gang_matches_each_member_alone(dispatch):
    """A smoke olmoe gang of two members (own seed and lr): every step's
    loss of each member, its own MoE aux losses included, is that member's
    alone (M = 1)."""
    cfg = get_smoke("olmoe-1b-7b", compute_dtype="float32", moe_dispatch=dispatch)
    lrs = (1e-3, 3e-3)
    runs = {}
    for members in ((0,), (1,), (0, 1)):
        params, tokens = ensemble.init_members(cfg, members, 3, 2, 16, "cpu")
        runs[members] = ensemble.train_gang(cfg, params, tokens,
                                            [lrs[i] for i in members], warmup=1)
    for i in (0, 1):
        np.testing.assert_allclose(runs[(0, 1)][:, i], runs[(i,)][:, 0],
                                   rtol=1e-5, atol=1e-5)
    assert not torch.equal(runs[(0, 1)][:, 0], runs[(0, 1)][:, 1])


def test_engine_dispatches_the_port_gang_once(tmp_path):
    """The unchanged engine's GangExecutor packs a study of four members
    into one call of the port's train_ensemble (``tests/test_system.py``'s
    study of training runs, on the port)."""
    from repro.core import GangExecutor, ParameterStudy, parse_yaml, stackable_key
    spec = parse_yaml("""
lr_sweep:
  args:
    lr: [0.001, 0.002]
    seed: ["0:1"]
    arch: [gemma3-1b]
    steps: [3]
    batch: [2]
    seq: [16]
  command: train
""")
    study = ParameterStudy(spec, root=tmp_path, name="lr")
    gang = GangExecutor(
        stackable_key,
        lambda nodes: ensemble.train_ensemble([dict(n.combo) for n in nodes],
                                              device="cpu"))
    res = study.run(gang=gang)
    assert len(res) == 4
    assert gang.stats.dispatches == 1
    assert all(np.isfinite(r.value) for r in res.values())
