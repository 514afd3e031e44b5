"""The train steps as the port captures them on the card: steps that
replay.  A CUDA graph replays the kernels its capture recorded, with their
arguments, on the same buffers; so a step must read its count on the
device, build nothing from host data and keep every state leaf's storage.
Held here on the CPU, on the smoke configs of the archs that train on one
card (gemma3-1b, mamba2-780m, hymba-1.5b, olmoe-1b-7b, hubert-xlarge),
gemma3-1b also on a one-rank mesh (``launch.train``'s data-parallel step),
and on the gang:

* the step's aten ops, forward, backward and update, with their
  non-tensor arguments and their tensors' dtypes and shapes, are the same
  at steps 1 and 2, and hold no tensor made from host data
  (``aten.lift_fresh``), no ``.item()`` (``aten._local_scalar_dense``) and
  no ``aten.nonzero``; each kernel launch is recorded as one op with its
  operands' shapes (as on the card), its plain version unrecorded;
* after a step every leaf of ``params``, ``opt`` and ``step`` keeps its
  storage, and ``count`` and ``step`` are the same 0-d tensors, one higher
  (the gang: its count, index and losses);
* the step run as :class:`GraphedTrainStep` runs it, the batch copied into
  fixed buffers, matches the jitted JAX step on bridged state over 3 steps
  at the tolerances of ``test_torch_train.py``'s
  ``test_train_step_matches_reference`` (every step's metrics, the
  parameters after the first, the moments after the last); the gang, each step's tokens taken
  through its device index, matches the reference's ``train_one`` under
  ``jax.vmap`` at those of ``test_torch_ensemble.py``'s
  ``test_gang_matches_jax_from_the_same_init_and_tokens``, and
  ``train_members``, which loads each member into one gang's buffers,
  matches the reference's one dispatch a member.

On a card the graphed steps are held against the eager steps
(``tests/test_torch_cuda.py``, marked ``cuda``; ``chip_smoke.py``'s
``graph_train`` phase at full width)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.train import ensemble as jens  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train import ensemble  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    GraphedTrainStep, init_train_state, make_train_step,
)
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_launches import Trace, assert_same_and_clean, record_launches  # noqa: E402

torch.set_num_threads(1)   # the suite runs under 6 xdist workers

ARCHS = ["gemma3-1b", "mamba2-780m", "hymba-1.5b", "olmoe-1b-7b", "hubert-xlarge"]
BATCH, SEQ, STEPS = 2, 32, 3
GRAD_TOL = 1e-4            # test_torch_train.py's tolerances
METRIC_TOL = 1e-5
GANG_TOL = {"float32": 1e-4, "bfloat16": 5e-3}   # test_torch_ensemble.py's


def _host_batch(cfg, seed):
    """A host batch by the input mode: tokens and next-token labels, or
    frame embeddings and random labels (``embeds``), some labels -100."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = (rng.standard_normal((BATCH, SEQ, cfg.d_model)) * 0.1
                         ).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
        labels = np.roll(out["tokens"], -1, axis=1)
    labels[0, :3] = -100
    out["labels"] = labels
    return out


def _state(arch, mesh=None, **overrides):
    cfg = get_smoke(arch, compute_dtype="float32", **overrides)
    opt = AdamW(schedule=cosine_schedule(1e-3, 2, 10))
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, opt, init_train_state(cfg, opt, gen, mesh)


def _traced_steps(cfg, opt, state, monkeypatch):
    """Two steps' traces on two batches."""
    step = make_train_step(cfg, opt)
    traces = []
    for seed in (1, 2):
        batch = {k: torch.from_numpy(v) for k, v in _host_batch(cfg, seed).items()}
        trace = Trace()
        record_launches(monkeypatch, trace)
        with trace:
            step(state, batch)
        monkeypatch.undo()
        traces.append(trace.ops)
    return traces


@pytest.mark.parametrize("arch", ARCHS)
def test_step_is_the_same_at_steps_one_and_two(arch, monkeypatch):
    cfg, opt, state = _state(arch, use_kernels=True)
    first, second = _traced_steps(cfg, opt, state, monkeypatch)
    assert_same_and_clean(first, second, launches=cfg.causal)
    assert int(state["step"]) == int(state["opt"]["count"]) == 2


def test_one_rank_mesh_step_is_the_same_at_steps_one_and_two(monkeypatch):
    """``launch.train``'s step on one card: the data-parallel step on a
    one-rank (data 1, model 1) mesh, whose state is DTensors."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    started = not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        cfg, opt, state = _state("gemma3-1b", mesh, use_kernels=True)
        first, second = _traced_steps(cfg, opt, state, monkeypatch)
        assert_same_and_clean(first, second)
        assert int(state["step"].to_local()) == 2
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_step_keeps_every_state_leaf(arch):
    cfg, opt, state = _state(arch)
    count, step_count = state["opt"]["count"], state["step"]
    for t in (count, step_count):
        assert t.dim() == 0 and t.dtype == torch.int32 and int(t) == 0
    leaves = tree_leaves(state)
    storages = [leaf.untyped_storage().data_ptr() for leaf in leaves]
    step = make_train_step(cfg, opt)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in _host_batch(cfg, i).items()}
        out, _ = step(state, batch)
        assert out is state
        assert out["opt"]["count"] is count and out["step"] is step_count
        assert int(count) == int(step_count) == i + 1
        assert [leaf.untyped_storage().data_ptr() for leaf in tree_leaves(out)
                ] == storages


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


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_step_matches_jax_over_three_steps(arch):
    """The step through GraphedTrainStep (on the CPU: eager on its fixed
    buffers, each batch copied in) against the jitted JAX step, from the
    same bridged state on the same batches, every step's metrics and the
    state after the last."""
    jcfg = jget_smoke(arch, compute_dtype="float32")
    cfg = get_smoke(arch, compute_dtype="float32")
    jp = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0)))
    jopt = JAdamW(schedule=jcosine(1e-3, 2, 10))
    opt = AdamW(schedule=cosine_schedule(1e-3, 2, 10))
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    state = bridge.params_from_numpy(jax.device_get(jstate), "cpu")
    batches = [_host_batch(cfg, seed) for seed in range(STEPS)]
    graphed = GraphedTrainStep(make_train_step(cfg, opt), state, batches[0])
    buffers = dict(graphed.batch)
    jstep = jax.jit(jmake_train_step(jcfg, jopt))
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.astype(np.int32)
                                                   if v.dtype == np.int64 else v)
                                    for k, v in batch.items()})
        out, tm = graphed(state, batch)
        assert out is state and graphed.graph is None
        assert all(graphed.batch[k] is buffers[k] for k in buffers)
        assert set(tm) == set(jm)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=METRIC_TOL)
        if i == 0:
            _assert_params_close(state, jstate)
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    assert int(state["opt"]["count"]) == STEPS
    _assert_leaves_close(state["opt"]["m"], jstate["opt"]["m"], GRAD_TOL)
    _assert_leaves_close(state["opt"]["v"], jstate["opt"]["v"], 2 * GRAD_TOL)


def _assert_params_close(state, jstate):
    """After the first step, the parameters and the master to 1e-6 wherever
    the gradient's sign is settled at the gradient tolerance (Adam's first
    step moves each weight by lr·sign(g)), as ``test_torch_train.py``
    holds one step.  (Later steps divide by the second moment of such
    gradients, so the parameters are held there through the metrics and
    the moments.)"""
    m_ref = _flat(jstate["opt"]["m"])
    for part in (["params"], ["opt", "master"]):
        got, want = state, jstate
        for p in part:
            got, want = got[p], want[p]
        got, want = _flat(got), _flat(want)
        for key, w in want.items():
            g = m_ref[key.replace("params/", "").replace("opt/master/", "")]
            settled = np.abs(g) > GRAD_TOL * np.abs(g).max()
            off = np.abs(got[key] - w) > 1e-6
            assert not (off & settled).any(), key


def test_a_captures_events_are_reported_at_each_replay():
    """What a capture reports to ``repro_torch.events`` (a collective, a
    kernel call's cost) reaches no listener then, since a capture runs
    nothing; each replay reports it again, to the listeners of that moment
    (``CapturedStep`` records with ``events.recording`` and replays with
    ``events.replay``)."""
    from repro_torch import events
    heard = []
    with events.counting(lambda *event: heard.append(event)):
        with events.recording() as recorded:
            assert events.active()
            events.report(events.COLLECTIVE, "all-reduce", "data", 8)
            events.report(events.KERNEL, "flash_attention", 10, 20)
        assert heard == []
        assert recorded == [(events.COLLECTIVE, "all-reduce", "data", 8),
                            (events.KERNEL, "flash_attention", 10, 20)]
        events.replay(recorded)
        events.replay(recorded)
    assert heard == recorded * 2
    events.replay(recorded)              # nothing listens: nothing is reported
    assert len(heard) == 4 and not events.active()


def test_graphed_step_refuses_another_state_or_batch():
    cfg, opt, state = _state("gemma3-1b")
    batch = _host_batch(cfg, 0)
    graphed = GraphedTrainStep(make_train_step(cfg, opt), state, batch)
    with pytest.raises(ValueError, match="state it was built with"):
        graphed(dict(state), batch)
    with pytest.raises(ValueError, match="batch 'tokens'"):
        graphed(state, {**batch, "tokens": batch["tokens"][:, :8]})


# ---------------------------------------------------------------------------
# The gang
# ---------------------------------------------------------------------------

def _gang(arch="gemma3-1b", m=2, steps=STEPS, dtype="float32", **overrides):
    cfg = get_smoke(arch, compute_dtype=dtype, **overrides)
    params, tokens = ensemble.init_members(cfg, list(range(m)), steps, 2, 16, "cpu")
    return ensemble.Gang(cfg, params, tokens, [1e-3, 3e-3][:m], warmup=1)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "hymba-1.5b"])
def test_gang_step_is_the_same_at_steps_one_and_two(arch, monkeypatch):
    gang = _gang(arch, use_kernels=True)
    traces = []
    for _ in range(2):
        trace = Trace()
        record_launches(monkeypatch, trace)
        with trace:
            gang.step()
        monkeypatch.undo()
        traces.append(trace.ops)
    assert_same_and_clean(*traces)
    assert int(gang.index) == 2


def test_gang_step_keeps_every_leaf_and_fills_its_losses():
    gang = _gang()
    index, count, losses = gang.index, gang.opt_state["count"], gang.losses
    leaves = tree_leaves((gang.params, gang.opt_state, gang.tokens, gang.lr))
    storages = [leaf.untyped_storage().data_ptr() for leaf in leaves]
    for i in range(STEPS):
        gang.step()
        assert gang.index is index and int(index) == i + 1
        assert gang.opt_state["count"] is count and count.tolist() == [i + 1] * 2
        assert [leaf.untyped_storage().data_ptr() for leaf in tree_leaves(
            (gang.params, gang.opt_state, gang.tokens, gang.lr))] == storages
    assert gang.run() is losses and bool((losses != 0).all())
    with pytest.raises(ValueError, match="run its 3 steps"):
        gang.step()


def _jax_seam(jcfg, seeds, steps, batch, seq):
    """Each member's initial parameters and tokens as the JAX ``train_one``
    derives them: (stacked port parameters, tokens (M, steps, B, S))."""
    params, tokens = [], []
    for seed in seeds:
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        params.append(bridge.params_from_numpy(jax.device_get(jinit(jcfg, key)), "cpu"))
        keys = jax.random.split(jax.random.fold_in(key, 1), steps)
        tokens.append(np.stack([np.asarray(jax.random.randint(
            k, (batch, seq), 0, jcfg.vocab_size)) for k in keys]))
    return (ensemble.stack_members(params),
            torch.from_numpy(np.stack(tokens).astype(np.int64)))


def _members(arch, lrs, seeds, steps, batch, seq):
    return [{"args:lr": lr, "args:seed": seed, "args:arch": arch,
             "args:steps": steps, "args:batch": batch, "args:seq": seq}
            for lr, seed in zip(lrs, seeds)]


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m", "olmoe-1b-7b",
                                  "hymba-1.5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gang_stepped_matches_jax(monkeypatch, arch, dtype):
    """The gang one step at a time through its device index, from the
    reference's own initial parameters and tokens, against its
    ``jax.vmap(train_one)``: each member's last loss."""
    steps, batch, seq = 4, 2, 16
    lrs, seeds = (1e-3, 3e-3), (0, 1)
    jcfg = jget_smoke(arch, compute_dtype=dtype)
    monkeypatch.setattr(jens, "get_smoke", lambda a: jget_smoke(a, compute_dtype=dtype))
    want = jens.train_ensemble(_members(arch, lrs, seeds, steps, batch, seq))
    params, tokens = _jax_seam(jcfg, seeds, steps, batch, seq)
    gang = ensemble.Gang(get_smoke(arch, compute_dtype=dtype), params, tokens,
                         list(lrs), warmup=max(1, steps // 10))
    for i in range(steps):
        gang.step()
        assert int(gang.index) == i + 1
    np.testing.assert_allclose(gang.losses[-1].numpy(), want, atol=GANG_TOL[dtype],
                               rtol=GANG_TOL[dtype])


def test_members_loaded_into_one_gang_match_jax(monkeypatch):
    """One gang of one member, each next member loaded into its buffers
    (what ``train_members`` does; one capture on a card), from the
    reference's initial parameters and tokens: each member's last loss is
    the reference's one dispatch a member (fp32)."""
    steps, batch, seq = 3, 2, 16
    lrs, seeds = (1e-3, 3e-3, 2e-3), (0, 1, 2)
    members = _members("gemma3-1b", lrs, seeds, steps, batch, seq)
    monkeypatch.setattr(jens, "get_smoke",
                        lambda a: jget_smoke(a, compute_dtype="float32"))
    want = jens.train_members(members)
    jcfg = jget_smoke("gemma3-1b", compute_dtype="float32")
    cfg = get_smoke("gemma3-1b", compute_dtype="float32")
    got, gang = [], None
    for lr, seed in zip(lrs, seeds):
        params, tokens = _jax_seam(jcfg, [seed], steps, batch, seq)
        if gang is None:
            gang = ensemble.Gang(cfg, params, tokens, [lr], warmup=1)
        else:
            gang.load(params, tokens, [lr])
        got.append(float(gang.run()[-1, 0]))
    np.testing.assert_allclose(got, want, atol=GANG_TOL["float32"],
                               rtol=GANG_TOL["float32"])


def test_train_members_builds_one_gang(monkeypatch):
    """``train_members`` builds one gang for all its members, and each
    member's loss is its own run's (a gang of it alone)."""
    members = _members("gemma3-1b", (1e-3, 3e-3, 2e-3), (0, 1, 2), 3, 2, 16)
    built = []
    gang_cls = ensemble.Gang

    def counted(*args, **kwargs):
        built.append(gang_cls(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(ensemble, "Gang", counted)
    got = ensemble.train_members(members, device="cpu")
    assert len(built) == 1
    alone = [ensemble.train_ensemble([m], device="cpu")[0] for m in members]
    assert len(built) == 4
    np.testing.assert_allclose(got, alone, rtol=1e-6, atol=1e-6)
