"""The port's AdamW, schedules and gradient utilities against the JAX
package's (``repro.optim.adamw``), on the CPU.

Inputs are numpy arrays from a seed, handed to both.  Tolerances: 1e-6 for
AdamW on identical gradients and for the schedules (fp32 arithmetic in the
same order); the int8 round trip exactly (the same rounding, half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch_parity import randn  # noqa: E402

torch.set_num_threads(1)   # the suite runs under 6 xdist workers

TOL = 1e-6


def _tree(seed=0):
    """A small parameter tree: matrices, a stacked norm scale (decayed,
    ndim 2), a vector and a list, as numpy."""
    return {"w": randn(seed, 8, 6, scale=0.1),
            "segments": [{"norm": randn(seed + 1, 3, 6, scale=0.1),
                          "wq": randn(seed + 2, 3, 6, 4, scale=0.1)}],
            "bias": randn(seed + 3, 6, scale=0.1)}


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, "cpu")


def _assert_trees_close(got, want, tol):
    got = bridge.flatten(bridge.params_to_numpy(got))
    want = bridge.flatten(jax.device_get(want))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w), atol=tol, rtol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match_reference_across_the_warmup_edge(kind):
    args = (3e-4, 10, 100)
    ref = getattr(jadamw, f"{kind}_schedule")(*args)
    port = getattr(adamw, f"{kind}_schedule")(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=TOL, abs=1e-12), step


def test_schedule_values():
    cos = adamw.cosine_schedule(1.0, 10, 100)
    assert float(cos(0)) == 0.0
    assert float(cos(10)) == pytest.approx(1.0)
    assert float(cos(100)) == pytest.approx(0.1, abs=1e-6)
    assert float(adamw.linear_schedule(1.0, 10, 110)(60)) == pytest.approx(0.5)


@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (0.0, 0.1), (1e3, 0.0)],
                         ids=["clipped", "no-clip", "no-decay"])
def test_adamw_on_identical_grads_matches_reference(clip, decay):
    """Three updates from the same parameters and gradients: m, v, master,
    count, the new parameters and the metrics."""
    jp, tp = _both(_tree())
    kw = dict(weight_decay=decay, clip_norm=clip)
    jopt = jadamw.AdamW(schedule=jadamw.cosine_schedule(1e-2, 2, 10), **kw)
    opt = adamw.AdamW(schedule=adamw.cosine_schedule(1e-2, 2, 10), **kw)
    js, ts = jopt.init(jp), opt.init(tp)
    for i in range(3):
        jg, tg = _both(jax.tree.map(lambda x: x * 30.0, _tree(10 + i)))
        jp, js, jm = jopt.update(jg, js, jp)
        tp, ts, tm = opt.update(tg, ts, tp)
        for key in ("lr", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TOL)
        _assert_trees_close(tp, jp, TOL)
        for part in ("m", "v", "master"):
            _assert_trees_close(ts[part], js[part], TOL)
        assert int(ts["count"]) == int(js["count"]) == i + 1


def test_clipping_bounds_the_update():
    opt = adamw.AdamW(schedule=lambda c: torch.tensor(1e-2), clip_norm=1.0)
    params = {"w": torch.ones((8, 8))}
    state = opt.init(params)
    _, state, metrics = opt.update({"w": torch.full((8, 8), 1e6)}, state, params)
    assert float(metrics["grad_norm"]) > 1e6
    # the clipped gradient has norm 1: m = 0.1 · g / |g|
    assert float(adamw.global_norm(state["m"])) == pytest.approx(0.1, rel=1e-5)


def test_decay_reaches_the_leaves_of_two_or_more_dims_only():
    """With a zero gradient the step is the decay alone: matrices and the
    stacked (n_layers, d) norm scales shrink by lr · wd · w, vectors stay.
    (The stacked norm scales decaying is the reference's behaviour.)"""
    _, tp = _both(_tree())
    before = bridge.flatten(jax.tree.map(np.copy, bridge.params_to_numpy(tp)))
    opt = adamw.AdamW(schedule=lambda c: torch.tensor(0.5), weight_decay=0.1)
    state = opt.init(tp)
    zeros = jax.tree.map(torch.zeros_like, tp)
    tp, _, _ = opt.update(zeros, state, tp)
    after = bridge.flatten(bridge.params_to_numpy(tp))
    for key, w in before.items():
        want = w if w.ndim < 2 else w * (1 - 0.5 * 0.1)
        np.testing.assert_allclose(after[key], want, rtol=1e-6, err_msg=key)


def test_master_is_a_copy():
    _, tp = _both(_tree())
    state = adamw.AdamW(schedule=lambda c: torch.tensor(1e-3)).init(tp)
    for key, w in bridge.flatten(state["master"]).items():
        p = bridge.flatten(tp)[key]
        assert w.dtype == torch.float32
        assert w.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
        assert torch.equal(w, p)


def test_global_norm():
    tree = {"a": torch.ones(3), "b": [torch.ones(4)]}
    assert float(adamw.global_norm(tree)) == pytest.approx(7 ** 0.5)


def _quadratic_loss(p, batch):
    """A loss of a parameter tree and a batch with a leading axis."""
    err = batch["x"] @ p["w"] - batch["y"]
    loss = (err ** 2).mean() + (p["b"] ** 2).sum() * batch["x"].mean()
    return loss, {"err": abs(err).mean()}


def test_accumulate_grads_matches_reference_at_two_microbatches():
    rng = np.random.default_rng(0)
    params = {"w": randn(1, 5, 3), "b": randn(2, 3)}
    batches = {"x": rng.standard_normal((2, 4, 5)).astype(np.float32),
               "y": rng.standard_normal((2, 4, 3)).astype(np.float32)}
    jp, tp = _both(params)
    jb, tb = _both(batches)
    jg, jl, jaux = jadamw.accumulate_grads(
        lambda p, b: _quadratic_loss(p, b), jp, jb, 2)
    tg, tl, taux = adamw.accumulate_grads(_quadratic_loss, tp, tb, 2)
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    # the aux is the last microbatch's
    assert float(taux["err"]) == pytest.approx(float(jaux["err"]), rel=TOL)
    with torch.no_grad():
        _, last = _quadratic_loss(tp, {k: v[1] for k, v in tb.items()})
    assert float(taux["err"]) == pytest.approx(float(last["err"]), rel=TOL)
    _assert_trees_close(tg, jg, 1e-5)


def test_int8_round_trip_matches_reference():
    tree = {"a": randn(3, 64, 64), "b": [randn(4, 7) * 1e-3]}
    jt, tt = _both(tree)
    jq, tq = jadamw.compress_int8(jt), adamw.compress_int8(tt)
    for key, want in bridge.flatten(jax.device_get(jq)).items():
        got = bridge.flatten(tq)[key]
        if key.endswith("/q"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert float(got) == pytest.approx(float(want), rel=TOL)
    rt = adamw.decompress_int8(tq)
    _assert_trees_close(rt, jadamw.decompress_int8(jq), TOL)
    err = (rt["a"] - tt["a"]).abs().max()
    assert float(err) <= float(tt["a"].abs().max()) / 127.0 + 1e-6
