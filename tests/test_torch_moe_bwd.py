"""The grouped matmul's gradient on the CPU against the JAX package.

* The plain versions ``grouped_matmul_dx_ref`` and ``grouped_matmul_dw_ref``
  against ``jax.vjp`` of ``jax.lax.ragged_dot``, the product the reference
  differentiates (``repro.models.moe.moe_ragged``): 2e-5 of the output's
  largest |element| in fp32 (summation order only), 2e-2 in bf16 (the
  reference's kernel tolerance), with empty experts, every row in one
  expert and ragged groups.
* ``GroupedMatmul`` (the kernels' autograd.Function, which a CPU tensor
  reaches under grad or vmap and runs with the plain versions) against
  autograd of ``grouped_matmul_ref``; under ``torch.func.vmap(
  torch.func.grad(...))`` against a loop over the members; the fold of its
  vmap rule (members into the expert axis) and its refusal past
  ``MAX_EXPERTS``.
* The MoE layer's gradient, both dispatches, against ``jax.grad`` of
  ``repro.models.moe.moe_block`` in fp32, aux losses included as
  ``loss_fn`` weighs them.

The kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402

from repro_torch.kernels import moe_gmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import JNP, both, np32, randn  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}

#: (T, d, E, f, group sizes): ragged groups with empty ones, every row in
#: one expert, the first and last expert empty, one row
CASES = [
    (64, 32, 6, 16, [5, 0, 17, 1, 0, 41]),
    (48, 16, 4, 24, [0, 0, 48, 0]),
    (40, 16, 6, 16, [0, 13, 0, 0, 27, 0]),
    (1, 32, 4, 8, [0, 1, 0, 0]),
    (96, 24, 8, 32, None),
]


def _sizes(t: int, e: int, sizes) -> np.ndarray:
    if sizes is not None:
        return np.asarray(sizes, np.int32)
    cuts = np.sort(np.random.default_rng(t).integers(0, t, e - 1))
    return np.diff(np.concatenate([[0], cuts, [t]])).astype(np.int32)


def _close(got, want, tol: float) -> None:
    want = np32(want)
    np.testing.assert_allclose(np32(got), want,
                               atol=tol * max(np.abs(want).max(), 1e-30), rtol=tol)


@pytest.mark.parametrize("t,d,e,f,sizes", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gradient_matches_vjp_of_ragged_dot(dtype, t, d, e, f, sizes):
    gs = _sizes(t, e, sizes)
    xj, xt = both(randn(1, t, d), dtype)
    wj, wt = both(randn(2, e, d, f, scale=0.1), dtype)
    dyj, dyt = both(randn(3, t, f), dtype)
    _, vjp = jax.vjp(lambda x, w: jax.lax.ragged_dot(x, w, jnp.asarray(gs)), xj, wj)
    want_dx, want_dw = vjp(dyj)
    got_dx = tref.grouped_matmul_dx_ref(dyt, wt, torch.from_numpy(gs))
    got_dw = tref.grouped_matmul_dw_ref(xt, dyt, torch.from_numpy(gs))
    assert got_dx.dtype == got_dw.dtype == getattr(torch, dtype)
    assert got_dx.shape == (t, d) and got_dw.shape == (e, d, f)
    _close(got_dx, want_dx, TOLS[dtype])
    _close(got_dw, want_dw, TOLS[dtype])
    # an empty expert's slab is exactly zero
    assert not got_dw[torch.from_numpy(gs == 0)].any()


@pytest.mark.parametrize("t,d,e,f,sizes", CASES)
def test_function_gradient_matches_autograd_of_the_plain_forward(t, d, e, f, sizes):
    gs = torch.from_numpy(_sizes(t, e, sizes))
    x = torch.from_numpy(randn(4, t, d)).requires_grad_()
    w = torch.from_numpy(randn(5, e, d, f, scale=0.1)).requires_grad_()
    dy = torch.from_numpy(randn(6, t, f))
    y = moe_gmm.grouped_matmul(x, w, gs)
    assert type(y.grad_fn).__name__ == "GroupedMatmulBackward"
    got = torch.autograd.grad(y, (x, w), dy)
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    want = torch.autograd.grad(tref.grouped_matmul_ref(xr, wr, gs), (xr, wr), dy)
    np.testing.assert_allclose(y.detach(), tref.grouped_matmul_ref(x.detach(), w.detach(), gs))
    for g, wt in zip(got, want):
        _close(g, wt, TOLS["float32"])


def test_function_returns_dw_in_the_weights_dtype():
    """bf16 rows against fp32 weights: dx in x's dtype, dw in w's."""
    gs = torch.tensor([3, 0, 5], dtype=torch.int32)
    x = torch.from_numpy(randn(7, 8, 16)).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(randn(8, 3, 16, 8, scale=0.1)).requires_grad_()
    dx, dw = torch.autograd.grad(moe_gmm.grouped_matmul(x, w, gs).float().sum(), (x, w))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert not dw[1].any()


def _member_inputs(m: int, t: int, d: int, e: int, f: int):
    xs = torch.from_numpy(randn(10, m, t, d))
    ws = torch.from_numpy(randn(11, m, e, d, f, scale=0.1))
    gs = torch.stack([torch.from_numpy(_sizes(t + i, e, None)) for i in range(m)])
    gs[:, -1] += t - gs.sum(-1)   # each member's sizes sum to t
    return xs, ws, gs


def test_vmap_of_grad_matches_a_loop_over_members():
    xs, ws, gs = _member_inputs(2, 40, 16, 5, 8)
    cot = torch.from_numpy(randn(12, 2, 40, 8))

    def loss(x, w, g, c):
        return (moe_gmm.grouped_matmul(x, w, g) * c).sum()

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(xs, ws, gs, cot)
    for i in range(2):
        want = torch.func.grad(lambda x, w: (tref.grouped_matmul_ref(
            x, w, gs[i]) * cot[i]).sum(), argnums=(0, 1))(xs[i], ws[i])
        for g, wt in zip(got, want):
            _close(g[i], wt, TOLS["float32"])


@pytest.mark.parametrize("shared", ["none", "weights"])
def test_vmap_rule_folds_members_into_the_expert_axis(monkeypatch, shared):
    """One forward and one backward call for all members, on x (M·T, d),
    w (M·E, d, f) and group sizes (M·E,) in member-major order (weights
    shared by the members are repeated); results as a loop."""
    m, t, d, e, f = 3, 24, 8, 4, 8
    xs, ws, gs = _member_inputs(m, t, d, e, f)
    seen = {"fwd": [], "dx": [], "dw": []}
    fwd, dx, dw = moe_gmm._forward, moe_gmm.grouped_matmul_dx, moe_gmm.grouped_matmul_dw

    def spy(name, fn):
        def call(*args, **kwargs):
            seen[name].append([a.shape for a in args] + [args[-1].clone()])
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(moe_gmm, "_forward", spy("fwd", fwd))
    monkeypatch.setattr(moe_gmm, "grouped_matmul_dx", spy("dx", dx))
    monkeypatch.setattr(moe_gmm, "grouped_matmul_dw", spy("dw", dw))
    w_in = ws[0] if shared == "weights" else ws
    x = xs.clone().requires_grad_()
    w = w_in.clone().requires_grad_()
    y = torch.func.vmap(moe_gmm.grouped_matmul,
                        in_dims=(0, None if shared == "weights" else 0, 0))(x, w, gs)
    cot = torch.from_numpy(randn(13, m, t, f))
    gx, gw = torch.autograd.grad(y, (x, w), cot)
    assert [len(v) for v in seen.values()] == [1, 1, 1]
    assert seen["fwd"][0][:3] == [(m * t, d), (m * e, d, f), (m * e,)]
    assert seen["dw"][0][:3] == [(m * t, d), (m * t, f), (m * e,)]
    assert torch.equal(seen["fwd"][0][3], gs.reshape(-1))
    for i in range(m):
        wi = w_in if shared == "weights" else w_in[i]
        xr, wr = xs[i].clone().requires_grad_(), wi.clone().requires_grad_()
        yi = tref.grouped_matmul_ref(xr, wr, gs[i])
        _close(y[i].detach(), yi.detach(), TOLS["float32"])
        want_x, want_w = torch.autograd.grad(yi, (xr, wr), cot[i])
        _close(gx[i], want_x, TOLS["float32"])
        if shared != "weights":
            _close(gw[i], want_w, TOLS["float32"])
    if shared == "weights":   # the members' parts summed into one gradient
        want = sum(tref.grouped_matmul_dw_ref(xs[i], cot[i], gs[i]) for i in range(m))
        _close(gw, want, TOLS["float32"])


def test_vmap_rule_refuses_more_groups_than_the_kernel_takes():
    m, e = 3, moe_gmm.MAX_EXPERTS // 2
    x = torch.zeros((m, 4, 8))
    w = torch.zeros((m, e, 8, 8))
    gs = torch.zeros((m, e), dtype=torch.int32)
    gs[:, 0] = 4
    with pytest.raises(ValueError, match=f"at most {moe_gmm.MAX_EXPERTS}"):
        torch.func.vmap(moe_gmm.grouped_matmul)(x, w, gs)


def _moe_params(seed: int, d: int, e: int, f: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(d, e)) * 0.1,
            "wi_gate": rng.normal(size=(e, d, f)) * 0.1,
            "wi_up": rng.normal(size=(e, d, f)) * 0.1,
            "wo": rng.normal(size=(e, f, d)) * 0.1}


@pytest.mark.parametrize("dispatch,capacity_factor", [
    ("ragged", 1.25), ("einsum", 1.25), ("einsum", 0.5)])
def test_moe_block_gradient_matches_jax(dispatch, capacity_factor):
    """fp32: the gradient of sum(out · c) + 0.01·load_balance +
    0.001·router_z for x and every weight (the einsum dispatch at a
    capacity that drops rows too)."""
    b, s, d, e, f, k = 2, 32, 32, 8, 16, 2
    p = _moe_params(0, d, e, f)
    xn, cn = randn(1, b, s, d), randn(2, b, s, d)
    kw = dict(n_experts=e, n_shared=0, top_k=k, capacity_factor=capacity_factor,
              act="silu", router_renorm=False, dispatch=dispatch, groups=1)

    def jloss(x, params):
        out, aux = jmoe.moe_block(x, params, compute_dtype=JNP["float32"], **kw)
        return ((out * jnp.asarray(cn)).sum() + 0.01 * aux["load_balance"]
                + 0.001 * aux["router_z"])

    pj = {key: jnp.asarray(v, jnp.float32) for key, v in p.items()}
    want_x, want_p = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xn), pj)

    x = torch.from_numpy(xn).requires_grad_()
    pt = {key: torch.from_numpy(v.astype(np.float32)).requires_grad_()
          for key, v in p.items()}
    out, aux = tmoe.moe_block(x, pt, compute_dtype="float32", **kw)
    loss = ((out * torch.from_numpy(cn)).sum() + 0.01 * aux["load_balance"]
            + 0.001 * aux["router_z"])
    names = sorted(pt)
    got = torch.autograd.grad(loss, [x] + [pt[n] for n in names])
    _close(got[0], want_x, TOLS["float32"])
    for name, g in zip(names, got[1:]):
        _close(g, want_p[name], TOLS["float32"])
