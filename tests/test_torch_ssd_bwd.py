"""The SSD scan's backward on the CPU against the JAX package.

``ssd_scan_bwd_plain`` (the two backward kernels' plain versions and the
glue between them) is held against ``jax.grad`` of the JAX oracles,
``repro.kernels.ref.ssd_scan_ref`` (the exact sequential recurrence) and
``repro.models.ssm.ssd_chunked`` (the XLA path), on the same numpy inputs
and cotangents, and against torch autograd of ``ssd_scan_plain``: G < H,
with and without an initial state, with and without a gradient of the
final state.  Tolerances, the reference's SSD ones: 1e-4 in fp32, 5e-2 in
bf16 (atol and rtol), on dx, dlog_a, dB and dC (summed over each group's
heads) and the initial state's gradient.  Then :class:`SSDScan`'s
plumbing with the launches replaced by the plain versions: a gradient
through ``ssd_scan`` on a "card" tensor reaches the Function and matches
autograd; the wrappers on CPU tensors, the heads a backward block walks and
the glue that adds dB's and dC's slices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from torch_parity import assert_close, both, np32, patch_plain_launches  # noqa: E402

TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
NAMES = ("dx", "dlog_a", "dB", "dC", "dinit")

SHAPES = [  # s, h, p, g, n, chunk
    (64, 4, 16, 2, 16, 16),     # G < H, four chunks
    (48, 3, 8, 1, 8, 16),       # one group for three heads
    (32, 2, 16, 2, 8, 32),      # one chunk
    (40, 2, 8, 1, 16, 64),      # S < chunk
]


def _inputs(s, h, p, g, n, dtype, init, dfinal, bsz=2, seed=0):
    """{name: (jax, torch)} for x, log_a (fp32), b, c, the initial state
    and the cotangents dy and dfinal."""
    rng = np.random.default_rng(seed)
    arrays = {
        "x": rng.standard_normal((bsz, s, h, p)) * 0.5,
        "log_a": -np.log1p(np.exp(rng.standard_normal((bsz, s, h)))) * 0.3,
        "b": rng.standard_normal((bsz, s, g, n)) * 0.3,
        "c": rng.standard_normal((bsz, s, g, n)) * 0.3,
        "dy": rng.standard_normal((bsz, s, h, p)),
    }
    if init:
        arrays["init"] = rng.standard_normal((bsz, h, p, n)) * 0.5
    if dfinal:
        arrays["dfinal"] = rng.standard_normal((bsz, h, p, n))
    return {k: both(v, "float32" if k == "log_a" else dtype) for k, v in arrays.items()}


def _jax_grads(fn, t, chunk_args):
    """jax.grad of sum(y·dy) + sum(final·dfinal) in fp32."""
    init = t["init"][0] if "init" in t else None

    def loss(x, la, b, c, i0):
        y, final = fn(x, la, b, c, *chunk_args, initial_state=i0)
        out = jnp.sum(y.astype(jnp.float32) * t["dy"][0].astype(jnp.float32))
        if "dfinal" in t:
            out += jnp.sum(final.astype(jnp.float32) * t["dfinal"][0].astype(jnp.float32))
        return out

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4) if init is not None else (0, 1, 2, 3))(
        t["x"][0], t["log_a"][0], t["b"][0], t["c"][0], init)
    return list(grads) + ([None] if init is None else [])


def _plain_bwd(t, chunk):
    x, la, b, c = (t[k][1] for k in ("x", "log_a", "b", "c"))
    init = t["init"][1] if "init" in t else None
    q = min(chunk, x.shape[1])
    prev, _ = kssd.chunk_state_plain(x, la, b, q, init)
    return kssd.ssd_scan_bwd_plain(x, la, b, c, prev, t["dy"][1].to(x.dtype), q,
                                   t["dfinal"][1] if "dfinal" in t else None, init)


def _check(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g is not None, name
        np.testing.assert_allclose(np32(g), np32(w), atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init,dfinal", [(False, False), (True, True), (True, False)])
def test_plain_backward_matches_jax_grad_of_the_recurrence(s, h, p, g, n, chunk,
                                                          dtype, init, dfinal):
    t = _inputs(s, h, p, g, n, dtype, init, dfinal)
    want = _jax_grads(lambda x, la, b, c, initial_state: jref.ssd_scan_ref(
        x, la, b, c, initial_state=initial_state), t, ())
    got = _plain_bwd(t, chunk)
    for gr, (name, inp) in zip(got, (("x", t["x"][1]), ("log_a", t["log_a"][1]),
                                     ("b", t["b"][1]), ("c", t["c"][1]))):
        assert gr.dtype == inp.dtype and gr.shape == inp.shape, name
    _check(got, want, TOLS[dtype])


@pytest.mark.parametrize("s,h,p,g,n,chunk", SHAPES[:2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init,dfinal", [(False, False), (True, True)])
def test_plain_backward_matches_jax_grad_of_ssd_chunked(s, h, p, g, n, chunk, dtype,
                                                        init, dfinal):
    t = _inputs(s, h, p, g, n, dtype, init, dfinal, seed=1)
    want = _jax_grads(lambda x, la, b, c, q, initial_state: jssm.ssd_chunked(
        x, la, b, c, q, initial_state=initial_state), t, (chunk,))
    _check(_plain_bwd(t, chunk), want, TOLS[dtype])


@pytest.mark.parametrize("s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_torch_autograd(s, h, p, g, n, chunk, dtype):
    t = _inputs(s, h, p, g, n, dtype, init=True, dfinal=True, seed=2)
    ins = [t[k][1].clone().requires_grad_() for k in ("x", "log_a", "b", "c", "init")]
    y, final = kssd.ssd_scan_plain(*ins[:4], chunk=chunk, initial_state=ins[4])
    want = torch.autograd.grad((y, final), ins, (t["dy"][1].to(y.dtype),
                                                 t["dfinal"][1].to(final.dtype)))
    _check(_plain_bwd(t, chunk), want, TOLS[dtype])


@pytest.mark.parametrize("init", [False, True])
def test_gradient_through_ssd_scan_reaches_the_function(monkeypatch, init):
    """On a "card" tensor under grad, ``ssd_scan`` goes through ``SSDScan``
    (its forward and both backward launches, here the plain versions), and
    the gradients are autograd's of the plain scan."""
    calls = patch_plain_launches(monkeypatch)
    entered = []
    forward = kssd.SSDScan.forward

    def spy(*args):
        entered.append(args[5])
        return forward(*args)

    monkeypatch.setattr(kssd.SSDScan, "forward", staticmethod(spy))
    t = _inputs(64, 4, 16, 2, 16, "float32", init, True, seed=3)
    keys = ("x", "log_a", "b", "c") + (("init",) if init else ())
    ins = [t[k][1].clone().requires_grad_() for k in keys]
    y, final = kssd.ssd_scan(*ins[:4], chunk=16, initial_state=ins[4] if init else None)
    got = torch.autograd.grad((y, final), ins, (t["dy"][1], t["dfinal"][1]))
    assert entered == [16]
    assert {k: calls[k] for k in ("state", "scan", "state_bwd", "scan_bwd")} == \
        {"state": 1, "scan": 1, "state_bwd": 1, "scan_bwd": 1}
    mine = [t[k][1].clone().requires_grad_() for k in keys]
    wy, wf = kssd.ssd_scan_plain(*mine[:4], chunk=16,
                                 initial_state=mine[4] if init else None)
    want = torch.autograd.grad((wy, wf), mine, (t["dy"][1], t["dfinal"][1]))
    for name, a, w in zip(NAMES, got, want):
        assert_close(a, w, TOLS["float32"])
    # without grad the same call never enters it
    with torch.no_grad():
        kssd.ssd_scan(*ins[:4], chunk=16)
    assert len(entered) == 1


def test_kernel_wrappers_take_the_plain_backward_on_the_cpu():
    """``chunk_state_bwd`` and ``chunk_scan_bwd`` on CPU tensors are their
    plain versions (the card's launches are checked by the card's tests)."""
    t = _inputs(32, 2, 16, 1, 16, "float32", True, True, seed=4)
    x, la, b, c, dy = (t[k][1] for k in ("x", "log_a", "b", "c", "dy"))
    prev, _ = kssd.chunk_state_plain(x, la, b, 16, t["init"][1])
    got = kssd.chunk_state_bwd(dy, la, c, prev, chunk=16, dfinal=t["dfinal"][1])
    want = kssd.chunk_state_bwd_plain(dy, la, c, prev, 16, t["dfinal"][1])
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    got = kssd.chunk_scan_bwd(x, la, b, c, prev, dy, *want[0:3:2], chunk=16)
    want = kssd.chunk_scan_bwd_plain(x, la, b, c, prev, dy, want[0], want[2], 16)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("h,g", [(6, 2), (26, 1), (48, 1), (50, 1), (4, 4)])
def test_heads_a_backward_block_walks(h, g):
    """``ssd_chunk_scan_bwd``'s blocks walk the largest divisor of a group's
    heads up to MAX_BWD_HEADS (the slices of dB and dC a group gets is the
    quotient), whatever the batch."""
    rep = kssd.bwd_heads_per_block(h, g)
    assert (h // g) % rep == 0 and 1 <= rep <= kssd.MAX_BWD_HEADS
    assert not any((h // g) % d == 0 for d in range(rep + 1, kssd.MAX_BWD_HEADS + 1))
    assert {(6, 2): 3, (26, 1): 2, (48, 1): 12, (50, 1): 10, (4, 4): 1}[(h, g)] == rep


def test_backward_glue_adds_the_slices_of_each_group():
    """``_bwd_finish`` adds dB's and dC's slices (B, S, G, k, N) of a group
    in order and casts each gradient to its input's dtype."""
    rng = np.random.default_rng(5)
    db = torch.from_numpy(rng.standard_normal((2, 8, 2, 3, 4)).astype(np.float32))
    dc = torch.from_numpy(rng.standard_normal((2, 8, 2, 3, 4)).astype(np.float32))
    dx, dla = torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16), torch.zeros(2, 8, 4)
    b_mat = torch.zeros(2, 8, 2, 4, dtype=torch.bfloat16)
    out = kssd._bwd_finish(dx, dla, db, dc, torch.zeros(2, 4, 4, 4), dla, b_mat,
                           b_mat, torch.bfloat16)
    assert out[0] is dx and out[1].dtype == torch.float32
    assert torch.equal(out[2], (db[:, :, :, 0] + db[:, :, :, 1] + db[:, :, :, 2]).to(
        torch.bfloat16))
    assert torch.equal(out[3], (dc[:, :, :, 0] + dc[:, :, :, 1] + dc[:, :, :, 2]).to(
        torch.bfloat16))
    assert out[4].dtype == torch.bfloat16
