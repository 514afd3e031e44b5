"""The port's SSD scan and Mamba2 block on the CPU against the JAX package.

The port's ``ssd_scan`` on a CPU tensor takes its plain version; the JAX
side runs the Pallas kernels in interpret mode, as ``tests/test_kernels.py``
does.  ``ssd_chunked``, ``ssd_step``, ``_causal_conv`` and ``mamba2_block``
are held against their JAX functions on the same numpy inputs and bridged
weights.  Tolerances are the reference's SSD ones: 1e-4 in fp32, 5e-2 in
bf16, on y and on the final state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_kernel  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from torch_parity import assert_close, both, randn  # noqa: E402

TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's kernel-test shapes (tests/test_kernels.py), a sequence
# shorter than the chunk (one chunk of Q = S), and one of two chunks
SHAPES = [  # s, h, p, g, n, chunk
    (64, 2, 16, 1, 16, 16),
    (128, 4, 32, 2, 16, 32),
    (128, 4, 32, 4, 8, 64),
    (40, 2, 16, 1, 16, 64),
    (32, 4, 16, 2, 16, 16),
]


def _ssd_inputs(s, h, p, g, n, dtype, bsz=2, seed=0):
    """(jax, torch) pairs for x, log_a (always fp32), b, c."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32) * 0.5
    log_a = -np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32) * 0.3
    b = rng.standard_normal((bsz, s, g, n)).astype(np.float32) * 0.3
    c = rng.standard_normal((bsz, s, g, n)).astype(np.float32) * 0.3
    return both(x, dtype), both(log_a), both(b, dtype), both(c, dtype)


@pytest.mark.parametrize("s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas(s, h, p, g, n, chunk, dtype):
    (xj, xt), (laj, lat), (bj, bt), (cj, ct) = _ssd_inputs(s, h, p, g, n, dtype)
    want_y, want_h = jssd_kernel(xj, laj, bj, cj, chunk=chunk, interpret=True)
    got_y, got_h = kssd.ssd_scan(xt, lat, bt, ct, chunk=chunk)
    assert got_y.dtype == xt.dtype and got_h.dtype == xt.dtype
    assert got_y.shape == xt.shape and got_h.shape == (2, h, p, n)
    assert_close(got_y, want_y, TOLS[dtype])
    assert_close(got_h, want_h, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_initial_state(dtype):
    (xj, xt), (laj, lat), (bj, bt), (cj, ct) = _ssd_inputs(64, 2, 16, 1, 16, dtype,
                                                           bsz=1)
    h0j, h0t = both(randn(9, 1, 2, 16, 16, scale=0.2))
    want_y, want_h = jssd_kernel(xj, laj, bj, cj, chunk=16, initial_state=h0j,
                                 interpret=True)
    got_y, got_h = kssd.ssd_scan(xt, lat, bt, ct, chunk=16, initial_state=h0t)
    assert_close(got_y, want_y, TOLS[dtype])
    assert_close(got_h, want_h, TOLS[dtype])


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_ref_matches_jax_ref(with_init):
    (xj, xt), (laj, lat), (bj, bt), (cj, ct) = _ssd_inputs(48, 4, 16, 2, 8, "float32")
    h0j, h0t = both(randn(4, 2, 4, 16, 8, scale=0.2)) if with_init else (None, None)
    want = jref.ssd_scan_ref(xj, laj, bj, cj, initial_state=h0j)
    got = tref.ssd_scan_ref(xt, lat, bt, ct, initial_state=h0t)
    for g_, w_ in zip(got, want):
        assert_close(g_, w_, 1e-5)
    # and the plain version of the kernels agrees with the exact recurrence
    plain = kssd.ssd_scan_plain(xt, lat, bt, ct, chunk=16, initial_state=h0t)
    for g_, w_ in zip(plain, got):
        assert_close(g_, w_, 1e-4)


@pytest.mark.parametrize("s,h,p,g,n,chunk", SHAPES[:2] + SHAPES[3:])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(s, h, p, g, n, chunk, dtype, with_init):
    (xj, xt), (laj, lat), (bj, bt), (cj, ct) = _ssd_inputs(s, h, p, g, n, dtype)
    h0j, h0t = (both(randn(3, 2, h, p, n, scale=0.2)) if with_init
                else (None, None))
    want = jssm.ssd_chunked(xj, laj, bj, cj, chunk, initial_state=h0j)
    got = ssm.ssd_chunked(xt, lat, bt, ct, chunk, initial_state=h0t)
    for g_, w_ in zip(got, want):
        assert g_.dtype == xt.dtype
        assert_close(g_, w_, TOLS[dtype])


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_step_matches_jax(g, dtype):
    stj, stt = both(randn(1, 2, 4, 16, 8, scale=0.3))
    xj, xt = both(randn(2, 2, 4, 16, scale=0.5), dtype)
    laj, lat = both(-np.abs(randn(3, 2, 4)) * 0.3)
    bj, bt = both(randn(4, 2, g, 8, scale=0.3), dtype)
    cj, ct = both(randn(5, 2, g, 8, scale=0.3), dtype)
    want = jssm.ssd_step(stj, xj, laj, bj, cj)
    got = ssm.ssd_step(stt, xt, lat, bt, ct)
    assert got[0].dtype == torch.float32 and got[1].dtype == xt.dtype
    for g_, w_ in zip(got, want):
        assert_close(g_, w_, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_full_and_streaming(dtype):
    xj, xt = both(randn(6, 2, 10, 24), dtype)
    wj, wt = both(randn(7, 4, 24, scale=0.2))
    bj, bt = both(randn(8, 24, scale=0.1))
    want, _ = jssm._causal_conv(xj, wj, bj)
    got, none = ssm._causal_conv(xt, wt, bt)
    assert none is None and got.dtype == xt.dtype
    assert_close(got, want, TOLS[dtype])
    # streaming: state (B, K-1, C) in bf16 against an x of ``dtype``
    sj, st = both(randn(9, 2, 3, 24), "bfloat16")
    want_y, want_s = jssm._causal_conv(xj[:, :1], wj, bj, sj)
    got_y, got_s = ssm._causal_conv(xt[:, :1], wt, bt, st)
    assert got_s.dtype == torch.promote_types(torch.bfloat16, xt.dtype)
    assert got_s.dtype == TORCH[str(want_s.dtype)]
    assert_close(got_y, want_y, TOLS[dtype])
    assert_close(got_s, want_s, 0)
    # streaming over the sequence reproduces the full convolution
    state = torch.zeros(2, 3, 24, dtype=xt.dtype)
    steps = []
    for t in range(xt.shape[1]):
        y, state = ssm._causal_conv(xt[:, t:t + 1], wt, bt, state)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, dim=1), got, atol=0, rtol=0)


def _block_pair(dtype):
    """JAX and port layer-0 mixer weights of the mamba2 smoke config, and
    its shape keywords."""
    cfg = jget_smoke("mamba2-780m")
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0]["ssm"])
    tlayer = bridge.params_from_numpy(jax.device_get(jlayer), "cpu")
    kw = dict(d_inner=cfg.d_inner, state_dim=cfg.ssm_state,
              head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
              conv_width=cfg.ssm_conv, chunk=cfg.ssm_chunk)
    return cfg, jlayer, tlayer, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_mamba2_block_prefill_matches_jax(dtype, use_kernels):
    cfg, jlayer, tlayer, kw = _block_pair(dtype)
    xj, xt = both(randn(11, 2, 32, cfg.d_model), dtype)   # two chunks of 16
    want, _ = jssm.mamba2_block(xj, jlayer, compute_dtype=JNP[dtype],
                                use_kernels=use_kernels, **kw)
    before = (kssd.state_launches, kssd.scan_launches)
    with torch.inference_mode():
        got, none = ssm.mamba2_block(xt, tlayer, compute_dtype=dtype,
                                     use_kernels=use_kernels, **kw)
    assert none is None and got.shape == (2, 32, cfg.d_model)
    assert (kssd.state_launches, kssd.scan_launches) == before   # CPU: no launch
    assert_close(got, want, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_decode_step_matches_jax(dtype):
    cfg, jlayer, tlayer, kw = _block_pair(dtype)
    cj = jssm.init_ssm_cache(2, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
                             cfg.ssm_groups, cfg.ssm_conv, JNP[dtype])
    ct = ssm.init_ssm_cache(2, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
                            cfg.ssm_groups, cfg.ssm_conv, dtype, "cpu")
    assert ct["ssm"].dtype == torch.float32 and ct["conv"].dtype == TORCH[dtype]
    xs = randn(12, 2, 3, cfg.d_model)
    for t in range(3):
        xj, xt = both(xs[:, t:t + 1], dtype)
        want, cj = jssm.mamba2_block(xj, jlayer, compute_dtype=JNP[dtype],
                                     cache=cj, **kw)
        with torch.inference_mode():
            got, ct = ssm.mamba2_block(xt, tlayer, compute_dtype=dtype,
                                       cache=ct, **kw)
        assert_close(got, want, TOLS[dtype])
        assert_close(ct["conv"], cj["conv"], TOLS[dtype])
        assert_close(ct["ssm"], cj["ssm"], TOLS[dtype])
        assert ct["pos"] == int(cj["pos"]) == t + 1


def test_wrapper_raises_where_the_reference_asserts():
    (_, xt), (_, lat), (_, bt), (_, ct) = _ssd_inputs(40, 2, 16, 1, 16, "float32")
    with pytest.raises(ValueError, match="not divisible by chunk"):
        kssd.ssd_scan(xt, lat, bt, ct, chunk=16)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm.ssd_chunked(xt, lat, bt, ct, 16)
    with pytest.raises(AssertionError):   # the reference's own assert
        xj, laj, bj, cj = (jnp.asarray(t.numpy()) for t in (xt, lat, bt, ct))
        jssd_kernel(xj, laj, bj, cj, chunk=16, interpret=True)


def test_device_tensor_never_reaches_the_plain_version(monkeypatch):
    """A non-CPU tensor goes to the kernels' checks, never to the plain
    version (a meta tensor stands in for a card's here)."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(kssd, "ssd_scan_plain", boom)
    x = torch.empty(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
    la = torch.empty(1, 64, 2, device="meta")
    b = torch.empty(1, 64, 1, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device"):
        kssd.ssd_scan(x, la, b, b)

