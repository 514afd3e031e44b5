"""The port's layers against ``repro.models.layers`` on the same inputs.

Tolerances: 1e-5 in fp32 (only summation order differs); in bf16 one
unit in the last place of values near 1 (2**-7 ≈ 7.8e-3, so 1e-2),
because the two frameworks may round an intermediate at other places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jl  # noqa: E402

from repro_torch.models import layers as tl  # noqa: E402
from torch_parity import assert_close, both, randn  # noqa: E402

TOLS = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    xj, xt = both(randn(0, 2, 5, 48), dtype)
    sj, st = both(randn(1, 48, scale=0.1))
    assert_close(tl.rms_norm(xt, st, 1e-6), jl.rms_norm(xj, sj, 1e-6),
                 TOLS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    xj, xt = both(randn(0, 2, 5, 48) + 0.5, dtype)
    sj, st = both(randn(1, 48, scale=0.1) + 1.0)
    bj, bt = both(randn(2, 48, scale=0.1))
    assert_close(tl.layer_norm(xt, st, bt), jl.layer_norm(xj, sj, bj),
                 TOLS[dtype])


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(theta, dtype):
    xj, xt = both(randn(0, 2, 40, 3, 80), dtype)
    pos = np.broadcast_to(np.arange(40)[None] * 7, (2, 40))
    pj, pt = both(pos)
    assert_close(tl.apply_rope(xt, pt, theta), jl.apply_rope(xj, pj, theta),
                 TOLS[dtype])


@pytest.mark.parametrize("act", ["gelu", "silu", "gelu_nogate"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(act, dtype):
    d, ff = 32, 64
    names = (("wi", (d, ff)), ("bi", (ff,)), ("wo", (ff, d)), ("bo", (d,))) \
        if act == "gelu_nogate" else \
        (("wi_gate", (d, ff)), ("wi_up", (d, ff)), ("wo", (ff, d)))
    pj, pt = {}, {}
    for seed, (name, shape) in enumerate(names):
        pj[name], pt[name] = both(randn(10 + seed, *shape, scale=0.2))
    xj, xt = both(randn(0, 2, 6, d), dtype)
    # bf16: XLA may keep the activation's intermediates in fp32 where torch
    # rounds its output once; a one-ulp difference in the hidden layer,
    # summed over d_ff = 64 terms of the output matmul, stays below 4e-2
    tol = {"float32": 1e-5, "bfloat16": 4e-2}[dtype]
    assert_close(tl.mlp(xt, pt, act, dtype), jl.mlp(xj, pj, act, dtype), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [True, False])
def test_embed_and_unembed(dtype, scale):
    tj, tt = both(randn(0, 64, 1152, scale=0.02))
    ij, it = both(np.random.default_rng(1).integers(0, 64, (2, 7)))
    got = tl.embed_tokens(it, tt, scale, dtype)
    want = jl.embed_tokens(ij, tj, scale, dtype)
    # bit for bit: sqrt(1152) is rounded to the compute dtype (34.0 in bf16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype("float32")))
    assert_close(tl.unembed(got, tt.T, dtype), jl.unembed(want, tj.T, dtype),
                 TOLS[dtype] * 2)


def test_embed_scale_is_rounded_to_bf16():
    x = torch.ones(1, 1, 1152)
    out = tl.embed_tokens(torch.zeros(1, 1, dtype=torch.long), x[0], True,
                          "bfloat16")
    assert float(out[0, 0, 0]) == 34.0
