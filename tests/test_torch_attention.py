"""The port's attention against ``repro.models.attention`` on the same inputs.

Tolerances: 2e-5 in fp32 (attention, as the reference's kernel tests);
in bf16 2e-2, one bf16 step at the outputs' size, since probs and
outputs are rounded to bf16 after sums taken in another order.
``attn_block`` adds two projections in bf16: 4e-2 there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as ja  # noqa: E402

from repro_torch.models import attention as ta  # noqa: E402
from torch_parity import assert_close, both, randn  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _qkv(s, hq, hkv, d, dtype, b=2, sk=None):
    sk = sk or s
    return (both(randn(1, b, s, hq, d), dtype),
            both(randn(2, b, sk, hkv, d), dtype),
            both(randn(3, b, sk, hkv, d), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_chunk", [(True, 0), (True, 8), (False, 0)])
def test_full_attention(dtype, causal, q_chunk):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(32, 4, 2, 16, dtype)
    assert_close(ta.full_attention(qt, kt, vt, causal, 0.0, q_chunk),
                 ja.full_attention(qj, kj, vj, causal, 0.0, q_chunk),
                 TOLS[dtype])


def test_full_attention_softcap():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(16, 2, 1, 16, "float32")
    assert_close(ta.full_attention(qt, kt, vt, True, 5.0),
                 ja.full_attention(qj, kj, vj, True, 5.0), TOLS["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,window,q_chunk", [
    (32, 16, 0), (40, 16, 0), (32, 16, 1), (8, 16, 0)])
def test_local_attention(dtype, s, window, q_chunk):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(s, 4, 1, 16, dtype)
    assert_close(ta.local_attention(qt, kt, vt, window, True, q_chunk),
                 ja.local_attention(qj, kj, vj, window, True, q_chunk),
                 TOLS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [24, 8192])     # one block; two 4096 blocks
def test_decode_attention(dtype, t):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 4, 2, 16, dtype, sk=t)
    lj, lt = both(np.array([t // 3, t]))
    assert_close(ta.decode_attention(qt, kt, vt, lt),
                 ja.decode_attention(qj, kj, vj, lj), TOLS[dtype])


def _block_params(d, hq, hkv, hd, qk_norm):
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    if qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    pj, pt = {}, {}
    for seed, (name, shape) in enumerate(shapes.items()):
        pj[name], pt[name] = both(randn(20 + seed, *shape, scale=0.15))
    return pj, pt


# gemma3 smoke shapes: window 16, so seq 8 takes the full-causal branch and
# seq 32 the local_attention branch; kinds attn and enc, use_kernels both ways
@pytest.mark.parametrize("kind,s", [("swa", 8), ("swa", 32), ("attn", 32),
                                    ("enc", 32)])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_block(kind, s, use_kernels, dtype):
    d, hq, hkv, hd = 64, 2, 1, 32
    pj, pt = _block_params(d, hq, hkv, hd, qk_norm=True)
    xj, xt = both(randn(0, 2, s, d), dtype)
    pos = np.broadcast_to(np.arange(s), (2, s))
    posj, post = both(pos)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, kind=kind, window=16,
              rope_theta=1e4, qk_norm=True, compute_dtype=dtype,
              use_kernels=use_kernels)
    got, _ = ta.attn_block(xt, pt, positions=post, **kw)
    want, _ = ja.attn_block(xj, pj, positions=posj, **kw)
    assert_close(got, want, {"float32": 2e-5, "bfloat16": 4e-2}[dtype])


@pytest.mark.parametrize("kind,steps", [("swa", 20), ("attn", 12)])
def test_attn_block_decode_writes_ring(kind, steps):
    """Decode over more steps than the swa ring holds (pos % t) and past a
    full cache (the write index clamps, as dynamic_update_slice does)."""
    import jax.numpy as jnp
    d, hq, hkv, hd, t = 64, 2, 1, 32, 8
    pj, pt = _block_params(d, hq, hkv, hd, qk_norm=False)
    cj = {"k": jnp.zeros((2, t, hkv, hd)), "v": jnp.zeros((2, t, hkv, hd)),
          "pos": jnp.zeros((), jnp.int32)}
    ct = {"k": torch.zeros(2, t, hkv, hd), "v": torch.zeros(2, t, hkv, hd),
          "pos": 0}
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, kind=kind, window=t,
              rope_theta=1e4, compute_dtype="float32")
    for step in range(steps):
        xj, xt = both(randn(100 + step, 2, 1, d))
        posj, post = both(np.full((2, 1), step))
        want, cj = ja.attn_block(xj, pj, positions=posj, cache=cj, **kw)
        got, ct = ta.attn_block(xt, pt, positions=post, cache=ct, **kw)
        assert_close(got, want, 2e-5)
        assert ct["pos"] == int(cj["pos"])
    assert_close(ct["k"], cj["k"], 2e-5)
