"""The port's MoE layer and grouped matmul on the CPU against the JAX package.

The grouped matmul: the port's wrapper takes its plain version on a CPU
tensor; the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does, and its oracle ``ref.grouped_matmul_ref``.
The MoE dispatches (``moe_ragged``, ``moe_einsum``) and ``moe_block`` get
the same numpy inputs and weights on both sides.  The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances are the reference's kernel tolerances: 2e-5 in fp32 (summation
order only), 2e-2 in bf16 (outputs of |y| < 1 rounded to bf16, step
2**-8 to 2**-9 there).  The aux losses come from the fp32 router alone:
1e-6.  A bf16 case first checks that both sides routed alike, and shows
the top-k margin if they did not, instead of widening a tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.moe_gmm import grouped_matmul as pallas_gmm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.kernels import moe_gmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import compute_copy, init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from torch_parity import JNP, TORCH, assert_close, both, np32, randn  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6


def _sizes(seed: int, t: int, e: int) -> np.ndarray:
    """Random group sizes summing to t (some may be 0)."""
    cuts = np.sort(np.random.RandomState(seed).randint(0, t, e - 1))
    return np.diff(np.concatenate([[0], cuts, [t]])).astype(np.int32)


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,e,f,br,bc,sizes", [
    (64, 32, 4, 64, 16, 16, None),
    (128, 64, 8, 128, 32, 64, None),
    (96, 64, 5, 96, 16, 32, None),
    (32, 16, 4, 32, 8, 16, [0, 32, 0, 0]),        # empty groups
    (40, 16, 6, 16, 8, 16, [0, 0, 13, 0, 27, 0]),   # empty first and last
    (64, 32, 4, 32, 16, 16, [16, 16, 16, 16]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gmm_matches_pallas(t, d, e, f, br, bc, sizes, dtype):
    gs = np.asarray(sizes, np.int32) if sizes is not None else _sizes(0, t, e)
    xj, xt = both(randn(1, t, d), dtype)
    wj, wt = both(randn(2, e, d, f, scale=0.1), dtype)
    want = pallas_gmm(xj, wj, jnp.asarray(gs), block_rows=br, block_cols=bc,
                      interpret=True)
    got = moe_gmm.grouped_matmul(xt, wt, torch.from_numpy(gs))
    assert got.dtype == TORCH[dtype] and got.shape == (t, f)
    assert_close(got, want, TOLS[dtype])
    assert_close(got, ref.grouped_matmul_ref(xj, wj, jnp.asarray(gs)), TOLS[dtype])
    assert_close(tref.grouped_matmul_ref(xt, wt, torch.from_numpy(gs)),
                 ref.grouped_matmul_ref(xj, wj, jnp.asarray(gs)), TOLS[dtype])


def test_plain_gmm_matches_a_row_loop_and_counts_no_launch():
    gs = _sizes(3, 48, 6)
    x = torch.from_numpy(randn(4, 48, 16))
    w = torch.from_numpy(randn(5, 6, 16, 24))
    before = moe_gmm.launches
    got = moe_gmm.grouped_matmul(x, w, torch.from_numpy(gs))
    assert moe_gmm.launches == before
    # each row with its own expert's weight, by hand
    e_of = np.repeat(np.arange(6), gs)
    want = np.einsum("td,tdf->tf", x.numpy(), w.numpy()[e_of])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# MoE dispatches and block
# ---------------------------------------------------------------------------

def _moe_params(seed: int, d: int, e: int, f: int, shared: int = 0,
                pinned: bool = False) -> dict:
    """Numpy weights at the reference tests' scale (0.1).  ``pinned`` sends
    every token to expert 0 (x has a positive mean there), the other
    experts' logits kept distinct, so no top-k choice is a tie."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)) * 0.1,
         "wi_gate": rng.normal(size=(e, d, f)) * 0.1,
         "wi_up": rng.normal(size=(e, d, f)) * 0.1,
         "wo": rng.normal(size=(e, f, d)) * 0.1}
    if pinned:
        p["router"] = rng.normal(size=(d, e)) * 0.01
        p["router"][:, 0] = 10.0
    if shared:
        p["shared"] = {"wi_gate": rng.normal(size=(d, shared)) * 0.1,
                       "wi_up": rng.normal(size=(d, shared)) * 0.1,
                       "wo": rng.normal(size=(shared, d)) * 0.1,
                       "gate": rng.normal(size=(d, 1)) * 0.1}
    return p


def _both_params(p: dict):
    """The fp32 weights on both sides (the reference casts at use)."""
    if isinstance(p, dict):
        pairs = {k: _both_params(v) for k, v in p.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return both(p.astype(np.float32))


def _x(seed: int, t: int, d: int, dtype: str, shift: float = 0.0):
    return both(randn(seed, t, d) + shift, dtype)


def _assert_same_routing(xt, p, top_k):
    """Both frameworks route the same (token, k) to the same expert: the
    router reads the same values in fp32, so only a near-tie could differ;
    the message shows the k-th against the (k+1)-th probability."""
    probs_t, _ = tmoe.router_probs(xt, torch.from_numpy(p["router"].astype(np.float32)))
    probs_j, _ = jmoe.router_probs(jnp.asarray(np32(xt)).astype(jnp.bfloat16),
                                   jnp.asarray(p["router"], jnp.float32))
    idx_t = torch.topk(probs_t, top_k).indices.sort(-1).values.numpy()
    idx_j = np.sort(np.asarray(jax.lax.top_k(probs_j, top_k)[1]), -1)
    top = torch.topk(probs_t, top_k + 1).values
    margin = (top[:, top_k - 1] - top[:, top_k]).min().item()
    assert (idx_t == idx_j).all(), f"routing differs; smallest top-k margin {margin}"


def _assert_aux(got: dict, want: dict):
    assert set(got) == set(want) == {"load_balance", "router_z", "dropped"}
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=AUX_TOL, rtol=AUX_TOL, err_msg=k)


@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ragged_matches_jax(dtype, renorm):
    t, d, e, f, k = 64, 32, 8, 16, 2
    p = _moe_params(0, d, e, f)
    pj, pt = _both_params(p)
    xj, xt = _x(1, t, d, dtype)
    if dtype == "bfloat16":
        _assert_same_routing(xt, p, k)
    kw = dict(n_experts=e, top_k=k, act="silu", router_renorm=renorm)
    want, waux = jmoe.moe_ragged(xj, pj, compute_dtype=JNP[dtype], **kw)
    got, gaux = tmoe.moe_ragged(xt, pt, compute_dtype=dtype, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (t, d)
    assert_close(got, want, TOLS[dtype])
    _assert_aux(gaux, waux)


@pytest.mark.parametrize("t,k,capacity_factor", [
    (64, 2, 1.25),     # nothing over capacity
    (256, 2, 0.5),     # capacity 32 against ~64 an expert (groups 1) or
                       # ~32 (groups 2): rows over capacity drop
])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_einsum_matches_jax(dtype, groups, t, k, capacity_factor):
    d, e, f = 32, 8, 16
    p = _moe_params(2, d, e, f)
    pj, pt = _both_params(p)
    xj, xt = _x(3, t, d, dtype)
    if dtype == "bfloat16":
        _assert_same_routing(xt, p, k)
    kw = dict(n_experts=e, top_k=k, capacity_factor=capacity_factor,
              act="silu", router_renorm=False, groups=groups)
    want, waux = jmoe.moe_einsum(xj, pj, compute_dtype=JNP[dtype], **kw)
    got, gaux = tmoe.moe_einsum(xt, pt, compute_dtype=dtype, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (t, d)
    assert_close(got, want, TOLS[dtype])
    _assert_aux(gaux, waux)
    if capacity_factor < 1:
        assert float(gaux["dropped"]) > 0.05


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_einsum_drops_when_the_router_is_pinned(dtype, k):
    """Every token's first choice is expert 0 (as tests/test_moe_dispatch.py
    pins the router): its queue overflows a capacity of 64 of 512 tokens."""
    t, d, e, f = 512, 32, 8, 16
    p = _moe_params(4, d, e, f, pinned=True)
    pj, pt = _both_params(p)
    xj, xt = _x(5, t, d, dtype, shift=1.0)
    kw = dict(n_experts=e, top_k=k, capacity_factor=1.0, act="silu",
              router_renorm=False, groups=1)
    want, waux = jmoe.moe_einsum(xj, pj, compute_dtype=JNP[dtype], **kw)
    got, gaux = tmoe.moe_einsum(xt, pt, compute_dtype=dtype, **kw)
    assert_close(got, want, TOLS[dtype])
    _assert_aux(gaux, waux)
    capacity = ((max(k, int(t * k * 1.0 / e)) + 31) // 32) * 32
    # expert 0 keeps its first `capacity` tokens; with k = 2 the second
    # choices spread over the other experts, and fewer of them drop
    assert float(gaux["dropped"]) >= (t - capacity) / t / k - 1e-6
    assert torch.count_nonzero(got.float().abs().sum(-1)).item() < t


@pytest.mark.parametrize("dispatch", ["ragged", "einsum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_with_shared_expert_matches_jax(dtype, dispatch):
    """qwen2-moe's layout: routed experts plus one shared expert gated per
    token by an fp32 sigmoid."""
    b, s, d, e, f, k = 2, 24, 32, 8, 16, 2
    p = _moe_params(6, d, e, f, shared=48)
    pj, pt = _both_params(p)
    xj, xt = both(randn(7, b, s, d), dtype)
    if dtype == "bfloat16":
        _assert_same_routing(xt.reshape(b * s, d), p, k)
    kw = dict(n_experts=e, n_shared=1, top_k=k, capacity_factor=1.25,
              act="silu", router_renorm=False, dispatch=dispatch, groups=1)
    want, waux = jmoe.moe_block(xj, pj, compute_dtype=JNP[dtype], **kw)
    got, gaux = tmoe.moe_block(xt, pt, compute_dtype=dtype, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (b, s, d)
    assert_close(got, want, TOLS[dtype])
    _assert_aux(gaux, waux)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_compute_copy_keeps_router_and_token_gate_in_param_dtype(arch):
    """The reference reads the router and the shared expert's gate in fp32
    (``router_probs``, the sigmoid gate): the serving copy casts the expert
    weights to bf16 and leaves those two alone."""
    cfg = get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    seg = compute_copy(cfg, init_params(cfg, gen))["segments"][0]
    moe = seg["moe"]
    assert moe["router"].dtype == torch.float32
    for name in ("wi_gate", "wi_up", "wo"):
        assert moe[name].dtype == torch.bfloat16
    assert seg["norm2"].dtype == torch.float32 and "mlp" not in seg
    if cfg.n_shared_experts:
        assert moe["shared"]["gate"].dtype == torch.float32
        for name in ("wi_gate", "wi_up", "wo"):
            assert moe["shared"][name].dtype == torch.bfloat16
    else:
        assert "shared" not in moe


@pytest.mark.parametrize("dispatch", ["ragged", "einsum"])
def test_moe_block_reads_nothing_back_from_the_device(monkeypatch, dispatch):
    """On meta tensors, which hold no values, any read on the host (.item(),
    .tolist(), bincount, boolean-mask indexing) raises: the layer must not
    make one, so that a decode step on the card never waits for it.  The
    grouped GEMM is stubbed (its plain version reads the group sizes)."""
    monkeypatch.setattr(moe_gmm, "grouped_matmul", lambda x, w, gs: torch.empty(
        (x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device))
    d, e, f = 32, 8, 16
    pt = {k: v.to("meta") for k, v in _both_params(
        _moe_params(0, d, e, f))[1].items()}
    x = torch.empty(4, 1, d, dtype=torch.bfloat16, device="meta")
    out, aux = tmoe.moe_block(
        x, pt, n_experts=e, n_shared=0, top_k=2, capacity_factor=1.25,
        act="silu", router_renorm=False, dispatch=dispatch, groups=1)
    assert out.shape == x.shape and out.device.type == "meta"
    assert set(aux) == {"load_balance", "router_z", "dropped"}
