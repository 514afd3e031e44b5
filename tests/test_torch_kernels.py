"""The port's flash attention on the CPU against the JAX Pallas kernel.

On a CPU tensor the port's wrapper takes the kernel's plain version
(dense masked softmax in fp32); the JAX side runs the Pallas kernel in
interpret mode through ``repro.kernels.ops``, as ``tests/test_kernels.py``
does.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances are the reference's own: 2e-5 in fp32, 2e-2 in bf16.  The
backward's plain version (the Pallas kernel has no backward) is held
against autograd of the plain forward and JAX's autodiff of the
reference's plain attention.  Also how the kernels' sources are keyed and
bound, which needs no compiler.
"""
import ctypes
import shutil
import types

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops, ref  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_parity import assert_close, both, randn  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(s, hq, hkv, d, dtype, b=2):
    return [both(randn(seed, b, s, h, d), dtype)
            for seed, h in ((1, hq), (2, hkv), (3, hkv))]


@pytest.mark.parametrize("causal,window", [
    (True, 0), (True, 24), (False, 0),
], ids=["causal", "window", "bidirectional"])
@pytest.mark.parametrize("s,hq,hkv,d", [
    (64, 2, 2, 16),      # MHA
    (64, 4, 2, 32),      # GQA 2
    (64, 4, 1, 80),      # MQA (group 4), head dim 80
    (64, 5, 1, 64),      # group 5 (hymba-1.5b's), head dim 64
    (50, 4, 1, 32),      # ragged S: not a multiple of the block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(causal, window, s, hq, hkv, d, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(s, hq, hkv, d, dtype)
    want = ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                               block_q=32, block_k=32)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert_close(got, want, TOLS[dtype])
    assert_close(tref.flash_attention_ref(qt, kt, vt, causal=causal,
                                          window=window), want, TOLS[dtype])
    assert_close(tref.flash_attention_ref(qt, kt, vt, causal=causal,
                                          window=window),
                 ref.flash_attention_ref(qj, kj, vj, causal=causal,
                                         window=window), TOLS[dtype])


def test_cpu_tensor_never_counts_a_launch():
    (_, q), (_, k), (_, v) = _inputs(16, 2, 1, 32, "float32", b=1)
    before = fa.launches
    fa.flash_attention(q, k, v)
    assert fa.launches == before


def test_build_keys_a_source_directory_by_its_own_files(tmp_path):
    """Another tree's sources build beside these under a name of their own;
    the same files give the same library."""
    from repro_torch.kernels import _build
    same, other = tmp_path / "same", tmp_path / "other"
    shutil.copytree(_build.CSRC, same)
    other.mkdir()
    (other / "moe_gmm.cu").write_text("// another version of the kernel\n")
    assert _build.sources(other) == [other / "moe_gmm.cu"]
    mine = _build._target(_build.CSRC / "moe_gmm.cu")
    assert _build._target(same / "moe_gmm.cu") == mine
    theirs = _build._target(other / "moe_gmm.cu")
    assert theirs != mine and theirs.parent == _build.BUILD_DIR
    assert theirs.name.startswith("libmoe_gmm-")


def test_gmm_bind_declares_the_c_entry_point():
    from repro_torch.kernels import moe_gmm
    lib = types.SimpleNamespace(grouped_matmul=types.SimpleNamespace())
    assert moe_gmm.bind(lib) is lib
    assert lib.grouped_matmul.argtypes == (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    assert lib.grouped_matmul.restype is ctypes.c_int


def test_fa_bind_declares_the_c_entry_point():
    lib = types.SimpleNamespace(flash_attention_fwd=types.SimpleNamespace(),
                                flash_attention_bwd=types.SimpleNamespace())
    assert fa.bind(lib) is lib
    # q, k, v, o and the optional LSE
    assert lib.flash_attention_fwd.argtypes == (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    # q, k, v, o, lse, dout, dq, dk, dv, workspace
    assert lib.flash_attention_bwd.argtypes == (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    assert lib.flash_attention_fwd.restype is ctypes.c_int
    assert lib.flash_attention_bwd.restype is ctypes.c_int


@pytest.mark.parametrize("b,s,hq,hkv,d", [(4, 2048, 4, 1, 256), (2, 1000, 8, 2, 80),
                                         (2, 1, 2, 2, 16), (4, 2048, 16, 16, 128)])
def test_bwd_workspace_holds_the_kernels_scratch(b, s, hq, hkv, d):
    """The backward kernels' fp32 scratch (``bwd::carve`` in the source): the
    dQ accumulator of each 64-row query tile at D padded to 64, the rows'
    base-2 LSE and delta, under GQA the dK/dV partial sums of a split group
    (128 key rows a unit) and their counters, a counter a query tile and the
    ticket; at least the (B, Hq, S) fp32 delta that a build of the first
    backward takes there."""
    n_qt, d_pad = -(-s // 64), -(-d // 64) * 64
    rows = b * hq * n_qt * 64
    split_sums = 2 * b * hkv * -(-s // 128) * 128 * d_pad if hq > hkv else 0
    ints = b * hq * n_qt + (b * hkv * n_qt if hq > hkv else 0) + 1
    want = 4 * (rows * d_pad + 2 * rows + split_sums + ints)
    assert fa._bwd_workspace_bytes(b, s, hq, hkv, d) == want
    assert want >= 4 * b * hq * s


# -- the backward's plain version -------------------------------------------

BWD_CASES = [
    # s, hq, hkv, d, causal, window
    (40, 2, 2, 16, True, 0),      # MHA
    (40, 4, 1, 32, True, 0),      # MQA, gemma3's grouping
    (50, 6, 3, 16, True, 12),     # GQA 2, window, ragged S
    (37, 4, 2, 32, False, 0),     # bidirectional, ragged S
    (33, 4, 1, 16, False, 9),     # bidirectional window
]


def _grad_inputs(s, hq, hkv, d, seed=0):
    q, k, v = (torch.from_numpy(randn(seed + i, 2, s, h, d))
               for i, h in enumerate((hq, hkv, hkv)))
    do = torch.from_numpy(randn(seed + 9, 2, s, hq, d))
    return q, k, v, do


@pytest.mark.parametrize("s,hq,hkv,d,causal,window", BWD_CASES)
def test_plain_backward_matches_autograd(s, hq, hkv, d, causal, window):
    """FA2's formulas from the saved LSE and O against autograd of the plain
    forward, fp32: summation order only (1e-5)."""
    q, k, v, do = _grad_inputs(s, hq, hkv, d)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o, out.detach(), atol=0, rtol=0)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,hq,hkv,d,causal,window", BWD_CASES)
def test_plain_backward_matches_the_reference_autodiff(s, hq, hkv, d, causal, window):
    """The same gradients as JAX's autodiff of the reference's plain
    attention (``repro.kernels.ref``), fp32: 2e-5."""
    import jax
    q, k, v, do = _grad_inputs(s, hq, hkv, d, seed=3)
    _, vjp = jax.vjp(lambda *a: ref.flash_attention_ref(
        *a, causal=causal, window=window), q.numpy(), k.numpy(), v.numpy())
    want = vjp(do.numpy())
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    for a, b in zip(got, want):
        assert_close(a, b, 2e-5)


def test_lse_is_the_rows_logsumexp():
    q, k, _, _ = _grad_inputs(30, 4, 2, 16)
    lse = fa.flash_attention_lse_plain(q, k, causal=True, window=7)
    assert lse.shape == (2, 4, 30) and lse.dtype == torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 4.0
    i, j = torch.arange(30)[:, None], torch.arange(30)[None, :]
    allowed = (i >= j) & (i - j < 7)
    want = torch.logsumexp(scores.masked_fill(~allowed, float("-inf")), -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


def test_plain_backward_rows_that_saw_no_key():
    """A row whose LSE is -inf (the forward's mark for a row that saw no
    key) has P = 0: its dQ is 0 and it adds nothing to dK and dV, as if its
    output's gradient were 0."""
    q, k, v, do = _grad_inputs(24, 4, 2, 16)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True, window=8)
    lse[:, 1, 3:10] = float("-inf")
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=8)
    assert bool(torch.isfinite(torch.cat([g.flatten() for g in got])).all())
    assert bool((got[0][:, 3:10, 1] == 0).all())
    do_zero = do.clone()
    do_zero[:, 3:10, 1] = 0
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, window=8)
    want = torch.autograd.grad(out, leaves, do_zero)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_cpu_backward_never_counts_a_launch():
    q, k, v, do = _grad_inputs(16, 2, 1, 16)
    before = fa.bwd_launches, fa.launches
    o, lse = fa.flash_attention_with_lse(q, k, v)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert (fa.bwd_launches, fa.launches) == before
