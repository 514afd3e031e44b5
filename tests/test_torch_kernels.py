"""The port's flash attention on the CPU against the JAX Pallas kernel.

On a CPU tensor the port's wrapper takes the kernel's plain version
(dense masked softmax in fp32); the JAX side runs the Pallas kernel in
interpret mode through ``repro.kernels.ops``, as ``tests/test_kernels.py``
does.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances are the reference's own: 2e-5 in fp32, 2e-2 in bf16.  Also
how the kernels' sources are keyed and bound, which needs no compiler.
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
    lib = types.SimpleNamespace(flash_attention_fwd=types.SimpleNamespace())
    assert fa.bind(lib) is lib
    assert lib.flash_attention_fwd.argtypes == (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    assert lib.flash_attention_fwd.restype is ctypes.c_int
