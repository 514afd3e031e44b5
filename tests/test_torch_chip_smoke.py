"""The card script's arithmetic on the CPU: its bound, its error gates and
its profile summary (the script itself runs only on a card)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under 6 xdist workers

from torch.profiler import ProfilerActivity, profile  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (7, True, 0), (7, False, 0), (9, True, 3), (9, False, 3),
    (5, True, 8)])
def test_mask_pairs_counts_the_allowed_pairs(s, causal, window):
    i, j = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    allowed = (i >= j) if causal else np.ones((s, s), bool)
    if window > 0:
        allowed &= i - j < window
    assert cs.mask_pairs(s, causal, window) == int(allowed.sum())


def test_gemma3_prefill_bound():
    """B 4, S 2048, Hq 4, Hkv 1, D 256: each layer is bound by operations."""
    ops, nbytes = cs.attention_floor_ms(4, 2048, 4, 1, 256, True, 0)
    assert ops == pytest.approx(4 * 4 * 4 * 256 * 2048 * 2049 / 2 / 989e12 * 1e3)
    assert nbytes == pytest.approx(2 * (2 * 4 * 2048 * 4 * 256 + 2 * 4 * 2048 * 256)
                                   / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes) == (ops, "operations")
    assert cs.bound(1.0, 2.0) == (2.0, "bytes")


def test_row_relative_error_sees_a_small_row():
    """An error too small for the absolute gate fails the row-relative one
    when it sits in a row of small values."""
    want = torch.ones(1, 4, 2, 8)
    want[0, 3] = 0.05
    out = want.clone()
    assert cs.row_rel_err(out, want) == 0.0
    out[0, 3, 1, 5] += 0.005
    assert (out - want).abs().max().item() <= cs.KERNEL_TOL
    assert cs.row_rel_err(out, want) == pytest.approx(0.1, rel=1e-5)
    assert cs.row_rel_err(out, want) > cs.ROW_REL_TOL


def test_logits_agreement():
    want = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 50))).float()
    same = cs.logits_agreement(want.clone(), want)
    assert same["max_abs"] == 0.0 and same["argmax_agree"] == 6
    with pytest.raises(AssertionError, match="logits disagree"):
        cs.logits_agreement(want + 0.5 * want.std(), want)


def test_busy_time_is_the_union_of_intervals():
    assert cs.busy_us([]) == 0.0
    assert cs.busy_us([(20, 30), (0, 10), (5, 15), (21, 22)]) == 25.0
    assert cs.busy_us([(0, 10), (10, 12)]) == 12.0


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_attention_fwd_kernel<256>(...)",
     "flash_attention"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<8, GeluCUDAKernelImpl>",
     "elementwise"),
])
def test_kernel_class(name, cls):
    assert cs.kernel_class(name) == cls


def test_summary_of_a_window_without_device_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    out = cs.summarize(prof, wall_s=0.01, steps=2)
    assert out["steps"] == 2 and out["wall_ms"] == pytest.approx(10.0)
    assert out["device_events"] == 0 and out["device_busy_ms"] == 0.0
    assert out["idle_share"] is None          # no device trace: no share
    assert out["kernel_launches"] == 0
