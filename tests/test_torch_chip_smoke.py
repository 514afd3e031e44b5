"""The card script's arithmetic on the CPU: its bound, its error gates and
its profile summary (the script itself runs only on a card)."""
import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

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


def test_fa_cases_cover_every_head_dim():
    """The card script holds the kernel against its plain version at every
    head dim it is compiled for, and at h2o-danube-1.8b's shape past its
    window of 4096 (D 80, causal, 4608 positions)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert {case[5] for case in cs.FA_CASES} >= set(HEAD_DIMS)
    assert ("h2o-danube-1.8b past window", 1, 4608, 32, 8, 80, True, 4096) in cs.FA_CASES


def test_gemma3_prefill_bound():
    """B 4, S 2048, Hq 4, Hkv 1, D 256: each layer is bound by operations."""
    ops, nbytes = cs.attention_floor_ms(4, 2048, 4, 1, 256, True, 0)
    assert ops == pytest.approx(4 * 4 * 4 * 256 * 2048 * 2049 / 2 / 989e12 * 1e3)
    assert nbytes == pytest.approx(2 * (2 * 4 * 2048 * 4 * 256 + 2 * 4 * 2048 * 256)
                                   / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes) == (ops, "operations")
    assert cs.bound(1.0, 2.0) == (2.0, "bytes")


def test_mamba2_prefill_ssd_bound():
    """B 4, S 2048, H 48, P 64, G 1, N 128, Q 256: the whole scan must move
    ~110 MB (x and y 50.3 MB each, B, C and log_a 5.8 MB, the final state
    3.1 MB), ~33 us at 3.35 TB/s, and is bound by bytes."""
    b, s, h, p, g, n, q = 4, 2048, 48, 64, 1, 128, 256
    ops, nbytes = cs.ssd_floor_ms(b, s, h, p, g, n, q)
    x = 2 * b * s * h * p
    assert x == 50_331_648
    want_bytes = 2 * x + 4 * b * s * h + 2 * (2 * b * s * g * n) + 2 * b * h * p * n
    assert want_bytes == pytest.approx(109.6e6, rel=1e-3)
    assert nbytes == pytest.approx(want_bytes / 3.35e12 * 1e3)
    assert nbytes == pytest.approx(0.03271, rel=1e-3)
    pairs = (s // q) * q * (q + 1) // 2            # j <= i within each chunk
    flops = (2 * b * h * s * p * n                 # chunk states
             + 2 * b * g * pairs * n               # C.B^T, once per group
             + 2 * b * h * pairs * p               # (scores) X
             + 2 * b * h * s * n * p)              # inter-chunk C.prev^T
    assert ops == pytest.approx(flops / 989e12 * 1e3)
    assert cs.bound(ops, nbytes) == (nbytes, "bytes")
    # each kernel's own reads and writes: the fp32 passed states (50.3 MB)
    # are written by the first (with the final state) and read by the second
    states = 4 * b * h * (s // q) * p * n
    _, st_bytes = cs.ssd_floor_ms(b, s, h, p, g, n, q, "chunk_state")
    _, sc_bytes = cs.ssd_floor_ms(b, s, h, p, g, n, q, "chunk_scan")
    assert st_bytes * 3.35e12 / 1e3 == pytest.approx(
        x + 4 * b * s * h + 2 * b * s * g * n + states + 2 * b * h * p * n)
    assert sc_bytes * 3.35e12 / 1e3 == pytest.approx(
        2 * x + 4 * b * s * h + 2 * (2 * b * s * g * n) + states)
    assert (st_bytes + sc_bytes - nbytes) * 3.35e12 / 1e3 == pytest.approx(
        2 * states + x + 4 * b * s * h + 2 * b * s * g * n)
    # an initial state is read once more, at its own element size
    _, with_init = cs.ssd_floor_ms(b, s, h, p, g, n, q, init_bytes=4)
    assert (with_init - nbytes) * 3.35e12 / 1e3 == pytest.approx(4 * b * h * p * n)


def test_mamba2_train_ssd_backward_bound():
    """B 4, S 2048, H 48, P 64, G 1, N 128, Q 256: the whole backward must
    read x, dy (bf16), B, C, log_a and the fp32 states and write dx, dlog_a,
    dB and dC once, ~213 MB; each kernel counts its own reads and writes."""
    b, s, h, p, g, n, q = 4, 2048, 48, 64, 1, 128, 256
    x, bc, la = 2 * b * s * h * p, 2 * b * s * g * n, 4 * b * s * h
    states, fin, dt = 4 * b * h * (s // q) * p * n, 4 * b * h * p * n, 4 * b * h * (s // q)
    ops, nbytes = cs.ssd_bwd_floor_ms(b, s, h, p, g, n, q, "function")
    assert nbytes * 3.35e12 / 1e3 == pytest.approx(3 * x + 4 * bc + 2 * la + states)
    assert nbytes * 3.35e12 / 1e3 == pytest.approx(212.86e6, rel=1e-4)
    pairs = (s // q) * q * (q + 1) // 2
    flops = (2 * b * g * pairs * n                 # C.B^T, once per group
             + 2 * b * h * pairs * (2 * p + 2 * n)  # dS, dx, dB, dC
             + 8 * b * h * s * p * n)              # inter, dprev, G.B, G^T.x
    assert ops == pytest.approx(flops / 989e12 * 1e3)
    _, st = cs.ssd_bwd_floor_ms(b, s, h, p, g, n, q, "chunk_state_bwd")
    assert st * 3.35e12 / 1e3 == pytest.approx(x + bc + la + 2 * states + fin + dt)
    st_ops, sc = cs.ssd_bwd_floor_ms(b, s, h, p, g, n, q, "chunk_scan_bwd", slices=4)
    assert sc * 3.35e12 / 1e3 == pytest.approx(
        3 * x + 2 * bc + 2 * la + 2 * states + dt + 2 * 4 * b * s * g * 4 * n)
    assert st_ops < ops
    # an initial state and dfinal: dfinal read by the state pass, the
    # initial state's gradient written by the function
    _, with_init = cs.ssd_bwd_floor_ms(b, s, h, p, g, n, q, "function", dfinal=True,
                                       init=True)
    assert (with_init - nbytes) * 3.35e12 / 1e3 == pytest.approx(2 * fin)


def test_ssd_bound_of_a_short_prompt_counts_one_chunk():
    """S 100 < chunk 256: one chunk of Q = 100, 5050 allowed pairs."""
    ops, _ = cs.ssd_floor_ms(1, 100, 1, 64, 1, 16, 256, "chunk_scan")
    flops = 2 * 5050 * 16 + 2 * 5050 * 64 + 2 * 100 * 16 * 64
    assert ops == pytest.approx(flops / 989e12 * 1e3)


def test_slab_relative_error_per_batch_and_head():
    want = torch.ones(2, 5, 3, 4)                 # (B, S, H, P)
    want[1, :, 2] = 0.01                          # one small (b, h)
    out = want.clone()
    out[1, 3, 2, 0] += 0.002
    assert cs.slab_rel_err(out, want, keep=(0, 2)) == pytest.approx(0.2, rel=1e-4)
    out = want.clone()
    out[0, 0, 0, 0] += 0.002
    assert cs.slab_rel_err(out, want, keep=(0, 2)) == pytest.approx(0.002, rel=1e-3)


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
    assert same["within_bounds"]
    with pytest.raises(AssertionError, match="logits disagree"):
        cs.logits_agreement(want + 0.5 * want.std(), want)
    # without the gate: reported, and require_agreement raises later
    out = cs.logits_agreement(want + 0.5 * want.std(), want, gate=False)
    assert not out["within_bounds"]
    with pytest.raises(AssertionError, match="logits disagree"):
        cs.require_agreement(out)


def test_logits_agreement_bounds_scale_with_depth():
    """One logit moved by 0.3 std fails the 26-layer max bound and passes
    the 48-layer one (0.25 and 0.05 times 48 / 26: 0.4615, 0.0923)."""
    want = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 50))).float()
    shifted = want.clone()
    shifted[0, want[0].argmin()] += 0.3 * want.std()
    with pytest.raises(AssertionError, match="logits disagree"):
        cs.logits_agreement(shifted, want)
    out = cs.logits_agreement(shifted, want, layers=48)
    assert out["bound_max_rel"] == pytest.approx(0.25 * 48 / 26)
    assert out["bound_mean_rel"] == pytest.approx(0.05 * 48 / 26)
    assert out["max_rel_to_std"] == pytest.approx(0.3, rel=1e-5)


def test_shallow_cut_takes_the_sqrt_depth_scaling():
    """At 4 of 26 layers sqrt(4/26) = 0.392 is above 4/26 = 0.154: the
    qwen2-moe cut gets 0.098·std max and 0.0196·std mean."""
    assert cs.QWEN2_MOE_DEPTH_SCALE == pytest.approx(0.3922, abs=1e-4)
    assert cs.QWEN2_MOE_DEPTH_SCALE > cs.QWEN2_MOE_LAYERS / cs.CONSISTENCY_LAYERS
    want = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 50))).float()
    out = cs.logits_agreement(want.clone(), want, cs.QWEN2_MOE_LAYERS,
                              depth_scale=cs.QWEN2_MOE_DEPTH_SCALE)
    assert out["bound_max_rel"] == pytest.approx(0.25 * 0.3922, abs=1e-4)
    assert out["bound_mean_rel"] == pytest.approx(0.05 * 0.3922, abs=1e-5)


def test_busy_time_is_the_union_of_intervals():
    assert cs.busy_us([]) == 0.0
    assert cs.busy_us([(20, 30), (0, 10), (5, 15), (21, 22)]) == 25.0
    assert cs.busy_us([(0, 10), (10, 12)]) == 12.0


def test_olmoe_prefill_gmm_bound():
    """T 65536 (4 x 2048 tokens x top-8), d 2048, f 1024, all 64 experts
    with rows: 2.7e11 FLOPs, 0.278 ms at 989 TFLOP/s, against 671 MB,
    0.200 ms: bound by operations; the 48 calls of a prefill ~13.3 ms."""
    ops, nbytes = cs.gmm_floor_ms(65536, 2048, 1024, 64)
    assert ops == pytest.approx(2 * 65536 * 2048 * 1024 / 989e12 * 1e3)
    assert ops == pytest.approx(0.278, abs=5e-4)
    want_bytes = 2 * (65536 * 2048 + 64 * 2048 * 1024 + 65536 * 1024)
    assert want_bytes == pytest.approx(671e6, rel=1e-3)
    assert nbytes == pytest.approx(want_bytes / 3.35e12 * 1e3)
    assert nbytes == pytest.approx(0.200, abs=5e-4)
    assert cs.bound(ops, nbytes) == (ops, "operations")
    # gate, up (2048 -> 1024) and down (1024 -> 2048): the same work each
    down_ops, down_bytes = cs.gmm_floor_ms(65536, 1024, 2048, 64)
    assert (down_ops, down_bytes) == pytest.approx((ops, nbytes))
    assert 48 * ops == pytest.approx(13.3, abs=0.05)


def test_decode_gmm_bound_counts_only_the_experts_with_rows():
    """32 rows (4 tokens x top-8) over 25 non-empty of 64 experts: the
    weights of those 25 are the bytes, and they bound the call."""
    ops, nbytes = cs.gmm_floor_ms(32, 2048, 1024, 25)
    want_bytes = 2 * (32 * 2048 + 25 * 2048 * 1024 + 32 * 1024)
    assert nbytes == pytest.approx(want_bytes / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes) == (nbytes, "bytes")
    _, all_bytes = cs.gmm_floor_ms(32, 2048, 1024, 64)
    assert all_bytes > 2.5 * nbytes


def test_gmm_errors_gate_elementwise_with_relative_part():
    """One bf16 step (2**-5) at |y| = 5 passes (2e-2 + 2e-2 * 5); the same
    error at |y| = 0.1 fails the elementwise gate."""
    want = torch.full((4, 8), 0.1)
    want[0, 0] = 5.0
    out = want.clone()
    out[0, 0] += 2 ** -5
    errs = cs.gmm_errors(out, want)
    assert errs["max_abs_err"] == pytest.approx(2 ** -5)
    assert errs["elements_out_of_tol"] == 0
    out = want.clone()
    out[1, 3] += 2 ** -5
    with pytest.raises(AssertionError, match="grouped_matmul disagrees"):
        cs.gmm_errors(out, want)


def test_routing_differences_counts_tokens_whose_set_differs():
    want = [torch.tensor([[5.0, 3.0, 2.0, 0.0],
                          [1.0, 2.0, 3.0, 4.0],
                          [4.0, 3.1, 2.9, 0.0]]),
            torch.tensor([[2.5, 2.0, 3.0, 1.0]] * 3)]
    got = [w.clone() for w in want]
    out = cs.routing_differences(got, want, top_k=2)
    assert out["differing_per_layer"] == [0, 0] and out["differing"] == 0
    assert out["max_gap_of_differing"] is None and out["max_logit_shift"] == 0.0
    # a near-tie (gap 0.2) tipped over, and the same set in another order
    got[0][2] = torch.tensor([4.0, 2.99, 3.01, 0.0])
    got[0][0] = torch.tensor([3.0, 5.0, 2.0, 0.0])
    out = cs.routing_differences(got, want, top_k=2)
    assert out["differing_per_layer"] == [1, 0]
    assert out["max_gap_of_differing"] == pytest.approx(0.2)
    assert out["max_logit_shift"] == pytest.approx(2.0)
    assert out["tokens"] == 3 and out["layers"] == 2
    assert out["median_logit_gap"] == pytest.approx(0.5)


def test_routing_is_recorded_and_replayed():
    """recorded_routing keeps every router call's (probs, logits);
    replayed_routing hands them back in order, whatever the input."""
    import types

    def router_probs(x, w):
        logits = x @ w
        return torch.softmax(logits, -1), logits

    mod = types.SimpleNamespace(router_probs=router_probs)
    w = torch.eye(3)
    with cs.recorded_routing(mod) as calls:
        mod.router_probs(torch.ones(2, 3), w)
        mod.router_probs(torch.zeros(2, 3), w)
    assert mod.router_probs is router_probs and len(calls) == 2
    assert [lg.sum().item() for lg in cs.logits_of(calls)] == [6.0, 0.0]
    with cs.replayed_routing(mod, calls):
        probs, logits = mod.router_probs(torch.full((2, 3), 7.0), w)
        assert logits.sum().item() == 6.0
        assert mod.router_probs(None, None)[1].sum().item() == 0.0
    assert mod.router_probs is router_probs


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_attention_fwd_kernel<256>(...)",
     "flash_attention"),
    ("void (anonymous namespace)::bwd::flash_attention_bwd_prep_kernel<256>(...)",
     "flash_attention_bwd"),
    ("void (anonymous namespace)::bwd::flash_attention_bwd_kernel<256>(CUtensorMap, ...)",
     "flash_attention_bwd"),
    ("void (anonymous namespace)::bwd::flash_attention_bwd_convert_kernel<80>(...)",
     "flash_attention_bwd"),
    ("void (anonymous namespace)::ssd_chunk_state_kernel<64, 128>(Params)",
     "ssd_scan"),
    ("void (anonymous namespace)::ssd_chunk_scan_kernel<64, 128>(Params)",
     "ssd_scan"),
    ("void (anonymous namespace)::ssd_chunk_state_bwd_kernel<64, 128>(Params)",
     "ssd_scan_bwd"),
    ("void (anonymous namespace)::ssd_chunk_scan_bwd_kernel<64, 16>(BwdParams)",
     "ssd_scan_bwd"),
    ("(anonymous namespace)::grouped_matmul_kernel(__nv_bfloat16 const*, ...)",
     "grouped_matmul"),
    ("void (anonymous namespace)::grouped_matmul_kernel<false>(CUtensorMap, ...)",
     "grouped_matmul"),
    ("void (anonymous namespace)::grouped_matmul_kernel(CUtensorMap, ...)",
     "grouped_matmul"),
    ("void (anonymous namespace)::grouped_matmul_dx_kernel(CUtensorMap, ...)",
     "grouped_matmul_bwd"),
    ("void (anonymous namespace)::grouped_matmul_dw_kernel(CUtensorMap, ...)",
     "grouped_matmul_bwd"),
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


def test_ptxas_flags_spills_and_ignored_setmaxnreg():
    log = "\n".join([
        "ptxas info    : Compiling entry function 'k1' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers, 4144 bytes smem",
        "    16 bytes stack frame, 12 bytes spill stores, 0 bytes spill loads",
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
        "register count at entry",
        "ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized",
    ])
    flags = cs.ptxas_flags(log)
    assert len(flags) == 3
    assert flags[0].startswith("16 bytes stack frame, 12 bytes spill stores")
    assert "C7508" in flags[1] and "C7518" in flags[2]
    assert cs.ptxas_flags(log.splitlines()[1]) == []


def test_ptxas_kernels_reads_each_kernels_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_13bwd26flash_attention_bwd_kernelILi256EEEv14CUtensorMap_stS2_"
        "NS0_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_13bwd26flash_attention",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 32 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi64EEEv14CUtensorMap_st' "
        "for 'sm_90a'",
        "ptxas info    : Used 90 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_13bwd34flash_attention_bwd_convert_kernelILi80EEEvPKfP13"
        "__nv_bfloat16iiif' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 32 registers, 380 bytes cmem[0]",
    ])
    assert cs.ptxas_kernels(log, "flash_attention_bwd") == {
        "flash_attention_bwd_kernel<256>": {"registers": 168, "spill_stores": 0,
                                            "spill_loads": 0},
        "flash_attention_bwd_convert_kernel<80>": {"registers": 32, "spill_stores": 4,
                                                   "spill_loads": 4},
    }


def test_ptxas_kernels_reads_a_bool_template_argument():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122ssd_chunk_state_kernelILi64ELi128ELb1EEEv14CUtensorMap_stS1_"
        "6Params' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 139 registers",
    ])
    assert cs.ptxas_kernels(log, "ssd_chunk_") == {
        "ssd_chunk_state_kernel<64, 128, 1>": {"registers": 139, "spill_stores": 0,
                                               "spill_loads": 0}}


def test_host_us_times_every_call_and_syncs_between_rounds(monkeypatch):
    """1,000 timed calls in rounds of 100 after one warm-up call, a
    synchronisation before each round and one at the end."""
    syncs, calls = [], []
    monkeypatch.setattr(cs.torch.cuda, "synchronize", lambda: syncs.append(len(calls)))
    us = cs.host_us(lambda: calls.append(1))
    assert len(calls) == 1001
    assert syncs == [1 + 100 * i for i in range(10)] + [1001]
    assert 0 < us < 1e4


def test_gmm_row_tiles_counts_each_experts_partial_tile():
    sizes = torch.tensor([0, 1, 128, 129, 300], dtype=torch.int32)
    assert cs.gmm_row_tiles(sizes) == 0 + 1 + 1 + 2 + 3
    assert cs.gmm_row_tiles(torch.zeros(4, dtype=torch.int32)) == 0


def test_serve_requests_answers_eight_requests_of_sixteen_tokens(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model, compute_copy
    monkeypatch.setattr(cs.torch.cuda, "synchronize", lambda: None)
    cfg = get_smoke("gemma3-1b")
    params = compute_copy(cfg, Model(cfg, "cpu").init(seed=0))
    engine, n_tok, seconds = cs.serve_requests(cfg, params, "cpu",
                                               np.random.default_rng(0))
    assert n_tok == 8 * 16 and seconds > 0
    # 8 requests on 4 slots: two rounds of at least 2 prompt + 16 new tokens
    assert engine.cache["pos"] >= 2 * 17


def test_kernel_ms_sums_only_the_matching_kernels_per_call(monkeypatch):
    """The device time per call of the kernels whose names match, from the
    profiler's kernel intervals (in us), leaving out the other kernels and
    the host's events."""
    calls = []

    def event(name, start, end, on_card=True):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=start, end=end),
            device_type=(cs.torch.autograd.DeviceType.CUDA if on_card
                         else cs.torch.autograd.DeviceType.CPU))

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [event("ssd_chunk_state_kernel<64, 128>", 0.0, 60.0),
                    event("ssd_chunk_state_kernel<64, 128>", 100.0, 160.0),
                    event("vectorized_elementwise_kernel", 60.0, 100.0),
                    event("ssd_chunk_state", 0.0, 1000.0, on_card=False)]

    monkeypatch.setattr(cs, "profile", Profile)
    monkeypatch.setattr(cs.torch.cuda, "synchronize", lambda: None)
    ms = cs.kernel_ms(lambda: calls.append(1), "ssd_chunk_state", iters=2)
    assert ms == pytest.approx(0.060)
    assert len(calls) == 3   # one warm-up, then the profiled calls


def test_fa_bwd_cases_cover_every_head_dim():
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert {case[5] for case in cs.FA_BWD_CASES} >= set(HEAD_DIMS)
    assert any(case[8] for case in cs.FA_BWD_CASES)   # rows without keys
    assert (("h2o-danube-1.8b past window", 1, 4608, 32, 8, 80, True, 4096, False)
            in cs.FA_BWD_CASES)


def test_dense_archs_are_the_ported_dense_configs_and_what_one_card_trains():
    """The three dense configs that the card serves whole are ported, with
    the attention the kernels take (D 256 MHA, D 80 with a window of 4096
    that DANUBE_WINDOW_CHECK_SEQ passes, D 128 MHA); h2o-danube-1.8b's
    training fits the budget by launch.train's reckoning, gemma-7b's and
    deepseek-7b's do not fit one card."""
    from repro_torch.configs import PORTED, get
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.train.step import train_memory_gb
    assert set(cs.DENSE_ARCHS) <= set(PORTED)
    shapes = {a: (get(a).n_heads, get(a).n_kv_heads, get(a).head_dim, get(a).window)
              for a in cs.DENSE_ARCHS}
    assert shapes == {"gemma-7b": (16, 16, 256, 0), "h2o-danube-1.8b": (32, 8, 80, 4096),
                      "deepseek-7b": (32, 32, 128, 0)}
    assert {s[2] for s in shapes.values()} <= set(HEAD_DIMS)
    assert cs.DANUBE_WINDOW_CHECK_SEQ > get("h2o-danube-1.8b").window
    danube = cs.train_reckoning_gb(get("h2o-danube-1.8b"), 24)
    assert danube == train_memory_gb(get("h2o-danube-1.8b"))
    assert danube["total_gb"] < cs.TRAIN_BUDGET_GB
    for arch in cs.REFUSED_ON_ONE_CARD:
        assert train_memory_gb(get(arch))["total_gb"] > 80


def test_ssd_consistency_cuts_and_their_bounds():
    """The SSM paths' prefill-against-decode checks run on cuts of the
    model: mamba2-780m's first 12 SSM layers, hymba-1.5b's first 8 (one
    hyb_g, seven hyb_l); the bounds take the sqrt depth scaling."""
    from repro_torch.configs import get
    mamba = cs.cut_depth(get("mamba2-780m"), cs.SSD_CONSISTENCY_LAYERS["mamba2-780m"])
    hymba = cs.cut_depth(get("hymba-1.5b"), cs.SSD_CONSISTENCY_LAYERS["hymba-1.5b"])
    assert mamba.layer_types == ("ssm",) * 12
    assert tuple(hymba.layer_types) == ("hyb_g",) + ("hyb_l",) * 7
    assert hymba.n_layers == 8 and mamba.n_layers == 12
    want = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 50))).float()
    out = cs.logits_agreement(want.clone(), want, 8, depth_scale=math.sqrt(8 / 26))
    assert out["bound_max_rel"] == pytest.approx(0.25 * math.sqrt(8 / 26))
    assert out["bound_mean_rel"] == pytest.approx(0.05 * math.sqrt(8 / 26))


def test_dryrun_cells_hold_the_train_cell_at_two_microbatches():
    """dryrun_vs_card's (d) is (a), gemma3-1b's train step at 4 x 2048 on
    one card, at n_micro 2; every other cell runs one microbatch."""
    cells = {c[0] + " " + c[2][0]: c for c in cs.DRYRUN_CELLS}
    a, d = cells["a train_4x2048"], cells["d train_4x2048"]
    assert d[1:4] == a[1:4] and (a[4], d[4]) == (1, 2)
    assert [c[4] for c in cs.DRYRUN_CELLS].count(2) == 1


def test_train_reckoning_counts_the_microbatches_gradient_sum():
    """With n_micro > 1 a device also holds the fp32 sum of the
    microbatches' gradients (4 bytes a parameter it holds); at n_micro 1
    nothing changes."""
    from repro_torch.configs import get
    from repro_torch.train.step import train_memory_gb
    cfg = get("gemma3-1b")
    one, two = train_memory_gb(cfg, 2), train_memory_gb(cfg, 2, n_micro=2)
    assert one["accumulator_gb"] == 0.0
    assert two["accumulator_gb"] == pytest.approx(4 * cfg.param_count() / 1e9)
    assert two["total_gb"] == pytest.approx(one["total_gb"] + two["accumulator_gb"])
    assert two["replicated_gb"] == pytest.approx(12 * cfg.param_count() / 1e9)


def test_attention_backward_bound():
    """Five products per allowed pair (2.5x the forward's operations); q,
    k, v, O, dO, dQ, dK, dV once in bf16 and the LSE once in fp32."""
    b, s, hq, hkv, d = 4, 2048, 4, 1, 256
    fwd_ops, _ = cs.attention_floor_ms(b, s, hq, hkv, d, True, 512)
    ops, nbytes = cs.attention_bwd_floor_ms(b, s, hq, hkv, d, True, 512)
    assert ops == pytest.approx(2.5 * fwd_ops)
    want = 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s
    assert nbytes == pytest.approx(want / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes)[1] == "operations"


def test_grad_row_err_gates_each_row_on_its_own_scale():
    want = torch.tensor([[1.0, -2.0], [0.001, 0.0]])
    # 2e-2 of 2.0 + 1e-3 = 0.041 allowed in row 0; 1e-3 + 2e-5 in row 1
    got = want + torch.tensor([[0.04, 0.0], [0.0, 0.0]])
    err, over = cs.grad_row_err(got, want)
    assert err == pytest.approx(0.04) and over < 0
    got = want + torch.tensor([[0.0, 0.0], [0.002, 0.0]])
    err, over = cs.grad_row_err(got, want)
    assert err == pytest.approx(0.002) and over > 0


def test_olmoe_train_gmm_backward_bounds():
    """At olmoe-1b-7b training (T 65536, d 2048, f 1024, E 64): dx moves
    what the forward moves (dy and dx once, the non-empty experts' weights
    once); dw reads x and dy and writes every expert's slab; each does
    2·T·d·f FLOPs and is bound by them."""
    t, d, f, e = 65536, 2048, 1024, 64
    ops, nbytes = cs.gmm_dw_floor_ms(t, d, f, e)
    assert ops == pytest.approx(2 * t * d * f / 989e12 * 1e3)
    want = 2 * (t * d + t * f + e * d * f)
    assert nbytes == pytest.approx(want / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes) == (ops, "operations")
    # dx of the gate (dy (T, f) against w (E, d, f)): the forward's counts
    dx_ops, dx_bytes = cs.gmm_floor_ms(t, f, d, e)
    assert dx_ops == pytest.approx(ops)
    assert dx_bytes == pytest.approx(
        2 * (t * f + e * d * f + t * d) / 3.35e12 * 1e3)
    # an empty expert's weights are not read by dx, but dw writes its zeros
    assert cs.gmm_floor_ms(t, f, d, 10)[1] < dx_bytes
    assert cs.gmm_dw_floor_ms(t, d, f, e)[1] > cs.gmm_dw_floor_ms(t, d, f, 10)[1]


@pytest.mark.parametrize("layers", [1, 4, 8])
def test_moe_step_launches(layers):
    """Full remat: 3 grouped GEMMs and one attention a layer, forward and
    recompute; a dx and a dw for each GEMM and one attention backward."""
    from repro_torch.configs import get
    assert cs.step_launches(cs.cut_depth(get("olmoe-1b-7b"), layers)) == {
        "grouped_matmul": 6 * layers, "grouped_matmul_dx": 3 * layers,
        "grouped_matmul_dw": 3 * layers, "flash_attention": 2 * layers,
        "flash_attention_bwd": layers}


def test_moe_train_depth_by_memory():
    """olmoe-1b-7b: a layer holds ~419.6 M parameters (experts 402.7 M), the
    embedding and the untied unembedding 206 M.  Parameters, gradients,
    AdamW's master copy and moments take 20 bytes a parameter: 16 layers
    ~138 GB, 8 ~71.3 GB, 4 ~37.7 GB; with AdamW's temporaries of a stacked
    expert weight (5 x 4.3 GB at 8 layers) and the activations only 4
    layers fit 72 GB."""
    from repro_torch.configs import get
    cfg = get("olmoe-1b-7b")
    per_layer = (cs.cut_depth(cfg, 2).param_count() - cs.cut_depth(cfg, 1).param_count())
    assert per_layer == pytest.approx(419.6e6, rel=1e-3)
    assert 64 * 3 * 2048 * 1024 == pytest.approx(402.7e6, rel=1e-3)
    state = {n: cs.train_reckoning_gb(cfg, n)["state_gb"] for n in (16, 8, 4)}
    assert state == pytest.approx({16: 138.4, 8: 71.3, 4: 37.7}, abs=0.1)
    eight = cs.train_reckoning_gb(cfg, 8)
    assert eight["update_gb"] == pytest.approx(5 * 4 * 8 * 64 * 2048 * 1024 / 1e9)
    assert eight["total_gb"] == pytest.approx(
        eight["state_gb"] + eight["update_gb"] + eight["activation_gb"])
    assert cs.train_depth(cfg) == 4
    assert cs.train_depth(cfg, budget_gb=110.0) == 8
    assert cs.train_depth(cfg, budget_gb=110.0, depths=(16, 8, 4)) == 8
    with pytest.raises(ValueError, match="not even 4 layers"):
        cs.train_depth(cfg, budget_gb=50.0)
    cut = cs.cut_depth(cfg, 8)
    assert (cut.n_layers, cut.layer_types, cut.d_model, cut.n_experts) == (
        8, ("moe",) * 8, 2048, 64)


def test_active_params_count_top_k_of_the_experts():
    """olmoe at 8 layers: each token passes 8 of 64 experts a layer."""
    from repro_torch.configs import get
    cut = cs.cut_depth(get("olmoe-1b-7b"), 8)
    experts = 8 * 64 * 3 * 2048 * 1024
    assert cs.active_params(cut) == cut.param_count() - experts * 56 // 64
    assert cs.active_params(cut) == pytest.approx(744e6, rel=2e-3)


def test_dw_errors_want_every_slab_within_its_own_scale():
    sizes = torch.tensor([3, 0, 5], dtype=torch.int32)
    want = torch.zeros((3, 2, 2))
    want[0] = 10.0
    want[2] = 0.1
    out = want.clone()
    out[0, 0, 0] += 0.15          # 1.5e-2 of the slab's largest: passes
    assert cs.dw_errors(out, want, sizes)["max_slab_rel_err"] == pytest.approx(0.015, rel=1e-5)
    bad = want.clone()
    bad[2, 0, 0] += 0.01          # 1e-1 of a small slab's scale
    with pytest.raises(AssertionError, match="grouped_matmul_dw disagrees"):
        cs.dw_errors(bad, want, sizes)
    bad = want.clone()
    bad[1, 1, 1] = 1e-30          # an empty expert's slab not exactly zero
    with pytest.raises(AssertionError, match="empty_slabs_exactly_zero"):
        cs.dw_errors(bad, want, sizes)
    bad = want.clone()
    bad[1, 0, 0] = float("nan")   # an element the kernel never wrote
    with pytest.raises(AssertionError, match="all_finite"):
        cs.dw_errors(bad, want, sizes)


def test_expert_choices_are_replayed_with_differentiable_probs():
    """recorded_choices keeps each routing call's top-k indices;
    replayed_choices makes another router choose them, its weights the
    probabilities at those indices, through which the gradient flows."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=gen)
    w1, w2 = (torch.randn(8, 4, generator=gen) for _ in range(2))
    with cs.recorded_choices(moe) as calls:
        moe._route(x, w1, 2, False)
    assert len(calls) == 1 and calls[0].shape == (6, 2)
    w2.requires_grad_(True)
    with cs.replayed_choices(moe, calls):
        probs, _, top_p, top_idx = moe._route(x, w2, 2, True)
    assert moe._route.__name__ == "_route"
    assert torch.equal(top_idx, calls[0])
    assert torch.allclose(top_p, probs.gather(-1, calls[0]) / probs.gather(
        -1, calls[0]).sum(-1, keepdim=True))
    (top_p[:, 0].sum()).backward()
    assert w2.grad is not None and w2.grad.abs().sum() > 0


def test_fa_cases_hold_hymbas_global_and_window_shapes():
    """hymba-1.5b's two attention shapes (25 query heads, 5 KV heads of 64,
    S 2048): its global layers (causal, no window) and its hyb_l layers
    (window 1024), forward and backward."""
    for want in (("hymba-1.5b global", 4, 2048, 25, 5, 64, True, 0),
                 ("hymba-1.5b swa", 4, 2048, 25, 5, 64, True, 1024)):
        assert want in cs.FA_CASES
        assert (*want, False) in cs.FA_BWD_CASES


def test_attention_windows_in_layer_order():
    from repro_torch.configs import get
    hymba = cs.attention_windows(get("hymba-1.5b"))
    assert len(hymba) == 32
    assert [i for i, w in enumerate(hymba) if w == 0] == [0, 15, 31]
    assert set(hymba) == {0, 1024}
    gemma3 = cs.attention_windows(get("gemma3-1b"))
    assert gemma3 == [0 if kind == "attn" else 512 for kind in get("gemma3-1b").layer_types]
    assert cs.attention_windows(get("mamba2-780m")) == []
    assert cs.attention_windows(get("olmoe-1b-7b")) == [0] * 16


def test_path_kernels_pick_both_families_for_a_hybrid_config():
    """The gang's count picker: a hybrid config launches the attention and
    the SSD kernels (forward, and with the backward both backward kernels);
    the other configs only their own."""
    from repro_torch.configs import get
    hymba = cs.card_smoke("hymba-1.5b")
    assert set(cs.path_kernels(hymba, backward=True)) == {
        "flash_attention", "flash_attention_bwd", "ssd_chunk_state", "ssd_chunk_scan",
        "ssd_chunk_state_bwd", "ssd_chunk_scan_bwd"}
    assert cs.path_kernels(get("hymba-1.5b"), backward=False) == (
        "flash_attention", "ssd_chunk_state", "ssd_chunk_scan")
    assert set(cs.path_kernels(cs.card_smoke("mamba2-780m"), True)) == {
        "ssd_chunk_state", "ssd_chunk_scan", "ssd_chunk_state_bwd", "ssd_chunk_scan_bwd"}
    assert cs.path_kernels(get("gemma3-1b"), True) == (
        "flash_attention", "flash_attention_bwd")
    assert set(cs.path_kernels(cs.card_smoke("olmoe-1b-7b"), True)) == {
        "flash_attention", "flash_attention_bwd", "grouped_matmul",
        "grouped_matmul_dx", "grouped_matmul_dw"}
    # every name is a counter the script reads
    cs.reset_launches()
    assert cs.launch_counts(cs.path_kernels(hymba, True)) == dict.fromkeys(
        cs.path_kernels(hymba, True), 0)


def test_card_smoke_hymba_takes_a_state_the_ssd_kernels_have():
    """The reference's smoke hymba has an SSD state of 8, which the SSD
    kernels (state dims multiples of 16) do not take; the card's smoke
    config differs in that field only."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.ssd_scan import HEAD_STATE_DIMS
    ref, card = get_smoke("hymba-1.5b"), cs.card_smoke("hymba-1.5b")
    assert (ref.ssm_head_dim, ref.ssm_state) not in HEAD_STATE_DIMS
    assert (card.ssm_head_dim, card.ssm_state) in HEAD_STATE_DIMS
    assert dataclasses.replace(card, ssm_state=ref.ssm_state) == ref
    assert cs.card_smoke("mamba2-780m") == get_smoke("mamba2-780m")
    assert cs.card_smoke("hymba-1.5b", use_kernels=True).use_kernels


def test_hymba_train_reckoning():
    """hymba-1.5b: 1,589,773,120 parameters at 20 bytes (fp32 parameters,
    gradients, AdamW's master copy and two moments) hold 31.8 GB; AdamW's
    temporaries of the largest leaf, the 15-layer hyb_l segment's in_proj
    (15 x 1600 x 6482), 3.1 GB; with 8 GB of activations the full depth
    fits the 72 GB budget."""
    from repro_torch.configs import get
    cfg = get("hymba-1.5b")
    assert cfg.param_count() == 1_589_773_120
    assert cs.largest_leaf(cfg) == 15 * 1600 * (2 * 3200 + 2 * 16 + 50)
    got = cs.train_reckoning_gb(cfg, cfg.n_layers)
    assert got["state_gb"] == pytest.approx(31.795, abs=1e-3)
    assert got["update_gb"] == pytest.approx(5 * 4 * 155_568_000 / 1e9)
    assert got["total_gb"] == pytest.approx(42.907, abs=1e-3)
    assert cs.train_depth(cfg, depths=(32, 16)) == 32
    # the cut of the past-the-window check: one global, three local layers
    cut = cs.cut_depth(cfg, cs.HYMBA_WINDOW_LAYERS)
    assert cut.layer_types == ("hyb_g", "hyb_l", "hyb_l", "hyb_l")
    assert cs.HYMBA_WINDOW_SEQ > cfg.window
    assert cs.HYMBA_WINDOW_SEQ % cfg.ssm_chunk == 0
    assert cs.HYMBA_WINDOW_DEPTH_SCALE == pytest.approx((4 / 26) ** 0.5)


def test_step_launches_under_full_remat():
    """A layer's forward kernels run twice a step (the forward and the
    recompute), its backward kernels once: hymba's 32 layers launch both
    families."""
    from repro_torch.configs import get
    assert cs.step_launches(get("hymba-1.5b")) == {
        "flash_attention": 64, "flash_attention_bwd": 32,
        "ssd_chunk_state": 64, "ssd_chunk_scan": 64,
        "ssd_chunk_state_bwd": 32, "ssd_chunk_scan_bwd": 32}
    assert cs.step_launches(get("hymba-1.5b"), 5)["ssd_chunk_scan_bwd"] == 160
    assert cs.step_launches(get("gemma3-1b")) == {
        "flash_attention": 52, "flash_attention_bwd": 26}
    assert cs.step_launches(get("mamba2-780m"), 5) == {
        "ssd_chunk_state": 480, "ssd_chunk_scan": 480,
        "ssd_chunk_state_bwd": 240, "ssd_chunk_scan_bwd": 240}


def test_fa_cases_hold_huberts_and_internvl2s_shapes():
    """hubert-xlarge's attention (16 heads of 80, MHA, bidirectional, S
    2048), forward and backward, and internvl2-26b's (48 query heads, 8 KV
    heads of 128, causal), forward."""
    hubert = ("hubert-xlarge", 4, 2048, 16, 16, 80, False, 0)
    assert hubert in cs.FA_CASES and (*hubert, False) in cs.FA_BWD_CASES
    assert ("internvl2-26b", 4, 2048, 48, 8, 128, True, 0) in cs.FA_CASES


def test_encoder_and_vlm_attention_bounds():
    """Operations bound the new shapes: hubert 4·B·Hq·D·S² = 85.9 GFLOP a
    call (0.0869 ms at 989 TFLOP/s, 4.17 ms for its 48 layers); internvl2
    206 GFLOP a call over the causal pairs (0.209 ms); hubert's backward
    2.5x its forward."""
    ops, nbytes = cs.attention_floor_ms(4, 2048, 16, 16, 80, False, 0)
    assert 4 * 4 * 16 * 80 * 2048 ** 2 == pytest.approx(85.9e9, rel=1e-3)
    assert ops == pytest.approx(0.08686, rel=1e-3) and ops > nbytes
    assert 48 * ops == pytest.approx(4.169, rel=1e-3)
    ops, nbytes = cs.attention_floor_ms(4, 2048, 48, 8, 128, True, 0)
    assert ops == pytest.approx(206.3e9 / 989e12 * 1e3, rel=1e-3) and ops > nbytes
    bwd_ops, _ = cs.attention_bwd_floor_ms(4, 2048, 16, 16, 80, False, 0)
    assert bwd_ops == pytest.approx(2.5 * 0.08686, rel=1e-3)


def test_hubert_and_internvl2_kernels_windows_and_launches():
    """An encoder's layers are attention layers: 48 bidirectional calls
    with no window a forward, 96 and 48 backward a train step under full
    remat; internvl2's 48 causal ones."""
    from repro_torch.configs import get
    hubert, vlm = get("hubert-xlarge"), get("internvl2-26b")
    assert cs.attention_windows(hubert) == [0] * 48
    assert cs.attention_windows(vlm) == [0] * 48
    assert cs.path_kernels(hubert, backward=True) == ("flash_attention",
                                                      "flash_attention_bwd")
    assert cs.path_kernels(vlm, backward=False) == ("flash_attention",)
    assert cs.step_launches(hubert) == {"flash_attention": 96, "flash_attention_bwd": 48}
    assert cs.step_launches(hubert, 5) == {"flash_attention": 480,
                                           "flash_attention_bwd": 240}


def test_train_reckoning_of_hubert_and_internvl2():
    """hubert-xlarge: 947,202,560 parameters hold 18.9 GB of state; its
    largest leaf is the 48-layer MLP weight (48 x 1280 x 5120).  internvl2-
    26b's 19.9 B parameters need ~398 GB of state: launch.train refuses it
    on one card, by the same reckoning."""
    from repro_torch.configs import get
    from repro_torch.train.step import train_memory_gb
    hubert = get("hubert-xlarge")
    assert hubert.param_count() == 947_202_560
    assert cs.largest_leaf(hubert) == 48 * 1280 * 5120
    got = cs.train_reckoning_gb(hubert, hubert.n_layers)
    assert got["state_gb"] == pytest.approx(18.944, abs=1e-3)
    assert got == train_memory_gb(hubert)
    assert got["total_gb"] < cs.TRAIN_BUDGET_GB
    vlm = cs.train_reckoning_gb(get("internvl2-26b"), 48)
    assert vlm["state_gb"] == pytest.approx(397.98, abs=1e-2)
    assert vlm["total_gb"] > 80


def test_attention_mixes_take_the_configs_causality(monkeypatch):
    """fa_prefill_mix and fa_train_mix run an encoder's calls
    bidirectionally: their operations are the bidirectional pairs' (the
    bound here reads the operations alone: at this size the bytes bound
    both masks alike), and the kernel's plain version is held against
    itself at that mask."""
    import dataclasses
    from repro_torch.configs import get_smoke
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters, warmup=2: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "bound", lambda ops_ms, bytes_ms: (ops_ms, "operations"))
    cfg = get_smoke("hubert-xlarge")
    gen = torch.Generator()
    gen.manual_seed(0)
    b, s = 2, 24
    fwd = cs.fa_prefill_mix(cfg, gen, "cpu", b, s)
    bwd = cs.fa_train_mix(cfg, gen, "cpu", b, s)
    args = (b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False, 0)
    assert fwd["bound_ms"] == pytest.approx(cfg.n_layers * cs.attention_floor_ms(*args)[0])
    assert bwd["bound_ms"] == pytest.approx(
        cfg.n_layers * cs.attention_bwd_floor_ms(*args)[0])
    assert fwd["max_abs_err"] == bwd["max_abs_err"] == 0.0
    causal = cs.fa_prefill_mix(dataclasses.replace(cfg, causal=True), gen, "cpu", b, s)
    assert causal["bound_ms"] < fwd["bound_ms"]


def test_model_inputs_and_tree_bytes():
    batch = {"tokens": torch.zeros((2, 3), dtype=torch.int64),
             "patch_embeds": torch.zeros((2, 1, 4), dtype=torch.bfloat16),
             "labels": torch.zeros((2, 4), dtype=torch.int64)}
    assert set(cs.model_inputs(batch)) == {"tokens", "patch_embeds"}
    assert cs.tree_bytes({"a": [batch["tokens"]], "b": batch["patch_embeds"]}) == 48 + 16


def test_rounding_agreement_holds_two_paths_to_the_models_own_rounding():
    """Within bounds when the two tables are no farther apart (mean and
    max) than the reference is from its input-moved self."""
    gen = torch.Generator()
    gen.manual_seed(0)
    want = torch.randn((64, 50), generator=gen)
    moved = want + 0.1 * torch.randn((64, 50), generator=gen)
    close = want + 0.05 * torch.randn((64, 50), generator=gen)
    out = cs.rounding_agreement(close, want, moved)
    assert out["within_bounds"] and out["positions"] == 64
    assert out["mean_abs"] < out["bound_mean_abs"] and out["max_abs"] < out["bound_max_abs"]
    far = want + 0.2 * torch.randn((64, 50), generator=gen)
    assert not cs.rounding_agreement(far, want, moved)["within_bounds"]
    # one position far off fails on the max alone
    spike = close.clone()
    spike[7, 3] += 5.0
    out = cs.rounding_agreement(spike, want, moved)
    assert out["mean_abs"] < out["bound_mean_abs"] and not out["within_bounds"]


def test_clustered_frames_make_the_labels_a_function_of_the_frames():
    gen = torch.Generator()
    gen.manual_seed(0)
    labels = torch.tensor([[0, 1, 2, 1], [2, 2, 0, 1]])
    batch = {"embeds": torch.zeros((2, 4, 256), dtype=torch.bfloat16), "labels": labels}
    out = cs.clustered_frames(batch, gen)
    assert out["labels"] is labels and out["embeds"].dtype == torch.bfloat16
    frames = out["embeds"].float().reshape(8, 256)
    # frames of one label are nearer each other than frames of two labels
    dist = torch.cdist(frames, frames)
    same = labels.reshape(-1)[:, None] == labels.reshape(-1)[None, :]
    off_diagonal = ~torch.eye(8, dtype=torch.bool)
    assert dist[same & off_diagonal].max() < dist[~same].min()
    assert abs(frames.std().item() - (0.1 ** 2 + 0.05 ** 2) ** 0.5) < 0.03


def test_sorted_local_capacity_and_equal_size_gmm_bounds():
    """olmoe-1b-7b's prefill under the mesh: 4 x 2048 tokens, top-8 of 64,
    Cl = 65,536 · 1.25 / 64 = 1280 (a multiple of 128); the gate/up product
    (E·Cl = 81,920 rows, 2048 → 1024) moves 2·(81,920·2048 + 64·2048·1024 +
    81,920·1024) bytes and does 2·81,920·2048·1024 FLOPs: bound by
    operations.  dx and dw do the same FLOPs; dw writes every expert's
    slab."""
    assert cs.sorted_local_capacity(4 * 2048, 8, 64) == 1280
    assert cs.sorted_local_capacity(100, 2, 8) == 128            # at least 128
    assert cs.sorted_local_capacity(2048, 8, 64) == 384          # rounded up
    rows, d, f, e = 64 * 1280, 2048, 1024, 64
    ops, nbytes = cs.equal_gmm_floor_ms("fwd", rows, d, f, e)
    assert ops == pytest.approx(2 * rows * d * f / 989e12 * 1e3)
    assert nbytes == pytest.approx(2 * (rows * d + e * d * f + rows * f) / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes)[1] == "operations"
    dx_ops, dx_bytes = cs.equal_gmm_floor_ms("dx", rows, d, f, e)
    assert dx_ops == pytest.approx(ops) and dx_bytes == pytest.approx(nbytes)
    dw_ops, dw_bytes = cs.equal_gmm_floor_ms("dw", rows, d, f, e)
    assert dw_ops == pytest.approx(ops)
    assert dw_bytes == pytest.approx(2 * (rows * d + rows * f + e * d * f) / 3.35e12 * 1e3)


def test_train_reckoning_per_device_with_a_data_size():
    """Per device, ZeRO-1: the fp32 parameters and gradients (8 bytes a
    parameter) on every device, the master and the moments (12) and the
    largest leaf's update temporaries over the data size.  internvl2-26b:
    its replicated 159.2 GB alone pass a card, so no data size fits;
    olmoe-1b-7b fits an 85 GB card at a data size of 8 and not at 4."""
    from repro_torch.configs import get
    from repro_torch.train.step import train_memory_gb
    vlm = get("internvl2-26b")
    assert train_memory_gb(vlm, 1)["total_gb"] == pytest.approx(
        cs.train_reckoning_gb(vlm, 48)["total_gb"])
    assert train_memory_gb(vlm, 1)["replicated_gb"] == pytest.approx(8 * 19_899_009_024 / 1e9)
    assert all(train_memory_gb(vlm, n)["total_gb"] > 85 for n in (8, 64, 1024))
    olmoe = get("olmoe-1b-7b")
    n = olmoe.param_count()
    at8 = train_memory_gb(olmoe, 8)
    assert at8["state_gb"] == pytest.approx((8 * n + 12 * n / 8) / 1e9)
    assert at8["update_gb"] == pytest.approx(train_memory_gb(olmoe)["update_gb"] / 8)
    assert at8["total_gb"] < 85 < train_memory_gb(olmoe, 4)["total_gb"]


def test_train_reckoning_with_a_model_axis():
    """Per device on a (data, model) mesh: the leaves the rules split over
    ``model`` count 1/model (deepseek-7b: all but its norms), so the state
    is 20 bytes over model at (1, 4) and 8 / 2 + 12 / 4 at (2, 2) a
    parameter, and the update temporaries shrink with both; internvl2-26b
    still passes an 85 GB card on 4 cards, at either split."""
    from repro_torch.configs import get
    from repro_torch.train.step import params_per_device, train_memory_gb
    ds = get("deepseek-7b")
    n = ds.param_count()
    norms = ds.n_layers * 2 * ds.d_model + ds.d_model    # kept whole
    assert params_per_device(ds, 4) == pytest.approx((n - norms) / 4 + norms)
    at14, at22 = train_memory_gb(ds, 1, 4), train_memory_gb(ds, 2, 2)
    assert at14["state_gb"] == pytest.approx(20 * params_per_device(ds, 4) / 1e9)
    assert at14["state_gb"] == pytest.approx(34.56, abs=0.01)
    assert at22["state_gb"] == pytest.approx(
        (8 + 12 / 2) * params_per_device(ds, 2) / 1e9)
    assert at22["state_gb"] == pytest.approx(48.37, abs=0.01)
    assert at14["update_gb"] == pytest.approx(train_memory_gb(ds)["update_gb"] / 4)
    assert at22["total_gb"] < 80 < train_memory_gb(ds, 4, 1)["total_gb"]
    vlm = get("internvl2-26b")
    assert min(train_memory_gb(vlm, d, 4 // d)["total_gb"] for d in (1, 2)) > 85
    assert train_memory_gb(vlm, 1, 8)["total_gb"] < 85
    assert train_memory_gb(ds, 3) == train_memory_gb(ds, 3, 1)


@pytest.mark.parametrize("arch,layers,want", [
    ("gemma3-1b", None, {"n_heads": 2, "n_kv_heads": 1, "head_dim": 256}),
    ("mamba2-780m", 8, {"ssm_heads": 24, "ssm_head_dim": 64, "ssm_state": 128}),
    ("olmoe-1b-7b", 4, {"n_heads": 8, "n_kv_heads": 8, "moe_d_ff": 512}),
])
def test_tp_local_shapes_and_their_bounds(arch, layers, want):
    """One model rank's kernel shapes at model 2 (the views' heads and
    hidden units), and their bounds: a rank's half of the heads or of the
    hidden units is half the operations of the whole (the same (B, S))."""
    cfg = cs.tp_config(arch, layers)
    local = cs.tp_local_config(cfg)
    assert {k: getattr(local, k) for k in want} == want
    b, s = cs.TP_BATCH, cs.TP_SEQ
    if arch == "gemma3-1b":
        for w in (0, cfg.window):
            ops, nbytes = cs.attention_floor_ms(b, s, 2, 1, 256, True, w)
            full_ops, _ = cs.attention_floor_ms(b, s, 4, 1, 256, True, w)
            assert ops == pytest.approx(full_ops / 2)
            assert nbytes == pytest.approx(2 * (2 * b * s * 2 * 256 + 2 * b * s * 256)
                                           / 3.35e12 * 1e3)
            bwd_ops, _ = cs.attention_bwd_floor_ms(b, s, 2, 1, 256, True, w)
            assert bwd_ops == pytest.approx(2.5 * ops)
    elif arch == "mamba2-780m":
        ops, _ = cs.ssd_floor_ms(b, s, 24, 64, 1, 128, 256)
        full_ops, _ = cs.ssd_floor_ms(b, s, 48, 64, 1, 128, 256)
        assert ops < full_ops
        assert local.layer_types == cfg.layer_types and local.n_layers == 8
    else:
        rows = b * s * cfg.top_k
        ops, nbytes = cs.gmm_floor_ms(rows, cfg.d_model, 512, cfg.n_experts)
        assert ops == pytest.approx(2 * rows * 2048 * 512 / 989e12 * 1e3)
        assert nbytes == pytest.approx(
            2 * (rows * 2048 + 64 * 2048 * 512 + rows * 512) / 3.35e12 * 1e3)
        assert cs.bound(ops, nbytes)[1] == "bytes"


#: the bounds chip_smoke.py printed before the kernels' cost formulas moved
#: into the package (repro_torch.kernels.costs), at a few shapes:
#: (floor function, arguments, (ms for the operations, ms for the bytes))
BOUNDS_BEFORE_THE_MOVE = [
    ("attention_floor_ms", (4, 2048, 4, 1, 256, True, 512),
     (0.015203821880687562, 0.012520310447761194)),
    ("attention_floor_ms", (2, 1000, 32, 8, 80, False, 0),
     (0.02070778564206269, 0.007641791044776119)),
    ("attention_bwd_floor_ms", (4, 2048, 25, 5, 64, True, 1024),
     (0.10181604044489383, 0.03780546865671642)),
    ("attention_bwd_floor_ms", (1, 777, 16, 16, 128, True, 0),
     (0.006258990333670374, 0.007615063880597015)),
    ("ssd_floor_ms", (4, 2048, 48, 64, 1, 128, 256, "function"),
     (0.01984024538725986, 0.03270931104477612)),
    ("ssd_floor_ms", (4, 2048, 48, 64, 1, 128, 256, "chunk_state"),
     (0.006514106111223458, 0.03208329552238806)),
    ("ssd_floor_ms", (4, 2048, 48, 64, 1, 128, 256, "chunk_scan"),
     (0.013326139276036401, 0.04679466029850746)),
    ("ssd_floor_ms", (2, 512, 50, 64, 1, 16, 256, "function", 4),
     (0.001067809391304348, 0.004176697313432835)),
    ("ssd_bwd_floor_ms", (4, 2048, 48, 64, 1, 128, 256, "function", True, True, 4),
     (0.0655662168008089, 0.06729666865671642)),
    ("ssd_bwd_floor_ms", (4, 2048, 48, 64, 1, 128, 256, "chunk_state_bwd", True, True, 4),
     (0.006514106111223458, 0.04992657194029851)),
    ("ssd_bwd_floor_ms", (4, 2048, 48, 64, 1, 128, 256, "chunk_scan_bwd", True, True, 4),
     (0.059052110689585435, 0.08733099940298507)),
    ("gmm_floor_ms", (65536, 2048, 1024, 60), (0.2779351940788676, 0.19531684298507462)),
    ("gmm_dw_floor_ms", (65536, 2048, 1024, 64), (0.2779351940788676, 0.2003249671641791)),
]


@pytest.mark.parametrize("name,args,want", BOUNDS_BEFORE_THE_MOVE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(BOUNDS_BEFORE_THE_MOVE)])
def test_bounds_unchanged_by_the_shared_cost_formulas(name, args, want):
    """chip_smoke.py's bounds now read repro_torch.kernels.costs (the dry
    run's counter reads the same formulas): the same numbers as before."""
    assert getattr(cs, name)(*args) == pytest.approx(want, rel=1e-12)


def test_dense_consistency_holds_a_model_to_its_own_rounding_past_section_2():
    """Within §2's bounds the check is §2's; where only the max bound fails
    it passes when the kernels' prefill is no farther from the fp32 logits
    than DENSE_FP32_REF times the plain decode (max and mean), and fails
    when the prefill is the farther one."""
    rng = np.random.default_rng(3)
    ref = torch.from_numpy(rng.normal(size=(8, 200))).float()
    noise = torch.from_numpy(rng.normal(size=(8, 200))).float()
    close = cs.consistency_or_own_rounding(ref + 0.001 * noise, ref - 0.001 * noise, ref, 26)
    assert close["within_bounds"] and close["held_to"] == "section 2"
    spike = torch.zeros_like(ref)
    spike[0, 0] = 0.4                       # one logit past the max bound
    other = torch.from_numpy(rng.normal(size=(8, 200))).float()
    own = cs.consistency_or_own_rounding(ref + spike + 0.001 * other, ref - 0.001 * noise,
                                         ref, 26)
    assert not own["within_section_2"] and own["within_bounds"]
    assert own["held_to"] == "own rounding"
    worse = cs.consistency_or_own_rounding(ref, ref + spike, ref, 26)
    assert not worse["within_bounds"]


@pytest.mark.parametrize("arch,want", [
    ("olmoe-1b-7b", {"n_heads": 4, "n_kv_heads": 4, "head_dim": 128, "moe_d_ff": 256}),
    ("gemma-7b", {"n_heads": 4, "n_kv_heads": 4, "head_dim": 256, "d_model": 3072}),
])
def test_tp_local_shapes_at_model_4(arch, want):
    """Every rank of a model-4 mesh: olmoe-1b-7b's experts at f 256 of 1024
    and 4 of its 16 heads; gemma-7b's 4 of 16 query and 4 of 16 KV heads at
    D 256 (one KV head a query head, as the whole)."""
    from repro_torch.configs import get
    cfg = get(arch)
    for rank in range(cs.TP4_MODEL):
        local = cs.tp_local_config(cfg, model=cs.TP4_MODEL, rank=rank)
        assert {k: getattr(local, k) for k in want} == want
        assert local.n_layers == cfg.n_layers
    assert cs.tp_local_config(cfg) == cs.tp_local_config(cfg, model=2)


def test_model_4_bounds_are_the_shared_cost_formulas():
    """The model-4 entries' bounds read ``repro_torch.kernels.costs`` as the
    model-2 entries do: gemma-7b's rank does a quarter of the whole's
    attention operations at (4, 2048); olmoe-1b-7b's grouped GEMMs at f 256
    move the rows, a quarter of the experts' weights and the hidden units,
    bytes-bound; dw writes every expert's slab."""
    from repro_torch.kernels import costs
    b, s = cs.TP4_BATCH, cs.TP4_SEQ
    ops, nbytes = cs.attention_floor_ms(b, s, 4, 4, 256, True, 0)
    assert (ops, nbytes) == cs.floor_ms(costs.attention(b, s, 4, 4, 256, True, 0))
    assert ops == pytest.approx(cs.attention_floor_ms(b, s, 16, 16, 256, True, 0)[0] / 4)
    assert nbytes == pytest.approx(2 * 4 * b * s * 4 * 256 / 3.35e12 * 1e3)
    bwd = cs.attention_bwd_floor_ms(b, s, 4, 4, 256, True, 0)
    assert bwd == cs.floor_ms(costs.attention_bwd(b, s, 4, 4, 256, True, 0))
    assert bwd[0] == pytest.approx(2.5 * ops)
    rows = b * s * 8
    ops, nbytes = cs.gmm_floor_ms(rows, 2048, 256, 64)
    assert ops == pytest.approx(2 * rows * 2048 * 256 / 989e12 * 1e3)
    assert nbytes == pytest.approx(
        2 * (rows * 2048 + 64 * 2048 * 256 + rows * 256) / 3.35e12 * 1e3)
    assert cs.bound(ops, nbytes)[1] == "bytes"
    assert cs.gmm_dw_floor_ms(rows, 2048, 256, 64) == cs.floor_ms(
        costs.gmm_dw(rows, 2048, 256, 64))


def test_model_4_entries_carry_the_kernels_line_keys(monkeypatch):
    """``tp4_entries`` on the CPU (the plain versions, one (1, 64) batch,
    the timer stubbed): five entries, flash attention's forward and
    backward on gemma-7b's model-4 path and the grouped GEMM's forward, dx
    and dw on olmoe-1b-7b's, each with the launches it is given (those
    tp4_rank_steps counts) and every key the kernels line needs."""
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(cs, "TP4_BATCH", 1)
    monkeypatch.setattr(cs, "TP4_SEQ", 64)
    counted = {"gemma-7b": {"flash_attention": 11, "flash_attention_bwd": 12},
               "olmoe-1b-7b": {"flash_attention": 13, "flash_attention_bwd": 14,
                               "grouped_matmul": 15, "grouped_matmul_dx": 16,
                               "grouped_matmul_dw": 17}}
    entries = cs.tp4_entries(torch.device("cpu"), "cpu", counted)
    assert [(e["name"], e["path"], e["launches"]) for e in entries] == [
        ("flash_attention", "gemma-7b TP train, model 4 (28 layers)", 11),
        ("flash_attention_bwd", "gemma-7b TP train, model 4 (28 layers)", 12),
        ("grouped_matmul", "olmoe-1b-7b TP train, model 4 (16 layers)", 15),
        ("grouped_matmul_dx", "olmoe-1b-7b TP train, model 4 (16 layers)", 16),
        ("grouped_matmul_dw", "olmoe-1b-7b TP train, model 4 (16 layers)", 17)]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for entry in entries:
        assert keys <= set(entry) and entry["route"] == "cuda"
        assert entry["bound_ms"] > 0 and entry["max_abs_err"] == 0.0


@pytest.mark.parametrize("arch,overrides", [("olmoe-1b-7b", {}),
                                            ("gemma-7b", {"n_heads": 4, "n_kv_heads": 4})])
def test_a_model_4_rank_steps_alone_on_a_fake_group(arch, overrides):
    """``tp4_rank_step`` on the CPU at smoke size: model rank 0 of a fake
    group of 4 (its collectives move nothing) draws its shards of the
    state and takes one train step on them; every kernel of the path is
    counted, none launched here (the CPU takes the plain versions), and no
    peak is read off a card."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import fake_mesh
    cfg = get_smoke(arch, **overrides)
    mesh = fake_mesh((1, cs.TP4_MODEL), ("data", "model"), 0)
    try:
        got = cs.tp4_rank_step(cfg, mesh, torch.device("cpu"), batch=2, seq=16)
    finally:
        dist.destroy_process_group()
    assert got["launches"] == dict.fromkeys(cs.path_kernels(cfg, backward=True), 0)
    assert got["init_peak_gb"] is None and got["step_peak_gb"] is None
    assert got["init_s"] > 0 and got["step_s"] > 0


def test_nccl_kernels_are_counted_once():
    """A profile of an NCCL collective holds its kernel and the profiler's
    device-side span of the same length around it ("nccl:all_reduce"): the
    NCCL ms and the busy time count the kernel alone, in class "nccl"
    (an all-gather's kernel is not elementwise work)."""
    cuda = torch.autograd.DeviceType.CUDA

    def event(name, start, end, device=cuda):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [event("nccl:all_reduce", 0, 3000),
              event("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(args)", 0, 3000),
              event("ncclDevKernel_AllGather_RING_LL(args)", 4000, 5000),
              event("void at::native::vectorized_elementwise_kernel<4>", 5000, 6000)]
    prof = SimpleNamespace(events=lambda: events, key_averages=lambda: [])
    assert cs.nccl_device_ms(prof) == pytest.approx(4.0)
    assert cs.kernel_class("ncclDevKernel_AllGather_RING_LL(args)") == "nccl"
    out = cs.summarize(prof, wall_s=0.01, steps=1)
    assert out["device_events"] == 3 and out["device_busy_ms"] == pytest.approx(5.0)
    assert out["device_ms_by_class"] == {"nccl": pytest.approx(4.0),
                                         "elementwise": pytest.approx(1.0)}
