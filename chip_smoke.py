#!/usr/bin/env python3
"""Drives the PyTorch port's serving path on one CUDA card and checks it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero and prints no result line:

1. environment: card name and power limit, torch / CUDA / nvcc versions,
   the TF32 switches;
2. build: the CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc);
3. kernels against their plain versions at the main path's shapes
   (gemma3-1b prefill, plus h2o-danube and deepseek head dims), with the
   kernel's, the plain version's and one PyTorch call's times and the
   card's bound for the same work; the error is gated both absolutely and
   relative to each output row's largest element;
4. prefill: full-width gemma3-1b ``forward`` on a (4, 2048) batch, with
   the launch counts reset just before it and read just after;
5. correctness at full width: prefill against teacher-forced decode over
   a prompt of several key tiles, and a 600-token forward (past the
   window of 512) against the same model with the kernel's plain version
   in its place; then the card's forward against the CPU's on a small
   config;
6. serve: ``ServeEngine`` answers 8 requests of 16 new tokens each;
7. profile: one prefill and a window of decode steps under
   ``torch.profiler``: device busy time and idle share, kernel launches,
   host synchronisations and device time by kernel class.

Then the kernels line, the card line and, last, the result line.  There is
no CPU mode: without a CUDA device the script exits with an error.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
KERNEL_TOL = 2e-2             # bf16, as the reference's kernel tests
# The same error relative to each output row's largest |element|: both
# sides round to bf16, so a row's largest element differs by at most one
# bf16 step (2**-7 of it at worst), and the kernel's bf16 probabilities add
# noise of ~2**-9 of the row's scale; 2e-2 is 2.5 steps at worst.  Unlike
# the absolute bound it holds the late rows too, whose |out| is ~0.05: a
# window edge one key off in a 512-key row moves such a row by ~4%.
ROW_REL_TOL = 2e-2
CPU_GPU_TOL = 5e-2            # bf16 logits of |x| < 2: a few bf16 steps
# Two full-width model paths that compute the same logits but round at
# different places, both in bf16: prefill (kernel: probs rounded to bf16
# inside the tile loop) against teacher-forced decode (plain attention
# over the bf16 cache), and the kernel's forward against the same forward
# with the plain attention.  Each layer leaves differences of a few bf16
# steps (2**-8 relative) in the residual stream, which 26 layers and the
# 1152-wide unembedding carry to the logits.  Bounds, relative to the
# logits' standard deviation: 0.05 for the mean |difference| (an error of
# ~10 bf16 steps of a logit of one std), 0.25 for the max over all
# positions x 262144 logits (the far tail of that error); and the argmax
# must agree wherever the top-2 margin is more than twice the largest
# difference.
CONSISTENCY_MAX_REL = 0.25
CONSISTENCY_MEAN_REL = 0.05
CONSISTENCY_PROMPT = 160      # 3 key tiles of 64: the online softmax runs
WINDOW_CHECK_SEQ = 600        # past gemma3-1b's window of 512
PROFILE_DECODE_STEPS = 8
#: host-side runtime calls that launch a kernel or wait for the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:90"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` runs."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mask_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows: the work a kernel call must do."""
    q = np.arange(s, dtype=np.int64)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, np.int64)
    return int((hi - lo + 1).sum())


def attention_floor_ms(b, s, hq, hkv, d, causal, window) -> tuple[float, float]:
    """(ms for its tensor-core operations, ms for its bytes) on the card:
    4·B·Hq·D FLOPs per allowed (q, k) pair; Q, K, V read and O written
    once, in bf16."""
    flops = 4 * b * hq * d * mask_pairs(s, causal, window)
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bound(ops_ms: float, bytes_ms: float) -> tuple[float, str]:
    """The least time for the work, and what sets it."""
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def row_rel_err(out: torch.Tensor, want: torch.Tensor) -> float:
    """max over (b, s, h) rows of max_d |out - want| / max_d |want|."""
    o, w = out.float(), want.float()
    return ((o - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)).max().item()


def logits_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far two (positions, vocab) logit tables are apart, relative to
    the spread of ``want``; raises past the CONSISTENCY bounds."""
    diff = (got - want).abs()
    spread = want.std().item()
    top2 = want.topk(2, dim=-1).values
    agree = want.argmax(-1) == got.argmax(-1)
    decisive = top2[:, 0] - top2[:, 1] > 2 * diff.max()
    out = {
        "max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
        "logit_std": spread, "max_rel_to_std": diff.max().item() / spread,
        "mean_rel_to_std": diff.mean().item() / spread,
        "argmax_agree": int(agree.sum()), "positions": int(agree.numel()),
        "decisive_positions": int(decisive.sum()),
        "bound_max_rel": CONSISTENCY_MAX_REL, "bound_mean_rel": CONSISTENCY_MEAN_REL,
    }
    if not (out["max_rel_to_std"] <= CONSISTENCY_MAX_REL
            and out["mean_rel_to_std"] <= CONSISTENCY_MEAN_REL
            and bool(agree[decisive].all())):
        raise AssertionError(f"logits disagree: {out}")
    return out


def kernel_class(name: str) -> str:
    """A coarse class of a device event in a profile, by its name."""
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "softmax" in low or "argmax" in low:
        return "reduce"
    return "elementwise"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize(prof, wall_s: float, steps: int) -> dict:
    """One profiled window: host wall time (ending in a synchronise), the
    device's busy time (union of its kernel and copy intervals) and idle
    share, kernel launches and host synchronisations, and device time by
    kernel class and by kernel name."""
    device, launches, syncs = [], 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(e)
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif e.name in SYNC_CALLS:
            syncs += 1
    busy_ms = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    by_class: dict[str, float] = collections.Counter()
    by_name: dict[str, float] = collections.Counter()
    for e in device:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_class[kernel_class(e.name)] += ms
        by_name[e.name[:80]] += ms
    wall_ms = wall_s * 1e3
    return {
        "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if device else None,
        "device_events": len(device), "kernel_launches": launches,
        "host_syncs": syncs,
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda x: -x[1])),
        "top_kernels_ms": dict(by_name.most_common(12)),
    }


def profiled(fn, steps: int) -> dict:
    """``summarize`` of ``steps`` calls of ``fn`` under the profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(prof, wall, steps)


def sdpa_call(q, k, v, causal, window):
    """One PyTorch call for the same attention (K, V expanded beforehand);
    a yardstick for the kernel only, never used by the port."""
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2)
    s = q.shape[1]
    if window > 0:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = (i - j < window) & ((i >= j) if causal else True)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not under {src}")
    sys.path.insert(0, str(src))

    from repro_torch import bridge
    from repro_torch.configs import get, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model, compute_copy, synthetic_batch
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device()
    card = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    emit("environment", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- 2. build ----------------------------------------------------------
    build_s = _build.build()
    ptxas = [line.strip() for line in _build.build_log.splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=build_s, source=FA_SOURCE, ptxas=ptxas)

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(b, s, hq, hkv, d):
        return [torch.randn((b, s, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
                for h in (hq, hkv, hkv)]

    cases = [  # name, B, S, Hq, Hkv, D, causal, window
        ("gemma3-1b global", 4, 2048, 4, 1, 256, True, 0),
        ("gemma3-1b swa", 4, 2048, 4, 1, 256, True, 512),
        ("gemma3-1b swa S=window", 4, 512, 4, 1, 256, True, 512),
        ("gemma3-1b ragged", 4, 1000, 4, 1, 256, True, 0),
        ("gemma3-1b ragged swa", 4, 1000, 4, 1, 256, True, 512),
        ("h2o-danube-1.8b", 4, 2048, 32, 8, 80, True, 4096),
        ("deepseek-7b", 4, 2048, 32, 32, 128, True, 0),
        ("bidirectional D128", 2, 200, 4, 2, 128, False, 0),
        ("smoke D32 window", 2, 40, 2, 1, 32, True, 16),
    ]
    max_err = 0.0
    for name, b, s, hq, hkv, d, causal, window in cases:
        q, k, v = qkv(b, s, hq, hkv, d)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        if not (err <= KERNEL_TOL and rel <= ROW_REL_TOL):
            raise AssertionError(f"flash_attention {name}: max |err| {err} "
                                 f"(tol {KERNEL_TOL}), row-relative {rel} "
                                 f"(tol {ROW_REL_TOL})")
        max_err = max(max_err, err)
        bound_ms, bound_by = bound(*attention_floor_ms(b, s, hq, hkv, d,
                                                       causal, window))
        emit("kernel_check", kernel="flash_attention", case=name,
             shape=[b, s, hq, hkv, d], causal=causal, window=window,
             max_abs_err=err, tol=KERNEL_TOL, max_row_rel_err=rel,
             row_rel_tol=ROW_REL_TOL,
             ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                   window=window), 20),
             plain_ms=time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, causal=causal, window=window), 3, 1),
             library_ms=time_ms(sdpa_call(q, k, v, causal, window), 20),
             bound_ms=bound_ms, bound_by=bound_by, nvidia_smi=card)
        del q, k, v, out, want

    # the work of one gemma3-1b prefill: one call per layer, at its window
    cfg = get("gemma3-1b")
    windows = [cfg.window if kind == "swa" else 0 for kind in cfg.layer_types]
    b, s = 4, 2048
    q, k, v = qkv(b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    lib_calls = [sdpa_call(q, k, v, True, w) for w in windows]
    floors = [attention_floor_ms(b, s, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, True, w) for w in windows]
    mix_bound_ms, mix_bound_by = bound(sum(f[0] for f in floors),
                                       sum(f[1] for f in floors))
    prefill_attn = {
        "ms": time_ms(lambda: [fa.flash_attention(q, k, v, window=w)
                               for w in windows], 10),
        "plain_ms": time_ms(lambda: [fa.flash_attention_plain(q, k, v, window=w)
                                     for w in windows], 2, 1),
        "library_ms": time_ms(lambda: [c() for c in lib_calls], 10),
        "bound_ms": mix_bound_ms, "bound_by": mix_bound_by,
    }
    emit("kernel_prefill_mix", kernel="flash_attention",
         layers=len(windows), shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         nvidia_smi=card, **prefill_attn)
    del q, k, v, lib_calls

    # -- 4. prefill: the main path, at full width -----------------------------
    model = Model(cfg, dev)
    params = compute_copy(cfg, model.init(seed=0))   # bf16 serving copy
    torch.cuda.synchronize()
    batch = synthetic_batch(cfg, b, s, gen, dev)
    fa.launches = 0
    with torch.inference_mode():
        logits = model.forward(params, batch)
    torch.cuda.synchronize()
    prefill_launches = fa.launches
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_attention {prefill_launches} "
                             f"times, want {cfg.n_layers}")
    if tuple(logits.shape) != (b, s, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    del logits
    times = []
    with torch.inference_mode():
        for _ in range(3):
            t0 = time.perf_counter()
            model.forward(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    prefill_s = float(np.median(times))
    emit("prefill", arch=cfg.name, batch=b, seq=s, launches=prefill_launches,
         seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)

    # -- 5. correctness ---------------------------------------------------------
    # (a) prefill (kernel) against teacher-forced decode (plain attention),
    # over a prompt of several key tiles
    prompt = synthetic_batch(cfg, 1, CONSISTENCY_PROMPT, gen, dev)["tokens"]
    with torch.inference_mode():
        fwd = model.forward(params, {"tokens": prompt})[0].float()
        cache = model.init_cache(1, CONSISTENCY_PROMPT)
        dec = []
        for t in range(prompt.shape[1]):
            lg, cache = model.decode_step(params, cache, prompt[:, t:t + 1])
            dec.append(lg[0].float())
    emit("prefill_decode_consistency", arch=cfg.name, prompt=CONSISTENCY_PROMPT,
         **logits_agreement(torch.stack(dec), fwd))
    del fwd, dec, cache

    # (a2) the kernel's forward against the same forward with the plain
    # attention in the kernel's place, past the window
    toks = synthetic_batch(cfg, 1, WINDOW_CHECK_SEQ, gen, dev)
    kernel = fa.flash_attention
    with torch.inference_mode():
        got = model.forward(params, toks)[0].float()
        fa.flash_attention = fa.flash_attention_plain
        try:
            want = model.forward(params, toks)[0].float()
        finally:
            fa.flash_attention = kernel
    emit("forward_vs_plain_attention", arch=cfg.name, seq=WINDOW_CHECK_SEQ,
         window=cfg.window, **logits_agreement(got, want))
    del got, want

    # (b) the card's forward (kernel) against the CPU's (plain path)
    small = get_smoke("gemma3-1b")
    sm_cpu = Model(small, "cpu")
    sp_cpu = sm_cpu.init(seed=1)
    sp_gpu = bridge.params_from_numpy(bridge.params_to_numpy(sp_cpu), dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, small.vocab_size, (2, 40)))
    with torch.inference_mode():
        want = sm_cpu.forward(sp_cpu, {"tokens": toks}).float()
        got = Model(small, dev).forward(sp_gpu, {"tokens": toks.to(dev)}).float().cpu()
    small_err = (got - want).abs().max().item()
    emit("small_forward_vs_cpu", arch=small.name, seq=40, max_abs=small_err,
         tol=CPU_GPU_TOL)
    if not small_err <= CPU_GPU_TOL:
        raise AssertionError(f"card vs CPU forward: {small_err} > {CPU_GPU_TOL}")

    # -- 6. serve -----------------------------------------------------------------
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(8):
        prompt_ids = rng.integers(0, cfg.vocab_size, rng.integers(2, 6)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt_ids, max_new=16))
    fa.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = fa.launches
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError(f"served {len(done)} requests: "
                             f"{[len(r.generated) for r in done]}")
    n_tok = sum(len(r.generated) for r in done)
    emit("serve", arch=cfg.name, requests=len(done), slots=4, max_len=1024,
         new_tokens=n_tok, final_pos=engine.cache["pos"], seconds=serve_s,
         decode_tokens_per_s=n_tok / serve_s,
         steps_per_s=engine.cache["pos"] / serve_s,
         flash_attention_launches=serve_launches, nvidia_smi=card)

    # -- 7. profile: where the time goes ------------------------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, batch), 1)
    emit("profile_prefill", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 4).tolist(), max_new=PROFILE_DECODE_STEPS + 8))
    for _ in range(4):                                      # warm-up
        engine.step()
    prof = profiled(engine.step, PROFILE_DECODE_STEPS)
    emit("profile_decode", arch=cfg.name, slots=4, max_len=1024, nvidia_smi=card,
         per_step={k: prof[k] / PROFILE_DECODE_STEPS for k in (
             "wall_ms", "device_busy_ms", "kernel_launches", "host_syncs")},
         **prof)

    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": prefill_launches,
        "max_abs_err": max_err, **prefill_attn,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
