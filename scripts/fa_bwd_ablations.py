#!/usr/bin/env python3
"""Times this tree's flash-attention backward beside text-patched variants
of it and, optionally, another tree's build, on one CUDA card, in one
process, in turns.

    python3 scripts/fa_bwd_ablations.py [--against OTHER_CSRC] [NAME ...]

Run from the repository root.  Each ablation is this tree's
``src/repro_torch/kernels/csrc`` copied to ``build/fa_bwd_ablations/<NAME>/``
with text edits of ``flash_attention.cu`` (:data:`ABLATIONS`; all of them
without names, none with ``--against`` alone); ``--against`` adds another
tree's ``csrc/`` whose ``flash_attention_bwd`` has the same C entry point
(an older backward takes the workspace as its delta).  Every build is
loaded through ``repro_torch.kernels._build`` and called through the port's
``flash_attention_bwd``, pointed at one build or another in turns (this
tree, the others, then back), on the O and LSE of this tree's forward:

* at every case of ``chip_smoke.FA_BWD_CASES`` of 1000 rows or more, one
  JSON line with each build's two times (CUDA events around 10 calls), its
  largest error against the plain backward (``chip_smoke.grad_row_err``),
  ``torch.autograd.grad`` through SDPA and the card's bound;
* gemma3-1b's train step, its 26 calls (global and window layers), timed
  together the same way: one JSON line.

The ablations that drop work compute another function: their errors are
large by design, and their times say what the rest costs without that
work; the last six are variants of the same function.  Then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import fa_ablations as fab  # noqa: E402
from kernel_against import using  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "fa_bwd_ablations"

#: name -> (what it shows, [(text, replacement), ...]) in flash_attention.cu
ABLATIONS = {
    "no-inner-loads": (
        "the block's Q, dO, LSE and delta tiles loaded for the first two "
        "items only: each later item reuses a stale stage",
        [("        mbar_wait(smem_addr(&empty[stage]), ((i / T::kStages) & 1) ^ 1);\n"
          "        load_item(i, stage);",
          "        mbar_wait(smem_addr(&empty[stage]), ((i / T::kStages) & 1) ^ 1);\n"
          "        if (i < T::kStages) load_item(i, stage);\n"
          "        else mbar_arrive(smem_addr(&full[stage]));")]),
    "no-score-products": (
        "no S^T and dP^T products: their accumulators are 0",
        [("      issue_scores<D>(st, dpt, k_addr, s_v, sq, sdo, wg);",
          "      zero(st);\n      zero(dpt);")]),
    "no-grads": (
        "no mask, exponent and dS on the accumulators (P = S, dS = dP)",
        [("        grads<T::kScoreN>(st, dpt,", "        if (false) grads<T::kScoreN>(st, dpt,")]),
    "no-accumulate-products": (
        "no dV, dK and dQ products: their accumulators keep what they hold",
        [("          wgmma_rs(dv, pf[kk],", "          if (false) wgmma_rs(dv, pf[kk],"),
         ("          wgmma_rs(dk, dsf[kk],", "          if (false) wgmma_rs(dk, dsf[kk],"),
         ("          wgmma_ss<0, 1>(dv,", "          if (false) wgmma_ss<0, 1>(dv,"),
         ("          wgmma_ss<0, 1>(dk,", "          if (false) wgmma_ss<0, 1>(dk,"),
         ("          wgmma_ss<1, 1>(dq,", "          if (false) wgmma_ss<1, 1>(dq,")]),
    "no-score-stores": (
        "P^T and dS^T not written to shared memory (the products read stale tiles)",
        [("        store_scores<T::kScoreN>(smem + s_",
          "        if (false) store_scores<T::kScoreN>(smem + s_")]),
    "no-dq-part": (
        "the dQ part not written to the stage (the writer copies stale bytes)",
        [("      if (wg < T::kDqParts) {\n        float4* out",
          "      if (false) {\n        float4* out")]),
    "no-dq-chain": (
        "dQ's parts neither waited for nor stored or added (the consumers "
        "still leave them in the stage)",
        [("        if (turn > 0) {\n          while (ld_acquire(counter) < turn) __nanosleep(32);",
          "        if (false) {\n          while (ld_acquire(counter) < turn) __nanosleep(32);"),
         ("          bulk_store(dst, src, T::kStageBytes);", "          (void)dst;")]),
    "no-l2-traffic": (
        "neither the inner loads nor the dQ hand-off (no-inner-loads and "
        "no-dq-chain together): a step's traffic to L2 removed",
        None),
    "no-dq-wait": (
        "dQ's parts added without waiting for their turn (the adds' order, "
        "so the bits, vary)",
        [("          while (ld_acquire(counter) < turn) __nanosleep(32);\n", "")]),
    "dq-stores": (
        "dQ's parts stored, not added: the same bytes without the reduction",
        [("          bulk_reduce_add_f32(dst, src, T::kStageBytes);",
          "          bulk_store(dst, src, T::kStageBytes);")]),
    "release-deferred": (
        "a variant, the same function: the dQ writer checks a copy's "
        "completion and raises its counter only after issuing the next "
        "item's copy",
        [("      for (int i = 0; i < n_items; ++i) {\n        const int stage = i % T::kStages;\n"
          "        const int q0 = tile_of(i) * kBM;",
          "      int* held = nullptr;\n      int held_turn = 0;\n"
          "      for (int i = 0; i < n_items; ++i) {\n        const int stage = i % T::kStages;\n"
          "        const int q0 = tile_of(i) * kBM;"),
         ("        bulk_wait();\n        fence_proxy_global();\n        __threadfence();\n"
          "        st_release(counter, turn + 1);\n      }\n"
          "      mbar_arrive(smem_addr(&drained));",
          "        if (held != nullptr) {\n"
          "          asm volatile(\"cp.async.bulk.wait_group 1;\\n\" ::: \"memory\");\n"
          "          fence_proxy_global();\n          __threadfence();\n"
          "          st_release(held, held_turn + 1);\n        }\n"
          "        held = counter;\n        held_turn = turn;\n      }\n"
          "      bulk_wait();\n      fence_proxy_global();\n      __threadfence();\n"
          "      st_release(held, held_turn + 1);\n"
          "      mbar_arrive(smem_addr(&drained));")]),
    "no-head-split": (
        "a variant, the same function: a KV group's heads always in one "
        "block, however long the longest key tile's block runs",
        [("  prm.split = split_heads<D>(seq_len, n_kt, batch, hq, hkv, causal, window, "
          "device_sms[dev]);", "  prm.split = 1;")]),
    "no-sections": (
        "a variant, the same function: tickets key tile by key tile over "
        "every (b, KV head) pair, however far apart in time the key tiles "
        "of one pair then add to its dQ tiles",
        [("  if (pairs * prm.split > device_sms[dev] / 2)\n", "  if (false)\n")]),
    "ring-3": (
        "a variant, the same function: a 3-stage Q/dO ring up to D 128 "
        "(178 KB of shared memory at D 128)",
        [("static constexpr int kStages = 2; ", "static constexpr int kStages = kSplit ? 2 : 3; ")]),
    "ascending-queries": (
        "a variant, the same function: each block walks its query tiles "
        "first to last (the hand-off's successor then reaches a tile first)",
        [("const auto tile_of = [&](int i) { return qt_lo + n_t - 1 - i % n_t; };",
          "const auto tile_of = [&](int i) { return qt_lo + i % n_t; };")]),
    "key-rows-64": (
        "a variant, the same function: D 128 (and 80) in D 256's layout, 64 "
        "key rows a block, columns split over the consumers",
        [("static constexpr bool kSplit = kDPad > 128;",
          "static constexpr bool kSplit = kDPad >= 128;")]),
}


ABLATIONS["no-l2-traffic"] = (ABLATIONS["no-l2-traffic"][0],
                              ABLATIONS["no-inner-loads"][1] + ABLATIONS["no-dq-chain"][1])


def cases() -> list[tuple]:
    """(name, B, S, Hq, Hkv, D, causal, window) of the card script's
    backward cases of 1000 rows or more."""
    return [case[:8] for case in cs.FA_BWD_CASES if case[2] >= 1000]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help=f"ablations (default all): {list(ABLATIONS)}")
    ap.add_argument("--against", type=Path, default=None,
                    help="another tree's src/repro_torch/kernels/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fa_bwd_ablations: no CUDA device")
    dev = torch.device("cuda")
    names = args.names or ([] if args.against else list(ABLATIONS))
    libs = fab.builds(names, fa, ablations=ABLATIONS, out=OUT)
    if args.against:
        _build.build_log.pop("flash_attention.cu", None)
        libs["other"] = fa.bind(_build.library("flash_attention", args.against.resolve()))
        cs.emit("build", build="other", csrc=str(args.against),
                flags=cs.ptxas_flags(_build.build_log.get("flash_attention.cu", "")))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    order = list(libs) + list(reversed(libs))

    def normal(b, s, h, d):
        return torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)

    for name, b, s, hq, hkv, d, causal, window in cases():
        q, k, v, do = (normal(b, s, h, d) for h in (hq, hkv, hkv, hq))
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                            window=window)
        ms = {ver: [] for ver in libs}
        err = {}
        for ver in order:
            with using(fa, libs[ver]):
                def call():
                    return fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                  causal=causal, window=window)
                if ver not in err:
                    got = call()
                    torch.cuda.synchronize()
                    err[ver] = max(cs.grad_row_err(a, w)[0] for a, w in zip(got, want))
                ms[ver].append(cs.time_ms(call, 10))
        bound_ms, bound_by = cs.bound(*cs.attention_bwd_floor_ms(
            b, s, hq, hkv, d, causal, window))
        cs.emit("bwd_ablation", case=name, shape=[b, s, hq, hkv, d], causal=causal,
                window=window, ms=ms, max_abs_err=err,
                library_ms=cs.time_ms(cs.sdpa_grad_call(q, k, v, do, causal, window), 10),
                bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, do, out, lse, want

    # gemma3-1b's train step: one backward call a layer
    cfg = get("gemma3-1b")
    windows = [cfg.window if kind == "swa" else 0 for kind in cfg.layer_types]
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    q, k, v, do = (normal(b, s, h, cfg.head_dim)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads, cfg.n_heads))
    saved = {w: fa.flash_attention_with_lse(q, k, v, window=w) for w in set(windows)}
    ms = {ver: [] for ver in libs}
    for ver in order:
        with using(fa, libs[ver]):
            ms[ver].append(cs.time_ms(lambda: [fa.flash_attention_bwd(
                q, k, v, *saved[w], do, window=w) for w in windows], 5))
    floors = [cs.attention_bwd_floor_ms(b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                        True, w) for w in windows]
    bound_ms, bound_by = cs.bound(sum(f[0] for f in floors), sum(f[1] for f in floors))
    lib_calls = [cs.sdpa_grad_call(q, k, v, do, True, w) for w in windows]
    cs.emit("bwd_ablation_train_mix", layers=len(windows),
            shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], ms=ms,
            library_ms=cs.time_ms(lambda: [c() for c in lib_calls], 5),
            bound_ms=bound_ms, bound_by=bound_by)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
