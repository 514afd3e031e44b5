#!/usr/bin/env python3
"""Times this tree's flash-attention backward kernels beside text-patched
variants of them and, optionally, another tree's build, on one CUDA card, in
one process, in turns.

    python3 scripts/fa_bwd_ablations.py [--against OTHER_CSRC] [NAME ...]

Run from the repository root.  Each ablation is this tree's
``src/repro_torch/kernels/csrc`` copied to ``build/fa_bwd_ablations/<NAME>/``
with text edits of ``flash_attention.cu`` (:data:`ABLATIONS`; all of them
without names); ``--against`` adds another tree's ``csrc/`` whose
``flash_attention_bwd`` has the same C entry point.  Every build is loaded
through ``repro_torch.kernels._build`` and called through the port's
``flash_attention_bwd``, pointed at one build or another in turns (this
tree, the others, then back), on the O and LSE of this tree's forward, at
gemma3-1b's global, window and ragged shapes and olmoe-1b-7b's (D 128): one
JSON line a case with each build's two times (CUDA events around 10 calls),
its largest error against the plain backward (``chip_smoke.grad_row_err``),
``torch.autograd.grad`` through SDPA and the card's bound.  The ablations
that drop work compute another function: their errors are large by design,
and their times say what the rest of the kernels costs without that work;
``key-rows-64`` is a variant of the same function.
Then the card's name and power limit.
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "fa_bwd_ablations"

#: name -> (what it shows, [(text, replacement), ...]) in flash_attention.cu
ABLATIONS = {
    "no-inner-loads": (
        "the products alone: each block loads its first inner tile only "
        "(K and V in dq; Q, dO, LSE and delta in dkv)",
        [("    if (i + 1 < n_tiles) {\n      load_kv(i + 1);",
          "    if (false) {\n      load_kv(i + 1);"),
         ("    if (i + 1 < n_items) {\n      load_item(i + 1);",
          "    if (false) {\n      load_item(i + 1);")]),
    "no-score-products": (
        "no S and dP products: their accumulators stay 0",
        [("      uint32_t bf[4];\n      ldsm_x4(bf, b_row + j * 8 * ld + k * 32);\n"
          "      mma16816(c[j], af, bf[0], bf[1]);\n"
          "      mma16816(c[j + 1], af, bf[2], bf[3]);",
          "      (void)b_row;"),
         ("    uint32_t af[4];\n    ldsm_x4(af, a_row + k * 32);\n#pragma unroll\n"
          "    for (int j = 0; j < kNt; j += 2) {",
          "#pragma unroll\n    for (int j = 0; j < kNt; j += 2) {")]),
    "no-accumulate-products": (
        "no dQ, dK and dV products (their accumulators stay 0)",
        [("  for (int k = 0; k < kDepth / 16; ++k) {\n    uint32_t af[4];\n"
          "    ldsm_x4(af, a_row + k * 32);\n#pragma unroll\n"
          "    for (int j = 0; j + 1 < kNt; j += 2) {",
          "  for (int k = 0; k < 0; ++k) {\n    uint32_t af[4];\n"
          "    ldsm_x4(af, a_row + k * 32);\n#pragma unroll\n"
          "    for (int j = 0; j + 1 < kNt; j += 2) {")]),
    "key-rows-64": (
        "a variant, the same function: 64 key rows a dkv block at D 256 too "
        "(half the Q and dO loads, twice the dK and dV registers a thread)",
        [("static constexpr int kKeyRows = D >= 256 ? 32 : 64;",
          "static constexpr int kKeyRows = 64;")]),
}

#: name, B, S, Hq, Hkv, D, causal, window
CASES = [
    ("gemma3-1b global", 4, 2048, 4, 1, 256, True, 0),
    ("gemma3-1b swa", 4, 2048, 4, 1, 256, True, 512),
    ("gemma3-1b ragged", 4, 1000, 4, 1, 256, True, 0),
    ("olmoe-1b-7b D128", 4, 2048, 16, 16, 128, True, 0),
]


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
    for name, b, s, hq, hkv, d, causal, window in CASES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
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
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
