#!/usr/bin/env python3
"""Times ablations of this tree's two SSD-scan kernels beside them, on one
CUDA card, in one process.

    python3 scripts/ssd_ablations.py [NAME ...]

Run from the repository root.  Each ablation is this tree's
``src/repro_torch/kernels/csrc`` copied to ``build/ssd_ablations/<NAME>/``
with text edits of ``ssd_scan.cu`` (:data:`ABLATIONS`; all of them without
names), built by ``fa_ablations.builds``.  Every build is loaded through
``repro_torch.kernels._build`` and
called through the port's wrappers, as ``scripts/kernel_against.py ssd``
does, whose cases it runs: one JSON line a case with each build's error
against the plain versions and the times of ``chunk_state`` and
``chunk_scan`` in turns (this tree, the ablations, then back), beside the
plain versions' times and each kernel's bound.  Every ablation drops work
and so computes another function: its errors are large by design, and its
times say what the rest of the kernels cost without that work.  Then the
card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import fa_ablations as fab  # noqa: E402
import kernel_against as ka  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

OUT = ROOT / "build" / "ssd_ablations"

_STATE_LOADS = '''    mbar_expect_tx(bar, kStage);
    tma_load_5d(dst, &map_x, bar, 0, h, t * kTile, c, b);
    for (int nb = 0; nb < kNB; ++nb)
      tma_load_5d(dst + (1 + nb) * kBox, &map_b, bar, nb * 64, g, t * kTile, c, b);'''
_SCAN_LOADS = '''        mbar_expect_tx(bar, (2 * kNB + 1) * kBox);
        for (int nb = 0; nb < kNB; ++nb) {
          tma_load_5d(s_c + (t * kNB + nb) * kBox, &map_c, bar, nb * 64, g,
                      t * kTile, c, b);
          tma_load_5d(s_b + (t * kNB + nb) * kBox, &map_b, bar, nb * 64, g,
                      t * kTile, c, b);
        }
        tma_load_5d(s_x + t * kBox, &map_x, bar, 0, h, t * kTile, c, b);'''

#: name -> (what it shows, [(text, replacement), ...]) in ssd_scan.cu
ABLATIONS = {
    "no-lo": (
        "the hi halves alone: one product where the fp32 operand is split",
        [("      wgmma_rs(acc, a_lo[kk], desc);\n", ""),
         ("          wgmma_ss(s, da, smem_desc(s_lo + nb * kBox + kk * 32, 16, 1024), 1);\n",
          ""),
         ("    wgmma_rs(y, a_lo[kk], dx);\n", "")]),
    "no-hand-off-wait": (
        "chunk_state without waiting on the chunk before (prev read as it is)",
        [("    while (ld_acquire(flag) == 0) __nanosleep(64);\n", "")]),
    "no-loads": (
        "everything but the TMA copies of x, B and C (the barriers still turn)",
        [(_STATE_LOADS, "    mbar_arrive(bar);"),
         (_SCAN_LOADS, "        mbar_arrive(bar);")]),
    "no-decay": (
        "chunk_scan without the masked decay (no exp)",
        [("      decay_scores(s, cum, row, col, q);\n", ""),
         ("        decay_scores(s, cum, row, u * kTile + col, q);\n", "")]),
    "no-intra-products": (
        "chunk_scan without the wgmmas of the intra-chunk term",
        [("      issue_scores<kNB>(s, c_t, s_b);\n", ""),
         ("        issue_scores<kNB>(s, c_t, s_b + u * kNB * kBox);\n", ""),
         ("        issue_sx(y, a_hi, a_lo, s_x + (u - 1) * kBox);\n", ""),
         ("      issue_sx(y, a_hi, a_lo, s_x + t * kBox);\n", "")]),
    "no-prev-loads": (
        "chunk_scan without reading prev_c (its conversion runs on zeros)",
        [("        v[i][0] = *reinterpret_cast<const float4*>(prev + p * N + n);\n"
          "        v[i][1] = *reinterpret_cast<const float4*>(prev + p * N + n + 4);\n",
          "")]),
    "no-y-store": (
        "chunk_scan without its TMA stores of y",
        [("        tma_store_5d(&map_y, c_t, 0, h, t * kTile, c, b);\n", "")]),
    "decay-no-exp": (
        "chunk_scan's decay without the exponent (the masks and cum reads stay)",
        [("s[4 * j + r] *= __expf(e);", "s[4 * j + r] *= e;")]),
    "state-4-blocks": (
        "chunk_state held to 128 registers, four blocks an SM",
        [("constexpr int kStateBlocks = 3;", "constexpr int kStateBlocks = 4;")]),
}


def main() -> None:
    names = sys.argv[1:] or list(ABLATIONS)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablations: no CUDA device")
    dev = torch.device("cuda")
    ka.ssd_cases(fab.builds(names, ssd_scan, "ssd_scan.cu", ABLATIONS, OUT), dev)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
