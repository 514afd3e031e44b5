#!/usr/bin/env python3
"""Times ablations of this tree's SSD-scan kernels beside them, on one
CUDA card, in one process.

    python3 scripts/ssd_ablations.py [NAME ...]

Run from the repository root.  Each ablation is this tree's
``src/repro_torch/kernels/csrc`` copied to ``build/ssd_ablations/<NAME>/``
with text edits of ``ssd_scan.cu`` (:data:`ABLATIONS` for the forward
kernels, :data:`BWD_ABLATIONS` for the backward's; all of both without
names), built by ``fa_ablations.builds``.  Every build is loaded through
``repro_torch.kernels._build`` and called through the port's wrappers.
The forward's ablations run ``scripts/kernel_against.py ssd``'s cases: one
JSON line a case with each build's error against the plain versions and
the times of ``chunk_state`` and ``chunk_scan`` in turns (this tree, the
ablations, then back), beside the plain versions' times and each kernel's
bound.  The backward's run ``kernel_against.py ssd_bwd``'s shapes: each
build's error against ``ssd_scan_bwd_plain`` and the times of
``chunk_state_bwd``, ``chunk_scan_bwd`` and the whole backward in turns,
beside the bounds.  Every ablation drops work and so computes another
function: its errors are large by design, and its times say what the rest
of the kernels cost without that work.  Then the card's name and power
limit.
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

_HAND_OFF_WAIT = "    while (ld_acquire(flag) == 0) __nanosleep(64);\n"

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
        [(_HAND_OFF_WAIT, "")]),
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


#: name -> (what it shows, [(text, replacement), ...] in ssd_scan.cu[, the
#: heads a block of ssd_chunk_scan_bwd walks, in place of the wrapper's])
BWD_ABLATIONS = {
    "bwd-no-lo": (
        "the scan's backward with the tile pairs' products on the hi halves alone",
        [("          wgmma_rs(dx, a_lo[kk], d);\n", ""),
         ("          wgmma_ss<0, 1>(db, smem_desc(s_lo + kk * 32, 16, 1024), d, 1);\n", ""),
         ("            wgmma_ss<1, 1>(part[nb], smem_desc(s_lo + kk * 16 * 128, kBox, 1024), "
          "d, 1);\n", "")]),
    "bwd-products-only": (
        "the scan's backward without its elementwise work on a tile pair: no "
        "decay (exp), no column sums of R, no dC accumulation in shared memory",
        [("            const float e = __expf(j <= i && j < q ? cum[i] - cum[j] : "
          "-INFINITY);\n", "            const float e = 1.f;\n"),
         ("          col[k] += __shfl_xor_sync(0xffffffffu, col[k], 4);\n"
          "          col[k] += __shfl_xor_sync(0xffffffffu, col[k], 8);\n"
          "          col[k] += __shfl_xor_sync(0xffffffffu, col[k], 16);\n", ""),
         ("          add_to_tile<kNPad>(tile, part[0], row0, col0);\n", ""),
         ("        add_to_tile<kNPad>(tile, part[kNB - 1], row0, 64 * (kNB - 1) + col0);\n",
          "")]),
    "bwd-no-stage-loads": (
        "the scan's backward without the TMA copies of C_I and dy_I (the "
        "barriers still turn)",
        [("            mbar_expect_tx(sf, (kNB + 1) * kBox);\n"
          "            for (int nb = 0; nb < kNB; ++nb)\n"
          "              tma_load_5d(s_c + nb * kBox, &map_c, sf, nb * 64, g, I * kTile, c, b);\n"
          "            tma_load_5d(s_dy, &map_dy, sf, 0, h, I * kTile, c, b);\n",
          "            mbar_arrive(sf);\n")]),
    "bwd-no-planes": (
        "the scan's backward without storing prev and G into the planes as hi "
        "+ lo parts (their products read whatever the planes hold)",
        [("          pl.store(hi, lo, t);\n", "")]),
    "bwd-one-head-a-block": (
        "the scan's backward with one head a block: no sum of dB and dC over "
        "heads on chip (a slice a head)",
        [], 1),
    "bwd-no-hand-off-wait": (
        "the backward's state pass without waiting on the chunk after (G read "
        "as it is; the forward's state pass alike)",
        [(_HAND_OFF_WAIT, "")]),
}


def bwd_cases(libs: dict, dev) -> None:
    """This tree's build and the backward's ablations in ``libs`` at
    ``kernel_against.SSD_BWD_SHAPES``: errors against the plain backward,
    then each kernel's and the whole backward's times in turns."""
    kssd = ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    turns = (*libs, *reversed(libs))
    rep_of = kssd.bwd_heads_per_block

    def heads(ver):   # the wrapper's heads a block, or the ablation's
        fixed = BWD_ABLATIONS.get(ver, (None, None))[2:]
        return (lambda h, g: fixed[0]) if fixed else rep_of

    for name, b, s, h, p, g, n, chunk in ka.SSD_BWD_SHAPES:
        x, la, bm, cm, _ = cs.ssd_inputs(gen, dev, b, s, h, p, g, n, False)
        dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
        q = min(chunk, s)
        prev, _ = kssd.chunk_state(x, la, bm, chunk=chunk)
        gnext, _, d_total = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk)
        want = kssd.ssd_scan_bwd_plain(x, la, bm, cm, prev, dy, q)[:4]
        calls = {
            "state_bwd": lambda: kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk),
            "scan_bwd": lambda: kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext,
                                                    d_total, chunk=chunk),
            "backward": lambda: kssd.ssd_scan_bwd(x, la, bm, cm, prev, dy, chunk=chunk)}
        errs = {}
        out = {part: {"ms": {ver: [] for ver in libs}} for part in calls}
        try:
            for ver in libs:
                kssd.bwd_heads_per_block = heads(ver)
                with ka.using(kssd, libs[ver]):
                    got = calls["backward"]()
                torch.cuda.synchronize()
                errs[ver] = {what: cs.slab_rel_err(a, w, (0, 2))
                             for what, a, w in zip(("dx", "dlog_a", "dB", "dC"), got, want)}
            for part, call in calls.items():
                for ver in turns:
                    kssd.bwd_heads_per_block = heads(ver)
                    with ka.using(kssd, libs[ver]):
                        out[part]["ms"][ver].append(cs.time_ms(call, 10))
        finally:
            kssd.bwd_heads_per_block = rep_of
        slices = h // rep_of(h, g) // g
        for part, floor in (("state_bwd", "chunk_state_bwd"),
                            ("scan_bwd", "chunk_scan_bwd"), ("backward", "function")):
            out[part]["bound_ms"], out[part]["bound_by"] = cs.bound(
                *cs.ssd_bwd_floor_ms(b, s, h, p, g, n, chunk, floor, slices=slices))
        cs.emit("ssd_bwd_ablations", case=name, shape=[b, s, h, p, g, n, q],
                max_bh_rel_err=errs, **out)
        del x, la, bm, cm, dy, prev, gnext, d_total, want, got
        torch.cuda.empty_cache()


def main() -> None:
    names = sys.argv[1:] or [*ABLATIONS, *BWD_ABLATIONS]
    unknown = [n for n in names if n not in ABLATIONS and n not in BWD_ABLATIONS]
    if unknown:
        raise SystemExit(f"unknown ablations {unknown}; known: "
                         f"{[*ABLATIONS, *BWD_ABLATIONS]}")
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablations: no CUDA device")
    dev = torch.device("cuda")
    fwd = [n for n in names if n in ABLATIONS]
    bwd = [n for n in names if n in BWD_ABLATIONS]
    if fwd:
        ka.ssd_cases(fab.builds(fwd, ssd_scan, "ssd_scan.cu", ABLATIONS, OUT), dev)
    if bwd:
        edits = {k: v[:2] for k, v in BWD_ABLATIONS.items()}
        bwd_cases(fab.builds(bwd, ssd_scan, "ssd_scan.cu", edits, OUT), dev)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
