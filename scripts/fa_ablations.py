#!/usr/bin/env python3
"""Times ablations of this tree's flash-attention kernel beside it, on one
CUDA card, in one process.

    python3 scripts/fa_ablations.py [NAME ...]

Run from the repository root.  Each ablation is this tree's
``src/repro_torch/kernels/csrc`` copied to ``build/fa_ablations/<NAME>/``
with one text edit of ``flash_attention.cu`` (:data:`ABLATIONS`; all of them
without names).  Every build is loaded through ``repro_torch.kernels._build``
and called through the port's wrapper, as ``scripts/kernel_against.py fa``
does, whose cases (plus causal-free ones at deepseek-7b's and gemma3-1b's
shapes) it runs: one JSON line a case with each build's error against the
plain version and its time in turns (this tree, the ablations, then back),
beside ``scaled_dot_product_attention`` and the card's bound.  The
ablations that drop work (``no-softmax``, ``no-kv-loads``) compute another
function: their errors are large by design, and their times say what the
rest of the kernel costs without that work.  Then the card's name and
power limit.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import kernel_against as ka  # noqa: E402
from repro_torch.kernels import _build, flash_attention  # noqa: E402

OUT = ROOT / "build" / "fa_ablations"

_KV_LOAD = '''        mbar_expect_tx({f}, T::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(s_{x} + stage * T::kKVBytes + c * T::kKVBox, &map_{x}, {f},
                      c * kChunk, h_kv, t * kBK, b);'''

#: name -> (what it shows, [(text, replacement), ...]) in flash_attention.cu
ABLATIONS = {
    "no-softmax": (
        "the products and the loads alone: no mask, no softmax (P = S)",
        [("online_softmax<kBK>(s, m, l, alpha, scale_log2);",
          "alpha[0] = alpha[1] = 1.f;"),
         ("if (needs_mask(", "if (false && needs_mask(")]),
    "no-kv-loads": (
        "everything but the K and V copies (the ring's barriers still turn)",
        [(_KV_LOAD.format(f="kf", x="k"), "        mbar_arrive(kf);"),
         (_KV_LOAD.format(f="vf", x="v"), "        mbar_arrive(vf);")]),
    "ping-pong-everywhere": (
        "the consumers take turns at D 256 too",
        [("static constexpr bool kPingPong = kDPad <= 128;",
          "static constexpr bool kPingPong = true;")]),
    "no-ping-pong": (
        "the consumers never take turns",
        [("static constexpr bool kPingPong = kDPad <= 128;",
          "static constexpr bool kPingPong = false;")]),
    "three-stages": (
        "a 3-stage K/V ring up to D_pad 128 (2 at D 256, where 3 do not fit)",
        [("static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;",
          "static constexpr int kSmem =\n"
          "      kQBytes + 2 * (kDPad >= 256 ? 2 : 3) * kKVBytes + 1024;"),
         ("  using T = Tiles<D>;\n  constexpr int kBK = T::kBK;",
          "  using T = Tiles<D>;\n"
          "  constexpr int kStages = T::kDPad >= 256 ? 2 : 3;\n"
          "  constexpr int kBK = T::kBK;")]),
    "rescale-always": (
        "O rescaled on every tile, even when no row's max moved",
        [("  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;\n",
          "")]),
    "one-section": (
        "every (batch, head) pair in one section: blocks do not keep K and V in L2",
        [("constexpr long long kL2Budget = 20LL << 20;",
          "constexpr long long kL2Budget = 1LL << 50;")]),
}


def ablated(name: str, source: str = "flash_attention.cu",
            ablations: dict = ABLATIONS, out: Path = OUT) -> Path:
    """A copy of this tree's csrc/ under ``out`` with ablation ``name``'s
    edits of ``source``, the other sources left out; raises if an edit's
    text is not in the source."""
    csrc = out / name
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / source
    text = src.read_text()
    for old, new in ablations[name][1]:
        if old not in text:
            raise ValueError(f"ablation {name}: text not in {source}:\n{old}")
        text = text.replace(old, new)
    src.write_text(text)
    for other in csrc.glob("*.cu"):   # build only the kernel under test
        if other.name != source:
            other.unlink()
    return csrc


def builds(names: list[str], module, source: str = "flash_attention.cu",
           ablations: dict = ABLATIONS, out: Path = OUT) -> dict:
    """This tree's build of ``source`` and one per ablation in ``names``,
    each bound by ``module.bind``; emits each ablation's ptxas flags."""
    unknown = [n for n in names if n not in ablations]
    if unknown:
        raise SystemExit(f"unknown ablations {unknown}; known: {list(ablations)}")
    stem = source.removesuffix(".cu")
    libs = {"this": module.bind(_build.library(stem))}
    for name in names:
        csrc = ablated(name, source, ablations, out)
        _build.build_log.pop(source, None)
        libs[name] = module.bind(_build.library(stem, csrc))
        cs.emit("build", build=name, shows=ablations[name][0],
                flags=cs.ptxas_flags(_build.build_log.get(source, "")))
    return libs


def main() -> None:
    names = sys.argv[1:] or list(ABLATIONS)
    if not torch.cuda.is_available():
        raise SystemExit("fa_ablations: no CUDA device")
    dev = torch.device("cuda")
    libs = builds(names, flash_attention)
    cases = ka.fa_shapes() + [
        ("deepseek-7b bidirectional", 4, 2048, 32, 32, 128, False, [0]),
        ("gemma3-1b bidirectional", 4, 2048, 4, 1, 256, False, [0]),
        ("hymba-1.5b swa", 4, 2048, 25, 5, 64, True, [1024]),
    ]
    ka.fa_cases(libs, dev, cases)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
