#!/usr/bin/env python3
"""Where the grouped GEMM's backward kernels (``grouped_matmul_dx``,
``grouped_matmul_dw``) spend their cycles, phase by phase, on one CUDA card.

    python3 scripts/gmm_phases.py [--csrc OTHER_CSRC] [--variants NAME ...]

Run from the repository root.  Copies this tree's ``csrc/`` (or
``OTHER_CSRC``, another tree's ``src/repro_torch/kernels/csrc``, e.g. the
first design's, ``git archive 41d7246`` unpacked under ``build/``) to
``build/gmm_phases/`` with ``moe_gmm.cu`` text-patched: one consumer thread
and the producer thread of each block read ``clock64()`` at the boundaries
of their phases and add each phase's cycles, and their count of items, to a
device array that a C entry point of the copy reads back.  The patches are
chosen by the source's design (:data:`DESIGNS`: the texts of one set must
all be in it).  The phases:

* consumer (items: output tiles): ``full`` (waiting for a full stage),
  ``zero`` (dw: zeroing the rows of a stage past the expert's end, and the
  barrier after it), ``wgmma`` (issuing a k-step's products and waiting for
  the step before), ``drain`` (the tile's last products), ``epilogue``
  (the first design: rounding to bf16 into shared memory, the barriers,
  issuing the TMA stores; the redesign: rounding and storing from
  registers);
* producer (items: stages loaded): ``empty`` (waiting for a stage to be
  free), ``issue`` (finding the tile, issuing the loads).

At olmoe-1b-7b's training shapes (gate/up and down, T 65,536 rows of a
top-8 routing over 64 experts) it prints one JSON line a case and kernel:
each role's cycles an item and the share of each phase; the times by CUDA
events of the build, the instrumented build and each ``--variants`` build
(each design's variants: text patches of the build that drop work, so their
results are wrong by design and their times say what that work costs), in
turns; ``torch._grouped_mm`` and the dense ``torch.matmul`` with the same
FLOPs (a (T, K) by (K, N) product, all rows one group: what cuBLAS reaches
on this card, a yardstick only); the bound; and the SM clock and power
draw that ``nvidia-smi`` reads while the kernel runs for two seconds.  The
instrumented kernel is slower than the kernel (the clock reads); the
shares, not the cycles, carry over.  Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from kernel_against import gmm_bwd_calls, using  # noqa: E402
from repro_torch.kernels import _build, moe_gmm  # noqa: E402

OUT = ROOT / "build" / "gmm_phases"
CONSUMER = ["full", "zero", "wgmma", "drain", "epilogue"]
PRODUCER = ["empty", "issue"]
_SLOTS = 16   # a kernel's counters: consumer phases, items; producer at 8
KERNELS = {"dx": 0, "dw": 1}
#: name, T, d, f, E, top-k (the cases of ``kernel_against.py gmm_bwd``'s
#: olmoe rows)
CASES = [("olmoe-1b-7b gate/up", 65536, 2048, 1024, 64, 8),
         ("olmoe-1b-7b down", 65536, 1024, 2048, 64, 8)]

_HEAD = (
    "__device__ unsigned long long g_phase[2 * 16];\n"
    "#define PH(k) { const unsigned now_ = static_cast<unsigned>(clock64()); "
    "ph[k] += now_ - ph_t; ph_t = now_; }\n"
    "#define PH_DECL const bool ph_on = threadIdx.x == 0 || threadIdx.x == kConsumers * 128; "
    "unsigned ph[6] = {}; unsigned ph_t = static_cast<unsigned>(clock64()); "
    "unsigned n_items = 0;\n"
    "#define PH_FLUSH(kernel, base, n) if (ph_on) { _Pragma(\"unroll\") "
    "for (int k_ = 0; k_ < n; ++k_) "
    "atomicAdd(g_phase + kernel * 16 + base + k_, static_cast<unsigned long long>(ph[k_])); "
    "atomicAdd(g_phase + kernel * 16 + base + 7, static_cast<unsigned long long>(n_items)); }\n"
    "\nnamespace {\n")
_ENTRY = (
    'extern "C" {\n\n'
    "int gmm_phases(void* out, int reset) {\n"
    "  if (reset) { static const unsigned long long zeros[32] = {};\n"
    "    return cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros)); }\n"
    "  return cudaMemcpyFromSymbol(out, g_phase, 32 * sizeof(unsigned long long));\n"
    "}\n")

#: the first design (commit 41d7246): the forward's kernel template read
#: with w K-major for dx, a kernel of its own for dw
FIRST = [
    ("\nnamespace {\n", _HEAD),
    ('extern "C" {\n', _ENTRY),
    # declarations: after the warpgroup index, in both kernels
    ("  const int wg = tid / 128;\n\n  // One if/else on the warpgroup",
     "  const int wg = tid / 128;\n  PH_DECL\n\n  // One if/else on the warpgroup"),
    ("  const int wg = tid / 128;\n\n  if (wg == kConsumers) {\n    // -- producer: a stage is 64",
     "  const int wg = tid / 128;\n  PH_DECL\n\n  if (wg == kConsumers) {\n"
     "    // -- producer: a stage is 64"),
    # producers (both kernels): a load's wait for its stage
    ("          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kStages) & 1) ^ 1);\n",
     "          PH(1)\n          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kStages) & 1) ^ 1);\n"
     "          PH(0)\n          ++n_items;\n"),
    ("          }\n        }\n      }\n    }\n  } else {\n"
     "    // -- consumers: warpgroup wg owns rows [64 wg",
     "          }\n        }\n      }\n      PH(1)\n      PH_FLUSH(0, 8, 2)\n    }\n  } else {\n"
     "    // -- consumers: warpgroup wg owns rows [64 wg"),
    ("                        t.n0 + c * kChunkN, row);\n        }\n      }\n    }\n  } else {\n",
     "                        t.n0 + c * kChunkN, row);\n        }\n      }\n      PH(1)\n"
     "      PH_FLUSH(1, 8, 2)\n    }\n  } else {\n"),
    # dx's consumers (the forward's template)
    ("        mbar_wait(smem_addr(&full_bar[stage]), (it / kStages) & 1);\n"
     "        const uint32_t a = ring + stage * kStageBytes + wg * (64 * kBK * 2);\n",
     "        mbar_wait(smem_addr(&full_bar[stage]), (it / kStages) & 1);\n        PH(0)\n"
     "        const uint32_t a = ring + stage * kStageBytes + wg * (64 * kBK * 2);\n"),
    ("        if (ks > 0 && lane == 0)\n"
     "          mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n      }\n",
     "        if (ks > 0 && lane == 0)\n"
     "          mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n"
     "        PH(2)\n      }\n"),
    ("      if (lane == 0)\n"
     "        mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n",
     "      if (lane == 0)\n"
     "        mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n      PH(3)\n"),
    ("      }\n    }\n    if (tid % 128 == 0) bulk_wait();  // the buffer outlives the stores\n",
     "      }\n      PH(4)\n      ++n_items;\n    }\n    PH_FLUSH(0, 0, 5)\n"
     "    if (tid % 128 == 0) bulk_wait();  // the buffer outlives the stores\n"),
    # dw's consumers
    ("        mbar_wait(smem_addr(&full_bar[stage]), (it / kStages) & 1);\n"
     "        const uint32_t a = ring + stage * kStageBytes + wg * kWChunk;\n",
     "        mbar_wait(smem_addr(&full_bar[stage]), (it / kStages) & 1);\n        PH(0)\n"
     "        const uint32_t a = ring + stage * kStageBytes + wg * kWChunk;\n"),
    ("          fence_async_shared();\n          consumers_sync();\n        }\n",
     "          fence_async_shared();\n          consumers_sync();\n        }\n        PH(1)\n"),
    ("        if (row > t.start && lane == 0)\n"
     "          mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n      }\n",
     "        if (row > t.start && lane == 0)\n"
     "          mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n"
     "        PH(2)\n      }\n"),
    ("      if (t.end > t.start && lane == 0)\n"
     "        mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n",
     "      if (t.end > t.start && lane == 0)\n"
     "        mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));\n      PH(3)\n"),
    ("        bulk_commit();\n      }\n    }\n    if (tid % 128 == 0) bulk_wait();\n  }\n}\n",
     "        bulk_commit();\n      }\n      PH(4)\n      ++n_items;\n    }\n    PH_FLUSH(1, 0, 5)\n"
     "    if (tid % 128 == 0) bulk_wait();\n  }\n}\n"),
]

_DX = "grouped_matmul_dx_kernel(const"
_DW = "grouped_matmul_dw_kernel(const"

#: the redesign (4-stage rings, 2-block clusters sharing the larger operand
#: by multicast, each tile stored from registers): (text, replacement, the
#: kernel it is in)
CLUSTER = [
    ("\nnamespace {\n", _HEAD, ""),
    ('extern "C" {\n', _ENTRY, ""),
    *[edit + (kernel,) for kernel, k in ((_DX, 0), (_DW, 1)) for edit in [
        ("  const int wg = tid / 128;\n", "  const int wg = tid / 128;\n  PH_DECL\n"),
        # producer
        ("          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kBwdStages) & 1) ^ 1);\n",
         "          PH(1)\n"
         "          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kBwdStages) & 1) ^ 1);\n"
         "          PH(0)\n          ++n_items;\n"),
        ("      drain_ring(empty_bar, it);\n",
         f"      PH(1)\n      drain_ring(empty_bar, it);\n      PH(0)\n      PH_FLUSH({k}, 8, 2)\n"),
        # consumers
        ("        mbar_wait(smem_addr(&full_bar[stage]), (it / kBwdStages) & 1);\n",
         "        mbar_wait(smem_addr(&full_bar[stage]), (it / kBwdStages) & 1);\n        PH(0)\n"),
    ]],
    ("        if (ks > 0) release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n",
     "        if (ks > 0) release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n"
     "        PH(2)\n", _DX),
    ("      release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n"
     "      store_fragment(",
     "      release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n"
     "      PH(3)\n      store_fragment(", _DX),
    ("p.t.row_end, p.t.n0, n_dim);\n    }\n",
     "p.t.row_end, p.t.n0, n_dim);\n      PH(4)\n      ++n_items;\n    }\n"
     "    PH_FLUSH(0, 0, 5)\n", _DX),
    ("          fence_async_shared();\n          consumers_sync();\n        }\n",
     "          fence_async_shared();\n          consumers_sync();\n        }\n        PH(1)\n", _DW),
    ("          release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n      }\n",
     "          release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n"
     "        PH(2)\n      }\n", _DW),
    ("        release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n"
     "      // every row",
     "        release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);\n"
     "      PH(3)\n      // every row", _DW),
    ("                     t.m0 + wg * 64, m_dim, t.n0, n_dim);\n    }\n",
     "                     t.m0 + wg * 64, m_dim, t.n0, n_dim);\n      PH(4)\n"
     "      ++n_items;\n    }\n    PH_FLUSH(1, 0, 5)\n", _DW),
]

#: the redesign's variants: name -> (what it shows, edits)
CLUSTER_VARIANTS = {
    "no-loads": (
        "no TMA loads: the producer marks each stage full as it is",
        [("          mbar_expect_tx(full, kATile + chunks * kWChunk);\n",
          "          mbar_arrive(full);\n          if (chunks < 0) {\n", _DX),
         ("                          p.t.n0 + c * kChunkN, p.t.e);\n          }\n",
          "                          p.t.n0 + c * kChunkN, p.t.e);\n          }\n          }\n", _DX),
         ("          mbar_expect_tx(full, (a_boxes + chunks) * kWChunk);\n",
          "          mbar_arrive(full);\n          if (chunks < 0) {\n", _DW),
         ("                                  t.n0 + c * kChunkN, row, (1u << kCluster) - 1);\n",
          "                                  t.n0 + c * kChunkN, row, (1u << kCluster) - 1);\n"
          "          }\n", _DW)]),
    "no-clusters": (
        "one block a cluster: each loads all of its operands itself",
        [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")]),
    "3-stages": (
        "the ring at the first design's 3 stages",
        [("constexpr int kBwdStages = 4;", "constexpr int kBwdStages = 3;")]),
}

#: the first design's variants: name -> (what it shows, edits)
FIRST_VARIANTS = {
    "no-stage-out": (
        "no rounding into shared memory in the epilogue (the stores still run)",
        [("stage_out(acc, out_ptr, warp, lane);",
          "if (acc[0] == 1234.5f) stage_out(acc, out_ptr, warp, lane);")]),
    "no-loads": (
        "no TMA loads: the producer marks each stage full as it is",
        [("          mbar_expect_tx(full, kATile + chunks * kWChunk);\n"
          "          const uint32_t a = ring + stage * kStageBytes;\n"
          "          tma_load_2d(a, &map_x, full, ks * kBK, t.row0);\n",
          "          mbar_arrive(full);\n          if (chunks < 0) {\n"
          "          const uint32_t a = ring + stage * kStageBytes;\n"),
         ("                          t.n0 + c * kChunkN, ks * kBK, t.e);\n          }\n",
          "                          t.n0 + c * kChunkN, ks * kBK, t.e);\n          }\n          }\n"),
         ("          mbar_expect_tx(full, (a_boxes + chunks) * kWChunk);\n",
          "          mbar_arrive(full);\n          if (chunks < 0) {\n"),
         ("            tma_load_2d(a + kATile + c * kWChunk, &map_dy, full,\n"
          "                        t.n0 + c * kChunkN, row);\n",
          "            tma_load_2d(a + kATile + c * kWChunk, &map_dy, full,\n"
          "                        t.n0 + c * kChunkN, row);\n          }\n")]),
}

_NO_EPILOGUE = [
    ("stage_out(acc, out_ptr, warp, lane);",
     "if (acc[0] == 1234.5f) stage_out(acc, out_ptr, warp, lane);"),
    ("      if (row0 + 64 <= t.row_end) {", "      if (acc[1] == 1234.5f && row0 + 64 <= t.row_end) {"),
    ("      } else {\n        // the group ends inside these 64 rows",
     "      } else if (acc[2] == 1234.5f) {\n        // the group ends inside these 64 rows"),
    ("      if (tid % 128 == 0 && t.m0 + wg * 64 < m_dim) {",
     "      if (acc[1] == 1234.5f && tid % 128 == 0 && t.m0 + wg * 64 < m_dim) {"),
]
FIRST_VARIANTS |= {
    "no-epilogue": (
        "no epilogue (no rounding, no stores): the main loop alone",
        _NO_EPILOGUE),
    "no-epilogue-4-stages": (
        "the same with the epilogue's buffer given to a fourth stage: whether more "
        "bytes in flight feed the products",
        [*_NO_EPILOGUE, ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
         ("constexpr int kOutBytes = kConsumers * (kBN / kChunkN) * kOutBox;",
          "constexpr int kOutBytes = 0;")]),
}

#: design name -> (its phase patches, its variants); an edit (text,
#: replacement) replaces every occurrence, (text, replacement, marker) the
#: first after the marker (a kernel's name)
DESIGNS = {"first (41d7246)": (FIRST, FIRST_VARIANTS),
           "clusters": (CLUSTER, CLUSTER_VARIANTS)}


def apply(text: str, edits: list[tuple]) -> str | None:
    """``text`` with ``edits`` made, or None if a text is not in it."""
    for old, new, *marker in edits:
        if marker:
            at = text.find(old, text.find(marker[0]) if marker[0] else 0)
            if (marker[0] and marker[0] not in text) or at < 0:
                return None
            text = text[:at] + new + text[at + len(old):]
        elif old in text:
            text = text.replace(old, new)
        else:
            return None
    return text


def patched(name: str, csrc: Path, edits: list[tuple[str, str]]) -> Path:
    """A copy of ``csrc`` under :data:`OUT` with ``edits`` applied to
    ``moe_gmm.cu`` (the other sources left out); raises if a text is not in
    the source."""
    out = OUT / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    src = out / "moe_gmm.cu"
    text = apply(src.read_text(), edits)
    if text is None:
        raise ValueError(f"{name}: an edit's text is not in moe_gmm.cu")
    src.write_text(text)
    for other in out.glob("*.cu"):
        if other.name != "moe_gmm.cu":
            other.unlink()
    return out


def design_of(csrc: Path) -> str:
    text = (csrc / "moe_gmm.cu").read_text()
    for name, (edits, _) in DESIGNS.items():
        if apply(text, edits) is not None:
            return name
    raise SystemExit(f"gmm_phases: {csrc}/moe_gmm.cu matches no known design")


def load(name: str, csrc: Path) -> ctypes.CDLL:
    _build.build_log.pop("moe_gmm.cu", None)
    lib = moe_gmm.bind(_build.library("moe_gmm", csrc))
    cs.emit("build", build=name, csrc=str(csrc),
            ptxas=[ln.strip() for ln in _build.build_log.get("moe_gmm.cu", "").splitlines()
                   if "registers" in ln],
            flags=cs.ptxas_flags(_build.build_log.get("moe_gmm.cu", "")))
    return lib


def under_load(fn, seconds: float = 2.0) -> str:
    """``nvidia-smi``'s SM clock and power draw, read halfway through
    ``seconds`` of calls of ``fn``."""
    got = {}

    def query():
        time.sleep(seconds / 2)
        got["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    reader = threading.Thread(target=query)
    reader.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    reader.join()
    return got.get("smi", "")


def phases(lib, kernel: str, call) -> dict:
    counts = (ctypes.c_ulonglong * 32)()
    with using(moe_gmm, lib):
        call()
        torch.cuda.synchronize()
        if lib.gmm_phases(None, 1) != 0:
            raise RuntimeError("gmm_phases: reset failed")
        ms = cs.time_ms(call, 5, warmup=0)
    if lib.gmm_phases(ctypes.addressof(counts), 0) != 0:
        raise RuntimeError("gmm_phases: read failed")
    base = KERNELS[kernel] * _SLOTS
    roles = {}
    for role, names, off in (("consumer", CONSUMER, 0), ("producer", PRODUCER, 8)):
        items = counts[base + off + 7]
        cyc = {ph: counts[base + off + i] / max(items, 1) for i, ph in enumerate(names)}
        total = sum(cyc.values())
        roles[role] = {"items": items, "cycles_an_item": round(total, 1),
                       "share": {ph: round(c / total, 3) if total else 0.0
                                 for ph, c in cyc.items()}}
    return {"instrumented_ms": ms, "roles": roles}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC,
                    help="the tree's src/repro_torch/kernels/csrc (default: this one)")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="the design's variants: no-loads (both designs), "
                         "no-stage-out (the first)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gmm_phases: no CUDA device")
    dev = torch.device("cuda")
    csrc = args.csrc.resolve()
    design = design_of(csrc)
    edits, variants = DESIGNS[design]
    unknown = [n for n in args.variants if n not in variants]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; {design}: {sorted(variants)}")
    libs = {"build": load("build", csrc)}
    for name in args.variants:
        libs[name] = load(name, patched(name, csrc, variants[name][1]))
    inst = load("phases", patched("phases", csrc, edits))
    inst.gmm_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    inst.gmm_phases.restype = ctypes.c_int
    turns = (*libs, *reversed(libs))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for name, t, d, f, e, k in CASES:
        x = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        dy = torch.randn((t, f), generator=gen, device=dev).to(torch.bfloat16)
        sizes = cs.moe_group_sizes(gen, dev, t // k, e, k)
        nonempty = int((sizes > 0).sum())
        calls = gmm_bwd_calls(x, w, dy, sizes)
        libs_of = {"dx": cs.grouped_mm_call(dy, w.transpose(1, 2), sizes),
                   "dw": cs.grouped_mm_call(x.t(), dy, sizes)}
        floors = {"dx": cs.gmm_floor_ms(t, f, d, nonempty), "dw": cs.gmm_dw_floor_ms(t, d, f, e)}
        for kernel in ("dx", "dw"):
            times = {v: [] for v in libs}
            for v in turns:
                with using(moe_gmm, libs[v]):
                    times[v].append(cs.time_ms(calls[kernel], 20))
            with using(moe_gmm, libs["build"]):
                smi = under_load(calls[kernel])
            lib_call, no_lib = libs_of[kernel]
            bound_ms, bound_by = cs.bound(*floors[kernel])
            cs.emit("gmm_phases", case=name, kernel=kernel, design=design,
                    shape=[t, d, f, e], nonempty_experts=nonempty,
                    largest_group=int(sizes.max()), ms=times,
                    library_ms=cs.time_ms(lib_call, 20) if lib_call else None,
                    library=no_lib or "torch._grouped_mm",
                    dense_matmul_ms=cs.time_ms(cs.gmm_dense_call(kernel, x, w, dy), 20),
                    bound_ms=bound_ms, bound_by=bound_by, under_load=smi,
                    **phases(inst, kernel, calls[kernel]))
        del x, w, dy, calls, libs_of
        torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
