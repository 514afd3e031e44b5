#!/usr/bin/env python3
"""Where a block of the SSD scan's backward kernel (``ssd_chunk_scan_bwd``)
spends its cycles, phase by phase, on one CUDA card.

    python3 scripts/ssd_bwd_phases.py

Run from the repository root.  Builds this tree's ``csrc/`` copied to
``build/ssd_bwd_phases/`` with ``ssd_scan.cu`` text-patched
(:data:`PATCHES`): one thread of each role of the kernel (the consumer
warpgroup, the producer, the converters) reads ``clock64()`` at the
boundaries of its phases and adds each phase's cycles, and its count of
items, to a device array, which a C entry point of the copy reads back.
The calls go through the port's ``chunk_scan_bwd`` at
``kernel_against.SSD_BWD_SHAPES``; one JSON line a case with each role's
cycles an item by phase, summed over the blocks and their items, and the
share of the role's total.  The phases:

* consumer (items: tile pairs): ``cum`` (dB's store at a new key tile),
  ``inter`` (waiting for prev's planes and the head's cum, and the
  inter-chunk term's row tiles, with the first key tile), ``planes``
  (waiting for G's planes, with the cum at a later key tile, and x_J), ``state`` (the chunk-state term), then a pair's ``stage`` (waiting
  for C_I and dy_I), ``scores`` (S^T and dS^T issued and waited for),
  ``decay`` (the masked decay, R's sums, A^T to shared memory, S^T's
  fragments), ``colsum`` (the barrier and dcum's column sums), ``dxdb``
  (dx and dB issued and waited for), ``dc`` (dC's part issued, added to
  the shared accumulator, the barrier), and a head's ``end`` (dcum's row
  sums, dx stored);
* producer (items: loads): ``x_empty`` (waiting to load x_J and B_J),
  ``st_empty`` (waiting for the stage), ``issue``;
* converter (items: planes): ``load`` (its part of prev or G into
  registers, and with a (J, head)'s first planes the head's cum),
  ``empty`` (waiting for the planes), ``store``.

The instrumented kernel is slower than the kernel (the clock reads and
branches); the shares, not the cycles, carry over.  Then the card's name,
power limit and SM clock.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import fa_ablations as fab  # noqa: E402
from kernel_against import SSD_BWD_SHAPES, using  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

OUT = ROOT / "build" / "ssd_bwd_phases"
_SLOTS = 12   # a role's counters: its phases, then its items
ROLES = {0: "consumer", 1: "producer", 2: "converter"}
PHASES = {
    "consumer": ["cum", "inter", "planes", "state", "stage", "scores", "decay", "colsum",
                 "dxdb", "dc", "end"],
    "producer": ["x_empty", "st_empty", "issue"],
    "converter": ["load", "empty", "store"],
}


def _flush(role: int, items: str) -> str:
    return (f"    if (ph_on) {{ for (int k = 0; k < 11; ++k) atomicAdd(g_phase + {role} * 12 + k, "
            f"static_cast<unsigned long long>(ph[k])); atomicAdd(g_phase + {role} * 12 + 11, "
            f"static_cast<unsigned long long>({items})); }}\n")


#: (text, replacement) in ssd_scan.cu
PATCHES = [
    ("template <int P, int N>\n__global__ void __launch_bounds__(kBwdThreads, 1)\n",
     "__device__ unsigned long long g_phase[36];\n"
     "#define PH(k) if (ph_on) { const long long now_ = clock64(); ph[k] += now_ - ph_t; "
     "ph_t = now_; }\n\ntemplate <int P, int N>\n"
     "__global__ void __launch_bounds__(kBwdThreads, 1)\n"),
    ("  const int tid = threadIdx.x;\n  if (tid == 0) {\n    mbar_init(smem_addr(&xb_full), 1);",
     "  const int tid = threadIdx.x;\n"
     "  const bool ph_on = tid == 0 || tid == 128 || tid == 160;\n"
     "  long long ph[11] = {};\n  long long ph_t = clock64();\n  long long n_items = 0;\n"
     "  if (tid == 0) {\n    mbar_init(smem_addr(&xb_full), 1);"),
    # converters
    ("          mbar_wait(smem_addr(&pl_empty), (pu & 1) ^ 1);\n          pl.store(hi, lo, t);\n",
     "          PH(0)\n          mbar_wait(smem_addr(&pl_empty), (pu & 1) ^ 1);\n          PH(1)\n"
     "          pl.store(hi, lo, t);\n"),
    ("          mbar_arrive(smem_addr(&pl_full));\n          ++pu;\n        }\n      }\n    }\n"
     "    return;\n",
     "          mbar_arrive(smem_addr(&pl_full));\n          ++pu;\n          PH(2)\n"
     "          ++n_items;\n        }\n      }\n    }\n" + _flush(2, "n_items") + "    return;\n"),
    # producer
    ("          mbar_wait(smem_addr(&xb_empty), (xu & 1) ^ 1);\n",
     "          PH(2)\n          mbar_wait(smem_addr(&xb_empty), (xu & 1) ^ 1);\n          PH(0)\n"),
    ("            mbar_wait(smem_addr(&st_empty), (it & 1) ^ 1);\n",
     "            PH(2)\n            mbar_wait(smem_addr(&st_empty), (it & 1) ^ 1);\n"
     "            PH(1)\n            ++n_items;\n"),
    ("            tma_load_5d(s_dy, &map_dy, sf, 0, h, I * kTile, c, b);\n"
     "            ++it;\n          }\n        }\n      }\n    }\n",
     "            tma_load_5d(s_dy, &map_dy, sf, 0, h, I * kTile, c, b);\n"
     "            ++it;\n          }\n        }\n      }\n      PH(2)\n" + _flush(1, "n_items")
     + "    }\n"),
    # consumer
    ("      const float* const cum = cum_buf[(J * prm.rep + r) & 1];\n",
     "      const float* const cum = cum_buf[(J * prm.rep + r) & 1];\n      PH(0)\n"),
    ("      if (inter > 0) mbar_arrive(smem_addr(&pl_empty));   // done with prev_c\n",
     "      if (inter > 0) mbar_arrive(smem_addr(&pl_empty));   // done with prev_c\n      PH(1)\n"),
    ("      mbar_wait(smem_addr(&xb_full), xu & 1);\n      float dx[32];\n",
     "      mbar_wait(smem_addr(&xb_full), xu & 1);\n      PH(2)\n      float dx[32];\n"),
    ("      if (tid == 0) dtot[r] += red[0] + red[1] + red[2] + red[3];\n",
     "      if (tid == 0) dtot[r] += red[0] + red[1] + red[2] + red[3];\n      PH(3)\n"),
    ("        mbar_wait(smem_addr(&st_full), it & 1);\n        float s[32], ds[32];\n",
     "        mbar_wait(smem_addr(&st_full), it & 1);\n        PH(4)\n        ++n_items;\n"
     "        float s[32], ds[32];\n"),
    ("        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(s);\n        fence_acc(ds);\n",
     "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(s);\n        fence_acc(ds);\n"
     "        PH(5)\n"),
    ("        uint32_t a_hi[4][4], a_lo[4][4];\n        split_scores(s, a_hi, a_lo);\n",
     "        uint32_t a_hi[4][4], a_lo[4][4];\n        split_scores(s, a_hi, a_lo);\n        PH(6)\n"),
    ("                                     colbuf[3][tid];\n",
     "                                     colbuf[3][tid];\n        PH(7)\n"),
    ("        mbar_arrive(smem_addr(&st_empty));   // C_I and dy_I are read\n        ++it;\n",
     "        mbar_arrive(smem_addr(&st_empty));   // C_I and dy_I are read\n        ++it;\n"
     "        PH(8)\n"),
    ("        warpgroup_sync(kBarBwd);   // every warp is done with the planes and colbuf\n      }\n",
     "        warpgroup_sync(kBarBwd);   // every warp is done with the planes and colbuf\n"
     "        PH(9)\n      }\n"),
    ("      mbar_arrive(smem_addr(&pl_empty));   // the planes' A^T is dead\n",
     "      mbar_arrive(smem_addr(&pl_empty));   // the planes' A^T is dead\n      PH(10)\n"),
    ("  // -- dlog_a: dcum with dT at the last row, summed from the chunk's end ----\n",
     _flush(0, "n_items")
     + "  // -- dlog_a: dcum with dT at the last row, summed from the chunk's end ----\n"),
    ('extern "C" {\n',
     'extern "C" {\n\n'
     "int ssd_chunk_scan_bwd_phases(void* out, int reset) {\n"
     "  if (reset) { static const unsigned long long zeros[36] = {};\n"
     "    return cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros)); }\n"
     "  return cudaMemcpyFromSymbol(out, g_phase, 36 * sizeof(unsigned long long));\n"
     "}\n"),
]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_phases: no CUDA device")
    dev = torch.device("cuda")
    csrc = fab.ablated("phases", "ssd_scan.cu", {"phases": ("clock64 phases", PATCHES)}, OUT)
    lib = ssd_scan.bind(_build.library("ssd_scan", csrc))
    cs.emit("build", build="phases",
            flags=cs.ptxas_flags(_build.build_log.get("ssd_scan.cu", "")))
    lib.ssd_chunk_scan_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ssd_chunk_scan_bwd_phases.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 36)()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, b, s, h, p, g, n, chunk in SSD_BWD_SHAPES:
        x, la, bm, cm, _ = cs.ssd_inputs(gen, dev, b, s, h, p, g, n, False)
        dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
        prev, _ = ssd_scan.chunk_state(x, la, bm, chunk=chunk)
        gnext, _, d_total = ssd_scan.chunk_state_bwd(dy, la, cm, prev, chunk=chunk)

        def call():
            return ssd_scan.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext, d_total,
                                           chunk=chunk)

        with using(ssd_scan, lib):
            call()
            torch.cuda.synchronize()
            if lib.ssd_chunk_scan_bwd_phases(None, 1) != 0:
                raise RuntimeError("ssd_chunk_scan_bwd_phases: reset failed")
            ms = cs.time_ms(call, 5, warmup=0)
        if lib.ssd_chunk_scan_bwd_phases(ctypes.addressof(counts), 0) != 0:
            raise RuntimeError("ssd_chunk_scan_bwd_phases: read failed")
        roles = {}
        for r, role in ROLES.items():
            items = counts[r * _SLOTS + 11]
            cyc = {ph: counts[r * _SLOTS + i] / max(items, 1)
                   for i, ph in enumerate(PHASES[role])}
            total = sum(cyc.values())
            roles[role] = {"items": items, "cycles_an_item": round(total, 1),
                           "share": {ph: round(c / total, 3) if total else 0.0
                                     for ph, c in cyc.items()}}
        cs.emit("bwd_phases", case=name, shape=[b, s, h, p, g, n, chunk],
                instrumented_ms=ms, roles=roles)
        del x, la, bm, cm, dy, prev, gnext, d_total
    print(cs.nvidia_smi(), subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
