#!/usr/bin/env python3
"""Where a flash-attention backward block spends its cycles, phase by phase,
on one CUDA card.

    python3 scripts/fa_bwd_phases.py

Run from the repository root.  Builds this tree's ``csrc/`` copied to
``build/fa_bwd_phases/`` with ``flash_attention.cu`` text-patched
(:data:`PATCHES`): one thread of each role of the main kernel (the two
consumer warpgroups, the producer, the dQ writer) reads ``clock64()`` at the
boundaries of its phases and adds each phase's cycles, and its count of
items, to a device array, which a C entry point of the copy reads back.
The calls go through the port's ``flash_attention_bwd`` at every case of
``chip_smoke.FA_BWD_CASES`` of 1000 rows or more; one JSON line a case with
each role's cycles an item by phase, summed over the blocks, over their
items, and the share of the role's total.  The phases:

* consumer: ``full`` (waiting for the item's Q, dO, LSE and delta),
  ``scores`` (S^T and dP^T issued and waited for), ``grads`` (mask, P, dS),
  ``scores_out`` (P^T / dS^T to shared memory and the consumers' barrier;
  up to D 128 folded into ``products``), ``products`` (dV, dK, dQ issued
  and waited for), ``done`` (the consumers' barrier after them), ``dq_out``
  (the dQ part to the stage and its hand-over);
* producer: ``empty`` (waiting for a stage), ``load`` (issuing its loads);
* writer: ``dq_full`` (waiting for the consumers' part), ``turn`` (the
  hand-off's wait), ``read`` (the bulk copy's read of the stage),
  ``complete`` (its completion and the counter's release).

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
from fa_bwd_ablations import cases  # noqa: E402
from kernel_against import using  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "fa_bwd_phases"
ROLES = {0: "consumer 0", 1: "consumer 1", 2: "producer", 3: "writer"}
PHASES = {
    "consumer 0": ["full", "scores", "grads", "scores_out", "products", "done", "dq_out"],
    "producer": ["empty", "load"],
    "writer": ["dq_full", "turn", "read", "complete"],
}
PHASES["consumer 1"] = PHASES["consumer 0"]
_SLOTS = 8   # a role's counters: its phases, then its items

_FLUSH = ("    if (ph_on) {{ for (int k = 0; k < 7; ++k) atomicAdd(g_phase + {role} * 8 + k, "
          "static_cast<unsigned long long>(ph[k])); atomicAdd(g_phase + {role} * 8 + 7, "
          "static_cast<unsigned long long>(n_items)); }}\n")

#: (text, replacement) in flash_attention.cu
PATCHES = [
    ("namespace bwd {\n",
     "namespace bwd {\n\n__device__ unsigned long long g_phase[32];\n"
     "#define PH(k) if (ph_on) { const long long now_ = clock64(); ph[k] += now_ - ph_t; "
     "ph_t = now_; }\n"),
    ("  const int tid = threadIdx.x;\n  if (tid == 0) {\n    s_ticket = atomicAdd(prm.ticket, 1);",
     "  const int tid = threadIdx.x;\n"
     "  const bool ph_on = tid == 0 || tid == 128 || tid == 256 || tid == 288;\n"
     "  long long ph[7] = {0, 0, 0, 0, 0, 0, 0};\n  long long ph_t = clock64();\n"
     "  if (tid == 0) {\n    s_ticket = atomicAdd(prm.ticket, 1);"),
    # producer
    ("        mbar_wait(smem_addr(&empty[stage]), ((i / T::kStages) & 1) ^ 1);\n"
     "        load_item(i, stage);\n      }\n",
     "        mbar_wait(smem_addr(&empty[stage]), ((i / T::kStages) & 1) ^ 1);\n        PH(0)\n"
     "        load_item(i, stage);\n        PH(1)\n      }\n" + _FLUSH.format(role=2)),
    # writer
    ("        mbar_wait(smem_addr(&dq_full[stage]), (i / T::kStages) & 1);\n",
     "        mbar_wait(smem_addr(&dq_full[stage]), (i / T::kStages) & 1);\n        PH(0)\n"),
    ("          while (ld_acquire(counter) < turn) __nanosleep(32);\n",
     "          while (ld_acquire(counter) < turn) __nanosleep(32);\n          PH(1)\n"),
    ("        bulk_wait_read();\n", "        bulk_wait_read();\n        PH(2)\n"),
    ("        st_release(counter, turn + 1);\n      }\n",
     "        st_release(counter, turn + 1);\n        PH(3)\n      }\n" + _FLUSH.format(role=3)),
    # consumers
    ("      mbar_wait(smem_addr(&full[stage]), (i / T::kStages) & 1);\n",
     "      mbar_wait(smem_addr(&full[stage]), (i / T::kStages) & 1);\n      PH(0)\n"),
    ("      wgmma_wait<0>();\n      fence_acc(st);\n      fence_acc(dpt);\n",
     "      wgmma_wait<0>();\n      fence_acc(st);\n      fence_acc(dpt);\n      PH(1)\n"),
    ("                          mask, seq_len, prm.causal, prm.window, prm.scale_log2);\n      }\n",
     "                          mask, seq_len, prm.causal, prm.window, prm.scale_log2);\n      }\n"
     "      PH(2)\n"),
    ("        fence_async_shared();\n        consumers_sync(kBarScores);\n",
     "        fence_async_shared();\n        consumers_sync(kBarScores);\n        PH(3)\n"),
    ("      fence_acc(dv);\n      fence_acc(dk);\n      fence_acc(dq);\n      // Both consumers",
     "      fence_acc(dv);\n      fence_acc(dk);\n      fence_acc(dq);\n      PH(4)\n"
     "      // Both consumers"),
    ("      consumers_sync(kBarDone);\n", "      consumers_sync(kBarDone);\n      PH(5)\n"),
    ("      if (lane == 0) mbar_arrive(smem_addr(&dq_full[stage]));\n    }\n",
     "      if (lane == 0) mbar_arrive(smem_addr(&dq_full[stage]));\n      PH(6)\n    }\n"
     + _FLUSH.format(role="(tid / 128)")),
    ('extern "C" {\n',
     'extern "C" {\n\n'
     "int flash_attention_bwd_phases(void* out, int reset) {\n"
     "  if (reset) { static const unsigned long long zeros[32] = {};\n"
     "    return cudaMemcpyToSymbol(bwd::g_phase, zeros, sizeof(zeros)); }\n"
     "  return cudaMemcpyFromSymbol(out, bwd::g_phase, 32 * sizeof(unsigned long long));\n"
     "}\n"),
]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fa_bwd_phases: no CUDA device")
    dev = torch.device("cuda")
    csrc = fab.ablated("phases", ablations={"phases": ("clock64 phases", PATCHES)}, out=OUT)
    lib = fa.bind(_build.library("flash_attention", csrc))
    cs.emit("build", build="phases",
            flags=cs.ptxas_flags(_build.build_log.get("flash_attention.cu", "")))
    lib.flash_attention_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flash_attention_bwd_phases.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 32)()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, b, s, hq, hkv, d, causal, window in cases():
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
        with using(fa, lib):
            fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
            torch.cuda.synchronize()
            if lib.flash_attention_bwd_phases(None, 1) != 0:
                raise RuntimeError("flash_attention_bwd_phases: reset failed")
            ms = cs.time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                           causal=causal, window=window),
                            5, warmup=0)
        if lib.flash_attention_bwd_phases(ctypes.addressof(counts), 0) != 0:
            raise RuntimeError("flash_attention_bwd_phases: read failed")
        roles = {}
        for r, role in ROLES.items():
            items = counts[r * _SLOTS + 7]
            cyc = {ph: counts[r * _SLOTS + i] / max(items, 1)
                   for i, ph in enumerate(PHASES[role])}
            total = sum(cyc.values())
            roles[role] = {"items": items, "cycles_an_item": round(total, 1),
                           "share": {ph: round(c / total, 3) if total else 0.0
                                     for ph, c in cyc.items()}}
        cs.emit("bwd_phases", case=name, shape=[b, s, hq, hkv, d], causal=causal,
                window=window, instrumented_ms=ms, roles=roles)
        del q, k, v, do, out, lse
    print(cs.nvidia_smi(), subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
