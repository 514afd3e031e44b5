#!/usr/bin/env python3
"""Times this tree's grouped-GEMM kernel beside another version of it, on one
CUDA card, in one process.

    python3 scripts/gmm_against.py OTHER_CSRC [--serve-pairs N]

Run from the repository root.  ``OTHER_CSRC`` is another tree's
``src/repro_torch/kernels/csrc`` (e.g. an older commit unpacked under
``build/``), whose ``moe_gmm.cu`` has the same C entry point.  Both are built
and loaded by ``repro_torch.kernels._build`` and every call goes through the
port's wrapper ``moe_gmm.grouped_matmul``, pointed at one build or the other
in turns.  Prints each build's ptxas lines, then:

* at olmoe-1b-7b's prefill and decode shapes and qwen2-moe-a2.7b's, each
  build's error against the plain version (``chip_smoke.gmm_errors``) and
  its time in turns (this, other, other, this) beside ``torch._grouped_mm``,
  and at the decode shape each build's host time a call
  (``chip_smoke.host_us``, in turns as well): one JSON line a shape;
* with ``--serve-pairs N`` (default 10), N pairs of chip_smoke's serve phase
  (``chip_smoke.serve_requests``) on olmoe-1b-7b at full width with each
  build, the order alternating from pair to pair, each beside a gemma3-1b
  serve run (no grouped GEMM: it shows how the host drifts), after one
  uncounted pair that warms both up: one JSON line a run, then the medians
  of the olmoe/gemma3 decode rate ratio for each build;

then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, moe_gmm  # noqa: E402


@contextlib.contextmanager
def using(lib):
    """The port's wrapper launches from ``lib`` inside the block."""
    loader = moe_gmm._library
    moe_gmm._library = lambda: lib
    try:
        yield
    finally:
        moe_gmm._library = loader


def kernel_cases(libs: dict, dev) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = [  # name, T, d, f, E, top-k of the routing
        ("olmoe-1b-7b gate/up", 65536, 2048, 1024, 64, 8),
        ("olmoe-1b-7b down", 65536, 1024, 2048, 64, 8),
        ("qwen2-moe-a2.7b gate/up", 32768, 2048, 1408, 60, 4),
        ("qwen2-moe-a2.7b down", 32768, 1408, 2048, 60, 4),
        ("olmoe-1b-7b decode, 4 tokens", 32, 2048, 1024, 64, 8),
    ]
    turns = (*libs, *reversed(libs))
    for name, t, d, f, e, k in cases:
        x = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        sizes = cs.moe_group_sizes(gen, dev, t // k, e, k)
        want = moe_gmm.grouped_matmul_plain(x, w, sizes)

        def call():
            return moe_gmm.grouped_matmul(x, w, sizes)

        errs, times, host = {}, {v: [] for v in libs}, None
        for v, lib in libs.items():
            with using(lib):
                errs[v] = cs.gmm_errors(call(), want)["max_abs_err"]
        for v in turns:
            with using(libs[v]):
                times[v].append(cs.time_ms(call, 20))
        if t <= 4 * k:   # decode: the host's time a call is what it costs
            host = {v: [] for v in libs}
            for v in turns:
                with using(libs[v]):
                    host[v].append(cs.host_us(call))
        lib_call, no_lib = cs.grouped_mm_call(x, w, sizes)
        nonempty = int((sizes > 0).sum())
        cs.emit("gmm_against", case=name, shape=[t, d, f, e], nonempty_experts=nonempty,
                max_abs_err=errs, ms=times, host_us=host,
                library_ms=cs.time_ms(lib_call, 20) if lib_call else None,
                library=no_lib or "torch._grouped_mm",
                bound_ms=cs.bound(*cs.gmm_floor_ms(t, d, f, nonempty))[0])
        del x, w, want


def serve_pairs(libs: dict, dev, pairs: int) -> None:
    from repro_torch.configs import get
    from repro_torch.models import Model, compute_copy

    models = {}
    for arch in ("olmoe-1b-7b", "gemma3-1b"):
        cfg = get(arch)
        models[arch] = (cfg, compute_copy(cfg, Model(cfg, dev).init(seed=0)))
        torch.cuda.empty_cache()
    ratios = {v: [] for v in libs}
    for i in range(-1, pairs):   # pair -1 warms both builds up: not counted
        for v in (list(libs) if i % 2 == 0 else list(reversed(libs))):
            rates = {}
            with using(libs[v]):
                for arch, (cfg, params) in models.items():
                    _, n_tok, seconds = cs.serve_requests(
                        cfg, params, dev, np.random.default_rng(0))
                    rates[arch] = n_tok / seconds
            ratio = rates["olmoe-1b-7b"] / rates["gemma3-1b"]
            if i >= 0:
                ratios[v].append(ratio)
            cs.emit("serve_against", pair=i, build=v, decode_tokens_per_s=rates,
                    olmoe_over_gemma3=ratio)
    cs.emit("serve_against_summary", pairs=pairs,
            median_olmoe_over_gemma3={v: float(np.median(r)) for v, r in ratios.items()},
            ratios=ratios)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_csrc", type=Path,
                    help="another tree's src/repro_torch/kernels/csrc")
    ap.add_argument("--serve-pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gmm_against: no CUDA device")
    dev = torch.device("cuda")
    libs = {}
    for v, csrc in (("this", _build.CSRC), ("other", args.other_csrc.resolve())):
        _build.build_log.pop("moe_gmm.cu", None)
        libs[v] = moe_gmm.bind(_build.library("moe_gmm", csrc))
        log = _build.build_log.get("moe_gmm.cu", "")
        cs.emit("build", build=v, csrc=str(csrc),
                ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln],
                flags=cs.ptxas_flags(log))
    kernel_cases(libs, dev)
    if args.serve_pairs:
        serve_pairs(libs, dev, args.serve_pairs)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
