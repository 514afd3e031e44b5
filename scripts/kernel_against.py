#!/usr/bin/env python3
"""Times one of this tree's kernels beside another version of it, on one CUDA
card, in one process.

    python3 scripts/kernel_against.py gmm OTHER_CSRC [--serve-pairs N]
    python3 scripts/kernel_against.py fa OTHER_CSRC [--prefill-pairs N]
    python3 scripts/kernel_against.py ssd OTHER_CSRC [--prefill-pairs N]
    python3 scripts/kernel_against.py ssd_bwd OTHER_CSRC
    python3 scripts/kernel_against.py gmm_bwd OTHER_CSRC

Run from the repository root.  ``OTHER_CSRC`` is another tree's
``src/repro_torch/kernels/csrc`` (e.g. an older commit unpacked under
``build/``), whose source of the kernel (``moe_gmm.cu`` for ``gmm``,
``flash_attention.cu`` for ``fa``, ``ssd_scan.cu`` for ``ssd``) has the same C
entry points.  Both are built and loaded by ``repro_torch.kernels._build`` and
every call goes through the port's wrapper (``moe_gmm.grouped_matmul``,
``flash_attention.flash_attention``, ``ssd_scan.chunk_state`` and
``chunk_scan``), pointed at one build or the other in turns.  Prints each
build's ptxas lines, then for ``gmm``:

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

and for ``fa``:

* at gemma3-1b's global and window layers, h2o-danube-1.8b's (D 80) and
  deepseek-7b's (D 128, 32 heads) shapes, gemma3-1b's 26 calls of a prefill
  and olmoe-1b-7b's 16, each build's error against the plain version (max
  |err| and the largest error relative to its row's largest element,
  ``chip_smoke.row_rel_err``) and its time in turns beside
  ``scaled_dot_product_attention`` and the card's bound: one JSON line a
  case;
* with ``--prefill-pairs N`` (default 5), N pairs of full-width prefills
  (``forward`` on a (4, 2048) batch, median of 3) of gemma3-1b and
  olmoe-1b-7b with each build, the order alternating, after one uncounted
  pair: one JSON line a run, then each build's medians;

and for ``ssd``:

* at mamba2-780m's prefill shape, hymba-1.5b's (H 50, N 16) and a G 4,
  N 64 one, each build's error against the plain versions (prev, the final
  state and y: max |err| and the largest error relative to its (batch,
  head)'s largest element, ``chip_smoke.slab_rel_err``) and the times of
  ``chunk_state`` and ``chunk_scan`` in turns (``ms`` by CUDA events around
  20 calls; ``kernel_ms``, the kernel's own device time by the profiler,
  ``chip_smoke.kernel_ms``), beside the plain versions' times and each
  kernel's bound (``chip_smoke.ssd_floor_ms``), and the
  first build's host µs a call (``chip_smoke.host_us``: where it nears the
  device time, the timing is the host's); both builds' ``chunk_scan`` read
  the plain version's prev: one JSON line a case;
* with ``--prefill-pairs N`` (default 5), N pairs of full-width
  mamba2-780m prefills (median of 3) with each build, the order
  alternating, after one uncounted pair;

and for ``ssd_bwd``, the SSD scan's backward, where ``OTHER_CSRC``'s
``ssd_scan.cu`` has the earlier backward interface (``ssd_chunk_scan_bwd``
first, writing dx, dB and dC per head, dprev and dcum in fp32, then
``ssd_chunk_state_bwd`` adding the chunk-state term to them in place; torch
glue after: :func:`earlier_backward`) and this tree's goes through the
port's wrappers (``chunk_state_bwd``, ``chunk_scan_bwd``, ``ssd_scan_bwd``):

* at mamba2-780m's training shape, hymba-1.5b's SSD and the (64, 64) G 4
  case, each build's error against ``ssd_scan_bwd_plain`` (dx, dlog_a, dB,
  dC: max |err| and the largest error relative to its (batch, head or
  group)'s largest element) and, in turns (this, other, other, this), the
  time of each backward kernel and of the whole backward (both kernels and
  the glue), by CUDA events around 10 calls and the kernels' own device
  time by the profiler, beside the plain versions' times and the bounds of
  each of this tree's kernels and of the function
  (``chip_smoke.ssd_bwd_floor_ms``): one JSON line a case;

and for ``gmm_bwd``, the grouped GEMM's backward kernels (``moe_gmm.cu``'s
``grouped_matmul_dx`` and ``grouped_matmul_dw``, the same C entry points in
both trees, e.g. the first design's, ``git archive 41d7246``):

* at olmoe-1b-7b's and qwen2-moe-a2.7b's training shapes (gate/up and
  down, group sizes of a top-k routing), each build's error against the
  plain versions (dx: ``chip_smoke.gmm_errors``; dw, into a NaN-filled
  buffer: ``chip_smoke.dw_errors``) and each kernel's time in turns (this,
  other, other, this), beside ``torch._grouped_mm``, the dense
  ``torch.matmul`` with the same FLOPs (``chip_smoke.gmm_dense_call``) and
  the bound: one JSON line a case;
* olmoe-1b-7b's train step mix at 4 layers (``chip_smoke.py``'s
  ``kernel_train_mix``: gate, up and down a layer, 12 calls of each
  kernel), each build in turns beside the same yardsticks: one JSON line a
  kernel;

then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, flash_attention, moe_gmm  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

#: kernel argument -> (wrapper module, source name)
KERNELS = {"gmm": (moe_gmm, "moe_gmm"), "fa": (flash_attention, "flash_attention"),
           "ssd": (ssd_scan, "ssd_scan"), "ssd_bwd": (ssd_scan, "ssd_scan"),
           "gmm_bwd": (moe_gmm, "moe_gmm")}

#: the grouped GEMM's backward cases: name, T, d, f, E, top-k of the routing
GMM_BWD_SHAPES = [("olmoe-1b-7b gate/up", 65536, 2048, 1024, 64, 8),
                  ("olmoe-1b-7b down", 65536, 1024, 2048, 64, 8),
                  ("qwen2-moe-a2.7b gate/up", 32768, 2048, 1408, 60, 4),
                  ("qwen2-moe-a2.7b down", 32768, 1408, 2048, 60, 4)]
#: layers of olmoe-1b-7b's train step mix (chip_smoke.py's depth cut)
GMM_BWD_MIX_LAYERS = 4

#: the SSD backward's cases: name, B, S, H, P, G, N, chunk
SSD_BWD_SHAPES = [("mamba2-780m train", 4, 2048, 48, 64, 1, 128, 256),
                  ("hymba-1.5b SSD", 4, 2048, 50, 64, 1, 16, 256),
                  ("(64, 64), G 4", 2, 1024, 16, 64, 4, 64, 256)]


@contextlib.contextmanager
def using(module, lib):
    """The port's wrapper in ``module`` launches from ``lib`` inside the block."""
    loader = module._library
    module._library = lambda: lib
    try:
        yield
    finally:
        module._library = loader


def gmm_cases(libs: dict, dev) -> None:
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
            with using(moe_gmm, lib):
                errs[v] = cs.gmm_errors(call(), want)["max_abs_err"]
        for v in turns:
            with using(moe_gmm, libs[v]):
                times[v].append(cs.time_ms(call, 20))
        if t <= 4 * k:   # decode: the host's time a call is what it costs
            host = {v: [] for v in libs}
            for v in turns:
                with using(moe_gmm, libs[v]):
                    host[v].append(cs.host_us(call))
        lib_call, no_lib = cs.grouped_mm_call(x, w, sizes)
        nonempty = int((sizes > 0).sum())
        cs.emit("gmm_against", case=name, shape=[t, d, f, e], nonempty_experts=nonempty,
                max_abs_err=errs, ms=times, host_us=host,
                library_ms=cs.time_ms(lib_call, 20) if lib_call else None,
                library=no_lib or "torch._grouped_mm",
                bound_ms=cs.bound(*cs.gmm_floor_ms(t, d, f, nonempty))[0])
        del x, w, want


def gmm_bwd_calls(x, w, dy, sizes) -> dict:
    """dx's and dw's kernel calls on one product's operands: x (T, d), w
    (E, d, f), dy (T, f)."""
    return {"dx": lambda: moe_gmm.grouped_matmul_dx(dy, w, sizes),
            "dw": lambda: moe_gmm.grouped_matmul_dw(x, dy, sizes)}


def gmm_bwd_cases(libs: dict, dev) -> None:
    """Each build in ``libs`` at each of :data:`GMM_BWD_SHAPES`, then at
    olmoe-1b-7b's train step mix: errors, then times in turns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    turns = (*libs, *reversed(libs))
    for name, t, d, f, e, k in GMM_BWD_SHAPES:
        x = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        dy = torch.randn((t, f), generator=gen, device=dev).to(torch.bfloat16)
        sizes = cs.moe_group_sizes(gen, dev, t // k, e, k)
        nonempty = int((sizes > 0).sum())
        want = {"dx": moe_gmm.grouped_matmul_dx_plain(dy, w, sizes),
                "dw": moe_gmm.grouped_matmul_dw_plain(x, dy, sizes)}
        calls = gmm_bwd_calls(x, w, dy, sizes)
        floors = {"dx": cs.gmm_floor_ms(t, f, d, nonempty),
                  "dw": cs.gmm_dw_floor_ms(t, d, f, e)}
        lib_calls = {"dx": cs.grouped_mm_call(dy, w.transpose(1, 2), sizes),
                     "dw": cs.grouped_mm_call(x.t(), dy, sizes)}
        out = {}
        for part in ("dx", "dw"):
            errs, times = {}, {v: [] for v in libs}
            for v, lib in libs.items():
                with using(moe_gmm, lib):
                    if part == "dx":
                        errs[v] = cs.gmm_errors(calls["dx"](), want["dx"])
                    else:
                        errs[v] = cs.dw_errors(moe_gmm.grouped_matmul_dw(
                            x, dy, sizes, out=torch.full((e, d, f), float("nan"),
                                                         dtype=torch.bfloat16,
                                                         device=dev)),
                            want["dw"], sizes)
            for v in turns:
                with using(moe_gmm, libs[v]):
                    times[v].append(cs.time_ms(calls[part], 20))
            lib_call, no_lib = lib_calls[part]
            bound_ms, bound_by = cs.bound(*floors[part])
            out[part] = {"errors": errs, "ms": times,
                         "library_ms": cs.time_ms(lib_call, 20) if lib_call else None,
                         "library": no_lib or "torch._grouped_mm",
                         "dense_matmul_ms": cs.time_ms(
                             cs.gmm_dense_call(part, x, w, dy), 20),
                         "bound_ms": bound_ms, "bound_by": bound_by}
        cs.emit("gmm_bwd_against", case=name, shape=[t, d, f, e],
                nonempty_experts=nonempty, largest_group=int(sizes.max()), **out)
        del x, w, dy, want, calls, lib_calls
        torch.cuda.empty_cache()
    gmm_bwd_mix(libs, dev, gen)


def gmm_bwd_mix(libs: dict, dev, gen) -> None:
    """olmoe-1b-7b's train step mix (gate, up and down a layer over
    :data:`GMM_BWD_MIX_LAYERS` layers) of dx and of dw, each build in
    turns, as chip_smoke.py's ``kernel_train_mix`` times it."""
    t, d, f, e, k = 65536, 2048, 1024, 64, 8
    sizes = cs.moe_group_sizes(gen, dev, t // k, e, k)
    nonempty = int((sizes > 0).sum())
    x = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
    hid = torch.randn((t, f), generator=gen, device=dev).to(torch.bfloat16)
    w_in = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w_down = (torch.randn((e, f, d), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    # (x, w, dy) of each product; gate and up share x and their shapes
    calls = [(x, w_in, hid), (x, w_in, hid), (hid, w_down, x)] * GMM_BWD_MIX_LAYERS
    turns = (*libs, *reversed(libs))
    for part in ("dx", "dw"):
        mix = [gmm_bwd_calls(a, w, g, sizes)[part] for a, w, g in calls]
        floors = [cs.gmm_floor_ms(t, w.shape[2], w.shape[1], nonempty) if part == "dx"
                  else cs.gmm_dw_floor_ms(t, w.shape[1], w.shape[2], e)
                  for _, w, _ in calls]
        bound_ms, bound_by = cs.bound(sum(fl[0] for fl in floors),
                                      sum(fl[1] for fl in floors))
        lib_calls = [cs.grouped_mm_call(g, w.transpose(1, 2), sizes) if part == "dx"
                     else cs.grouped_mm_call(a.t(), g, sizes) for a, w, g in calls[:3]]
        no_lib = next((why for call, why in lib_calls if call is None), None)
        dense = [cs.gmm_dense_call(part, a, w, g) for a, w, g in calls[:3]]
        times = {v: [] for v in libs}
        for v in turns:
            with using(moe_gmm, libs[v]):
                times[v].append(cs.time_ms(lambda: [c() for c in mix], 5))
        cs.emit("gmm_bwd_mix_against", kernel=f"grouped_matmul_{part}", calls=len(calls),
                layers=GMM_BWD_MIX_LAYERS, shape=[t, d, f, e], nonempty_experts=nonempty,
                ms=times,
                library_ms=None if no_lib else cs.time_ms(
                    lambda: [c() for c, _ in lib_calls * GMM_BWD_MIX_LAYERS], 5),
                library=no_lib or "torch._grouped_mm",
                dense_matmul_ms=cs.time_ms(
                    lambda: [c() for c in dense * GMM_BWD_MIX_LAYERS], 5),
                bound_ms=bound_ms, bound_by=bound_by)
        del mix, lib_calls, dense
    del x, hid, w_in, w_down, calls
    torch.cuda.empty_cache()


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
            with using(moe_gmm, libs[v]):
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


def fa_shapes() -> list[tuple]:
    """The flash-attention cases: name, B, S, Hq, Hkv, D, causal, the
    windows of its calls (one call each)."""
    from repro_torch.configs import get

    gemma3 = get("gemma3-1b")
    windows = [gemma3.window if kind == "swa" else 0 for kind in gemma3.layer_types]
    return [
        ("gemma3-1b global", 4, 2048, 4, 1, 256, True, [0]),
        ("gemma3-1b swa", 4, 2048, 4, 1, 256, True, [512]),
        ("gemma3-1b prefill, 26 calls", 4, 2048, 4, 1, 256, True, windows),
        ("olmoe-1b-7b prefill, 16 calls", 4, 2048, 16, 16, 128, True, [0] * 16),
        ("h2o-danube-1.8b", 4, 2048, 32, 8, 80, True, [4096]),
        ("deepseek-7b", 4, 2048, 32, 32, 128, True, [0]),
    ]


def fa_cases(libs: dict, dev, cases: list[tuple] | None = None) -> None:
    """Each build in ``libs`` at each case: errors, then times in turns
    (the builds in order, then in reverse)."""
    fa = flash_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    turns = (*libs, *reversed(libs))
    for name, b, s, hq, hkv, d, causal, wins in cases or fa_shapes():
        q, k, v = [torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv)]
        errs = {ver: {"max_abs_err": 0.0, "max_row_rel_err": 0.0} for ver in libs}
        for w in sorted(set(wins)):
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=w)
            for ver, lib in libs.items():
                with using(fa, lib):
                    out = fa.flash_attention(q, k, v, causal=causal, window=w)
                e = errs[ver]
                e["max_abs_err"] = max(e["max_abs_err"],
                                       (out.float() - want.float()).abs().max().item())
                e["max_row_rel_err"] = max(e["max_row_rel_err"], cs.row_rel_err(out, want))
                del out
            del want

        def call():
            return [fa.flash_attention(q, k, v, causal=causal, window=w) for w in wins]

        iters = max(2, 20 // len(wins))
        times = {ver: [] for ver in libs}
        for ver in turns:
            with using(fa, libs[ver]):
                times[ver].append(cs.time_ms(call, iters))
        sdpa = [cs.sdpa_call(q, k, v, causal, w) for w in wins]
        floors = [cs.attention_floor_ms(b, s, hq, hkv, d, causal, w) for w in wins]
        bound_ms, bound_by = cs.bound(sum(f[0] for f in floors), sum(f[1] for f in floors))
        cs.emit("fa_against", case=name, calls=len(wins), shape=[b, s, hq, hkv, d],
                causal=causal, windows=sorted(set(wins)), errors=errs, ms=times,
                library_ms=cs.time_ms(lambda: [c() for c in sdpa], iters),
                library="scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, sdpa


#: the SSD cases: name, B, S, H, P, G, N, chunk
SSD_SHAPES = [
    ("mamba2-780m prefill", 4, 2048, 48, 64, 1, 128, 256),
    ("hymba-1.5b SSD", 4, 2048, 50, 64, 1, 16, 256),
    ("G 4, N 64", 2, 1024, 16, 64, 4, 64, 256),
]


def ssd_cases(libs: dict, dev) -> None:
    """Each build in ``libs`` at each of :data:`SSD_SHAPES`: errors, then
    each kernel's times in turns (the builds in order, then in reverse)."""
    kssd = ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    turns = (*libs, *reversed(libs))
    for name, b, s, h, p, g, n, chunk in SSD_SHAPES:
        x, la, bm, cm, _ = cs.ssd_inputs(gen, dev, b, s, h, p, g, n, False)
        q = min(chunk, s)
        want_prev, want_final = kssd.chunk_state_plain(x, la, bm, q)
        want_y = kssd.chunk_scan_plain(x, la, bm, cm, want_prev, q)
        errs = {}
        for ver, lib in libs.items():
            with using(kssd, lib):
                prev, final = kssd.chunk_state(x, la, bm, chunk=chunk)
                y = kssd.chunk_scan(x, la, bm, cm, want_prev, chunk=chunk)
            torch.cuda.synchronize()
            errs[ver] = {
                what: {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                       "max_bh_rel_err": cs.slab_rel_err(got, want, keep)}
                for what, got, want, keep in (
                    ("prev", prev, want_prev, (0, 1)),
                    ("final", final, want_final, (0, 1)),
                    ("y", y, want_y, (0, 2)))}
            del prev, final, y
        calls = {"chunk_state": lambda: kssd.chunk_state(x, la, bm, chunk=chunk),
                 "chunk_scan": lambda: kssd.chunk_scan(x, la, bm, cm, want_prev,
                                                       chunk=chunk)}
        plain = {"chunk_state": lambda: kssd.chunk_state_plain(x, la, bm, q),
                 "chunk_scan": lambda: kssd.chunk_scan_plain(x, la, bm, cm,
                                                             want_prev, q)}
        out = {}
        for part, call in calls.items():
            times = {ver: [] for ver in libs}
            kernel = {ver: [] for ver in libs}
            for ver in turns:
                with using(kssd, libs[ver]):
                    times[ver].append(cs.time_ms(call, 20))
                    kernel[ver].append(cs.kernel_ms(call, f"ssd_{part}"))
            bound_ms, bound_by = cs.bound(*cs.ssd_floor_ms(b, s, h, p, g, n, chunk, part))
            with using(kssd, libs[turns[0]]):
                host = cs.host_us(call)
            out[part] = {"ms": times, "kernel_ms": kernel,
                         "plain_ms": cs.time_ms(plain[part], 3, 1),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         f"host_us_{turns[0]}": host}
        cs.emit("ssd_against", case=name, shape=[b, s, h, p, g, n, q], errors=errs,
                **out)
        del x, la, bm, cm, want_prev, want_final, want_y


def earlier_backward(lib, x, la, bm, cm, prev, dy, chunk):
    """The SSD backward through a build of ``ssd_scan.cu`` with the earlier
    interface: ``ssd_chunk_scan_bwd`` (dx's intra term, dB and dC per head,
    dprev and dcum, all fp32), then ``ssd_chunk_state_bwd`` (the state pass
    in reverse, its term added to dx, dB and dcum in place), then the glue
    (dlog_a by a reverse cumsum, dB and dC summed over each group's heads,
    dx in bf16).  Returns callables (scan, state, whole): the two launches
    alone (``state`` on ``scan``'s outputs) and the whole backward, which
    returns (dx, dlog_a, dB, dC)."""
    lib.ssd_chunk_scan_bwd.argtypes = [ctypes.c_void_p] * 13
    lib.ssd_chunk_state_bwd.argtypes = [ctypes.c_void_p] * 13
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, s)
    c = s // q
    f32 = {"dtype": torch.float32, "device": x.device}
    dims = ssd_scan._dims(x, la, bm, cm, q)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def scan():
        outs = [torch.empty(shape, **f32) for shape in (
            (bsz, s, h, p), (bsz, s, h, n), (bsz, s, h, n), (bsz, h, c, p, n),
            (bsz, s, h))]
        ssd_scan._raise_on(lib.ssd_chunk_scan_bwd(
            x.data_ptr(), la.data_ptr(), bm.data_ptr(), cm.data_ptr(), prev.data_ptr(),
            dy.data_ptr(), *(t.data_ptr() for t in outs), ctypes.addressof(dims),
            stream), "ssd_chunk_scan_bwd (earlier)")
        return outs

    def state(outs):
        dx, db, _, dprev, dcum = outs
        work = torch.zeros(bsz * h * c + 1, dtype=torch.int32, device=x.device)
        ssd_scan._raise_on(lib.ssd_chunk_state_bwd(
            x.data_ptr(), la.data_ptr(), bm.data_ptr(), prev.data_ptr(), None,
            dprev.data_ptr(), dx.data_ptr(), db.data_ptr(), dcum.data_ptr(),
            work.data_ptr(), work.data_ptr() + 4 * bsz * h * c, ctypes.addressof(dims),
            stream), "ssd_chunk_state_bwd (earlier)")
        return outs

    def whole():
        dx, db, dc, _, dcum = state(scan())
        dla = dcum.reshape(bsz, c, q, h).flip(2).cumsum(2).flip(2).reshape(bsz, s, h)
        return (dx.to(x.dtype), dla, db.reshape(bsz, s, g, h // g, n).sum(3).to(bm.dtype),
                dc.reshape(bsz, s, g, h // g, n).sum(3).to(cm.dtype))

    return scan, state, whole


def ssd_bwd_cases(libs: dict, dev) -> None:
    """This tree's SSD backward (``libs["this"]``) and the earlier interface's
    (``libs["other"]``) at each of :data:`SSD_BWD_SHAPES`: errors, then
    each kernel's and the whole backward's times in turns."""
    kssd = ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    turns = ("this", "other", "other", "this")
    for name, b, s, h, p, g, n, chunk in SSD_BWD_SHAPES:
        x, la, bm, cm, _ = cs.ssd_inputs(gen, dev, b, s, h, p, g, n, False)
        dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
        q = min(chunk, s)
        with using(kssd, libs["this"]):
            prev, _ = kssd.chunk_state(x, la, bm, chunk=chunk)
            gnext, _, d_total = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk)
        want = kssd.ssd_scan_bwd_plain(x, la, bm, cm, prev, dy, q)[:4]
        scan, state, whole = earlier_backward(libs["other"], x, la, bm, cm, prev, dy,
                                              chunk)
        outs = scan()
        calls = {
            "this": {"state_bwd": lambda: kssd.chunk_state_bwd(dy, la, cm, prev,
                                                               chunk=chunk),
                     "scan_bwd": lambda: kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy,
                                                             gnext, d_total, chunk=chunk),
                     "backward": lambda: kssd.ssd_scan_bwd(x, la, bm, cm, prev, dy,
                                                           chunk=chunk)},
            "other": {"state_bwd": lambda: state(outs), "scan_bwd": scan,
                      "backward": whole}}
        errs = {}
        for ver in ("this", "other"):
            with using(kssd, libs[ver]):
                got = calls[ver]["backward"]()
            torch.cuda.synchronize()
            errs[ver] = {
                what: {"max_abs_err": (a.float() - w.float()).abs().max().item(),
                       "max_bh_rel_err": cs.slab_rel_err(a, w, (0, 2))}
                for what, a, w in zip(("dx", "dlog_a", "dB", "dC"), got, want)}
            del got
        slices = h // kssd.bwd_heads_per_block(h, g) // g
        out = {}
        for part, match in (("state_bwd", "ssd_chunk_state"),
                            ("scan_bwd", "ssd_chunk_scan_bwd"), ("backward", "ssd_chunk")):
            times = {ver: [] for ver in libs}
            kernel = {ver: [] for ver in libs}
            for ver in turns:
                with using(kssd, libs[ver]):
                    times[ver].append(cs.time_ms(calls[ver][part], 10))
                    kernel[ver].append(cs.kernel_ms(calls[ver][part], match))
            floor = {"state_bwd": "chunk_state_bwd", "scan_bwd": "chunk_scan_bwd",
                     "backward": "function"}[part]
            bound_ms, bound_by = cs.bound(*cs.ssd_bwd_floor_ms(b, s, h, p, g, n, chunk,
                                                               floor, slices=slices))
            out[part] = {"ms": times, "kernel_ms": kernel, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        out["backward"]["plain_ms"] = cs.time_ms(
            lambda: kssd.ssd_scan_bwd_plain(x, la, bm, cm, prev, dy, q), 2, 1)
        cs.emit("ssd_bwd_against", case=name, shape=[b, s, h, p, g, n, q],
                heads_per_block=kssd.bwd_heads_per_block(h, g), errors=errs, **out)
        del x, la, bm, cm, dy, prev, gnext, d_total, want, outs, calls
        torch.cuda.empty_cache()


def prefill_pairs(libs: dict, dev, pairs: int, module=flash_attention,
                  archs=("gemma3-1b", "olmoe-1b-7b")) -> None:
    from repro_torch.configs import get
    from repro_torch.models import Model, compute_copy, synthetic_batch

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    models = {}
    for arch in archs:
        cfg = get(arch)
        model = Model(cfg, dev)
        models[arch] = (model, compute_copy(cfg, model.init(seed=0)),
                        synthetic_batch(cfg, 4, 2048, gen, dev))
        torch.cuda.empty_cache()
    seconds = {ver: {arch: [] for arch in models} for ver in libs}
    for i in range(-1, pairs):   # pair -1 warms both builds up: not counted
        for ver in (list(libs) if i % 2 == 0 else list(reversed(libs))):
            run = {}
            with using(module, libs[ver]), torch.inference_mode():
                for arch, (model, params, batch) in models.items():
                    times = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        model.forward(params, batch)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    run[arch] = float(np.median(times))
                    if i >= 0:
                        seconds[ver][arch].append(run[arch])
            cs.emit("prefill_against", pair=i, build=ver, seconds=run)
    cs.emit("prefill_against_summary", pairs=pairs,
            median_seconds={ver: {arch: float(np.median(ts)) for arch, ts in by.items()}
                            for ver, by in seconds.items()},
            seconds=seconds)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("other_csrc", type=Path,
                    help="another tree's src/repro_torch/kernels/csrc")
    ap.add_argument("--serve-pairs", type=int, default=10, help="gmm only")
    ap.add_argument("--prefill-pairs", type=int, default=5, help="fa and ssd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_against: no CUDA device")
    dev = torch.device("cuda")
    module, source = KERNELS[args.kernel]
    libs = {}
    for ver, csrc in (("this", _build.CSRC), ("other", args.other_csrc.resolve())):
        _build.build_log.pop(f"{source}.cu", None)
        libs[ver] = module.bind(_build.library(source, csrc))
        log = _build.build_log.get(f"{source}.cu", "")
        cs.emit("build", build=ver, csrc=str(csrc),
                ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln],
                flags=cs.ptxas_flags(log))
    if args.kernel == "gmm":
        gmm_cases(libs, dev)
        if args.serve_pairs:
            serve_pairs(libs, dev, args.serve_pairs)
    elif args.kernel == "fa":
        fa_cases(libs, dev)
        if args.prefill_pairs:
            prefill_pairs(libs, dev, args.prefill_pairs)
    elif args.kernel == "ssd_bwd":
        ssd_bwd_cases(libs, dev)
    elif args.kernel == "gmm_bwd":
        gmm_bwd_cases(libs, dev)
    else:
        ssd_cases(libs, dev)
        if args.prefill_pairs:
            prefill_pairs(libs, dev, args.prefill_pairs, ssd_scan, ("mamba2-780m",))
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
