"""What each kernel of the port must do: its operations and the bytes it
must move, as pure functions of its shapes, and the reports its wrappers
make.

One formula a kernel, read by ``chip_smoke.py``'s bounds (the least time
the card could take) and by the dry run's counter
(:mod:`repro_torch.launch.costs`): the kernels launch through ctypes, so
no dispatch mode sees them, and each wrapper reports its own call here
(:func:`report`, to :mod:`repro_torch.events`), on the card where it
launches and on the meta route where a dry run stands in for the launch.

Each function returns ``(operations, bytes)``: tensor-core FLOPs (bf16)
and the bytes of each input read once and each output written once (the
kernel's own reads and writes, for one kernel of a pair).
"""
from __future__ import annotations

import numpy as np

from repro_torch import events


def meta_route(t) -> bool:
    """Whether a kernel entry takes its meta route for ``t``: a meta tensor
    while a counter listens (a dry run, :func:`repro_torch.events.counting`).
    Without one a meta tensor has no launch to stand in for, and the entry
    raises as for any device without a kernel."""
    return t.device.type == "meta" and events.active()


def report(name: str, formula, *shape, **options) -> None:
    """A wrapper's report of one call of kernel ``name``, whose (flops,
    bytes) are ``formula(*shape, **options)``: worked out only while a
    counter listens, so a launch with none pays one list check."""
    if events.active():
        events.report(events.KERNEL, name, *formula(*shape, **options))


def mask_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows: the work an attention call must do."""
    q = np.arange(s, dtype=np.int64)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, np.int64)
    return int((hi - lo + 1).sum())


def attention(b: int, s: int, hq: int, hkv: int, d: int, causal: bool,
              window: int) -> tuple[int, int]:
    """The flash-attention forward: 4·B·Hq·D FLOPs per allowed (q, k) pair;
    Q, K, V read and O written once, in bf16."""
    flops = 4 * b * hq * d * mask_pairs(s, causal, window)
    return flops, 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)


def attention_bwd(b: int, s: int, hq: int, hkv: int, d: int, causal: bool,
                  window: int) -> tuple[int, int]:
    """The attention backward: five products per allowed (q, k) pair (S,
    dP, dV, dQ, dK), so 2.5x the forward's FLOPs; q, k, v, O, dO and dQ,
    dK, dV once in bf16 and the LSE once in fp32."""
    flops = 10 * b * hq * d * mask_pairs(s, causal, window)
    return flops, 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s


def ssd(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
        part: str = "function", init_bytes: int = 0) -> tuple[int, int]:
    """The SSD scan's forward, whole (``part="function"``) or one kernel's
    own reads and writes (``"chunk_state"``, ``"chunk_scan"``).  Operations
    are the chunked algorithm's: C·Bᵀ once per group and (scores)·X over
    the allowed (i, j ≤ i) pairs of each chunk, the chunk states and the
    inter-chunk term.  Bytes: x, y, B, C, the final state in bf16, log_a
    fp32, the initial state at ``init_bytes`` an element (0: none), and
    the fp32 passed states (one per chunk) that go from the first kernel
    to the second."""
    q = min(chunk, s)
    c = s // q
    pairs = c * q * (q + 1) // 2
    x = 2 * b * s * h * p                 # x, and y alike
    la = 4 * b * s * h
    bc = 2 * b * s * g * n                # B, and C alike
    states = 4 * b * h * c * p * n
    final = 2 * b * h * p * n
    init = init_bytes * b * h * p * n
    f_state = 2 * b * h * s * p * n
    f_scan = 2 * b * g * pairs * n + 2 * b * h * pairs * p + 2 * b * h * s * n * p
    return {
        "chunk_state": (f_state, x + la + bc + init + states + final),
        "chunk_scan": (f_scan, 2 * x + la + 2 * bc + states),
        "function": (f_state + f_scan, 2 * x + la + 2 * bc + final + init),
    }[part]


def ssd_bwd(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
            part: str, dfinal: bool = False, init: bool = False,
            slices: int = 1) -> tuple[int, int]:
    """The SSD scan's whole backward (``part="function"``) or one call of a
    backward kernel, its own reads and writes each counted once.

    Operations: C·Bᵀ once per group and dS = dy·xᵀ, dx, dB and dC over the
    allowed (i, j ≤ i) pairs, the inter term prev_cᵀ·dy, dprev and the
    chunk-state term's G·B_j and Gᵀ·x_j over every step.
    ``"chunk_state_bwd"``: dprev; reads dy and C (bf16), log_a, prev (fp32,
    for dT) and dfinal, writes G_c+1, G_0 and dT (fp32).
    ``"chunk_scan_bwd"``: the rest; reads x, dy, B, C (bf16), log_a, prev,
    G_c+1 and dT, writes dx (bf16), dlog_a and dB and dC as ``slices``
    fp32 slices a group.  ``"function"``: both; reads x, dy, B, C, log_a,
    prev and dfinal once and writes dx, dlog_a, dB and dC (in their inputs'
    dtypes) and the initial state's gradient once."""
    q = min(chunk, s)
    c = s // q
    pairs = c * q * (q + 1) // 2
    x = 2 * b * s * h * p                 # x, dy and dx alike (bf16)
    bc = 2 * b * s * g * n                # B, C, dB and dC alike (bf16)
    la = 4 * b * s * h                    # log_a, and dlog_a alike (fp32)
    states = 4 * b * h * c * p * n        # prev, and G alike (fp32)
    fin = 4 * b * h * p * n               # dfinal, and G_0 alike (fp32)
    dt = 4 * b * h * c
    slab = 4 * b * s * g * slices * n     # dB, and dC alike, as fp32 slices
    f_state = 2 * b * h * s * p * n
    f_scan = 2 * b * g * pairs * n + 2 * b * h * pairs * (2 * p + 2 * n) \
        + 6 * b * h * s * p * n
    dfin = fin if dfinal else 0
    return {
        "chunk_state_bwd": (f_state, x + bc + la + states + dfin + states + fin + dt),
        "chunk_scan_bwd": (f_scan, 2 * x + 2 * bc + la + 2 * states + dt
                           + x + la + 2 * slab),
        "function": (f_state + f_scan, 2 * x + 2 * bc + la + states + dfin
                     + x + la + 2 * bc + (fin if init else 0)),
    }[part]


def gmm(t: int, d: int, f: int, nonempty: int) -> tuple[int, int]:
    """One grouped matmul of T rows (d -> f) over ``nonempty`` experts that
    have rows: 2·T·d·f FLOPs; x and y read and written once and the
    weights of the non-empty experts read once, all bf16.  (dx = dy·w[e]ᵀ
    moves what the forward moves, with d and f in the forward's roles.)
    The wrappers never read the group sizes on the host, so they report
    every expert as non-empty."""
    return 2 * t * d * f, 2 * (t * d + nonempty * d * f + t * f)


def gmm_dw(t: int, d: int, f: int, experts: int) -> tuple[int, int]:
    """One dw = x_eᵀ·dy_e over T rows: 2·T·d·f FLOPs; x (T, d) and dy (T, f)
    read once, dw (E, d, f) written once (every expert's slab, the empty
    ones' zeros too), bf16."""
    return 2 * t * d * f, 2 * (t * d + t * f + experts * d * f)
