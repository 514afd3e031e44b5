"""Mamba2 SSD (state-space duality) block — arXiv:2405.21060.

Port of ``repro.models.ssm``.  The SSD recurrence per head h with state
(P, N):

    a_t = exp(dt_t · A_h)                       (scalar decay, A_h < 0)
    h_t = a_t · h_{t-1} + dt_t · x_t ⊗ B_t      (outer product update)
    y_t = C_t · h_t + D_h · x_t

Prefill on a CUDA tensor always goes to the SSD kernels
(:func:`repro_torch.kernels.ssd_scan.ssd_scan`), whatever ``use_kernels``
says.  On a CPU tensor ``use_kernels=True`` takes the kernels' plain
version and ``False`` the chunked XLA-path algorithm :func:`ssd_chunked`,
the reference's two branches.  G groups serve H heads: head h reads group
h // (H/G), nothing is repeated to H heads.

Block layout follows mamba_ssm's Mamba2: fused in_proj → causal depthwise
conv over (x,B,C) → SSD → gated RMSNorm → out_proj.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as kssd

from .layers import as_dtype, cast, rms_norm


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)  — dt-scaled inputs
    log_a: torch.Tensor,  # (B, S, H)     — per-step log decay (dt·A, ≤ 0)
    b_mat: torch.Tensor,  # (B, S, G, N)
    c_mat: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (the reference's XLA path).  Returns (y (B,S,H,P),
    final_state (B,H,P,N)), both in x's dtype.  Unlike the kernels it
    rounds the intra-chunk scores to x's dtype before they multiply x
    (reference ``ssm.py:69``)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    c = s // q
    rep = h // g

    xq = x.reshape(bsz, c, q, g, rep, p)
    la = log_a.reshape(bsz, c, q, g, rep).float()
    bq = b_mat.reshape(bsz, c, q, g, n).float()
    cq = c_mat.reshape(bsz, c, q, g, n).float()

    cum = la.cumsum(dim=2)                                # (B,C,Q,G,R) inclusive

    # ---- intra-chunk (quadratic in Q) --------------------------------
    # decay(i←j) = exp(cum_i - cum_j) for j ≤ i; the masked (j > i)
    # entries have positive exponents, so the argument is masked before exp
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, None, :, :, None, None]
    delta = torch.where(mask, cum[:, :, :, None] - cum[:, :, None], 0.0)
    decay = torch.where(mask, delta.exp(), 0.0)           # (B,C,Qi,Qj,G,R) fp32
    scores = torch.einsum("bcign,bcjgn->bcijg", cq, bq)[..., None] * decay
    y_intra = torch.einsum("bcijgr,bcjgrp->bcigrp", scores.to(x.dtype), xq)

    # ---- chunk states, passed along the chunks in order (fp32) --------
    # the same math as the kernels' plain version: the state entering each
    # chunk (B, H, C, P, N) and the final state
    prev, final = kssd.chunk_state_plain(x, log_a, b_mat, q, initial_state)

    # ---- inter-chunk output contribution ------------------------------
    y_inter = torch.einsum("bcign,bgrcpn->bcigrp", cq,
                           prev.reshape(bsz, g, rep, c, p, n)) * cum.exp()[..., None]
    y = (y_intra.float() + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), final


def ssd_step(
    state: torch.Tensor,    # (B, H, P, N) fp32
    x_t: torch.Tensor,      # (B, H, P) — dt-scaled input
    log_a_t: torch.Tensor,  # (B, H)
    b_t: torch.Tensor,      # (B, G, N)
    c_t: torch.Tensor,      # (B, G, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the SSD recurrence → (new state fp32, y)."""
    bsz, h, p = x_t.shape
    g, n = b_t.shape[1], b_t.shape[2]
    rep = h // g
    a = torch.exp(log_a_t.float()).reshape(bsz, g, rep, 1, 1)
    xg = x_t.float().reshape(bsz, g, rep, p)
    new_state = (state.reshape(bsz, g, rep, p, n) * a
                 + torch.einsum("bgrp,bgn->bgrpn", xg, b_t.float()))
    y = torch.einsum("bgrpn,bgn->bgrp", new_state, c_t.float())
    return new_state.reshape(bsz, h, p, n), y.reshape(bsz, h, p).to(x_t.dtype)


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv1d, kernel size K, fp32 math.  x (B,S,C); w (K,C).

    With ``state`` (B,K-1,C) performs a streaming step (S==1) and returns
    the new state in the promoted dtype of state and x, as the reference's
    concatenation does."""
    k = w.shape[0]
    w32 = w.float()
    if state is not None:
        dt = torch.promote_types(state.dtype, x.dtype)
        window = torch.cat([state.to(dt), x.to(dt)], dim=1)        # (B,K,C)
        y = torch.einsum("bkc,kc->bc", window.float(), w32)[:, None, :]
        return (y + b.float()).to(x.dtype), window[:, 1:]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0)).float()                       # (B,S+K-1,C)
    # y_t = Σ_k w_k · x_{t-K+1+k}, then the bias, in the reference's order
    y = pad[:, :s] * w32[0]
    for i in range(1, k):
        y += pad[:, i:i + s] * w32[i]
    return (y + b.float()).to(x.dtype), None


def mamba2_block(
    x: torch.Tensor,                 # (B, S, d)
    p: dict[str, Any],
    *,
    d_inner: int,
    state_dim: int,
    head_dim: int,
    n_groups: int,
    conv_width: int,
    chunk: int,
    compute_dtype: str | torch.dtype = torch.bfloat16,
    cache: dict[str, Any] | None = None,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, dict[str, Any] | None]:
    """Mamba2 mixer.  With ``cache`` performs one decode step (S==1) and
    returns the new conv and SSM states (the caller stores them)."""
    cd = as_dtype(compute_dtype)
    bsz, s, _ = x.shape
    n_heads = d_inner // head_dim
    gn = n_groups * state_dim
    xc = cast(x, cd)

    zxbcdt = xc @ cast(p["in_proj"], cd)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, n_heads],
                                 dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if cache is not None:
        xbc_act, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                           cache["conv"])
    else:
        xbc_act, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc_act = F.silu(xbc_act.float()).to(cd)
    xs, b_mat, c_mat = torch.split(xbc_act, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, s, n_heads, head_dim)
    b_mat = b_mat.reshape(bsz, s, n_groups, state_dim)   # views: read in place
    c_mat = c_mat.reshape(bsz, s, n_groups, state_dim)

    a = -torch.exp(p["A_log"].float())                       # (H,) negative
    log_a = dt.reshape(bsz, s, n_heads) * a                  # (B,S,H)
    x_scaled = xs * dt.reshape(bsz, s, n_heads, 1).to(cd)

    new_cache = None
    if cache is not None:
        new_state, y = ssd_step(cache["ssm"], x_scaled[:, 0], log_a[:, 0],
                                b_mat[:, 0], c_mat[:, 0])
        y = y[:, None]
        new_cache = {"conv": conv_state, "ssm": new_state,
                     "pos": cache["pos"] + 1}
    elif x.is_cuda or use_kernels:
        y, _ = kssd.ssd_scan(x_scaled, log_a, b_mat, c_mat, chunk=chunk)
    else:
        y, _ = ssd_chunked(x_scaled, log_a, b_mat, c_mat, chunk=chunk)

    y = y + xs.to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, d_inner)
    # gated RMSNorm (mamba2: norm(y * silu(z)))
    y = y.float() * F.silu(z.float())
    y = rms_norm(y.to(cd), p["norm"], 1e-5)
    return y @ cast(p["out_proj"], cd), new_cache


def init_ssm_cache(bsz: int, d_inner: int, state_dim: int, head_dim: int,
                   n_groups: int, conv_width: int,
                   dtype: str | torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> dict[str, Any]:
    """Conv state in ``dtype``, SSM state in fp32, ``pos`` a Python int."""
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * n_groups * state_dim
    return {
        "conv": torch.zeros((bsz, conv_width - 1, conv_ch),
                            dtype=as_dtype(dtype), device=device),
        "ssm": torch.zeros((bsz, n_heads, head_dim, state_dim),
                           dtype=torch.float32, device=device),
        "pos": 0,
    }
