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

Under an ambient mesh with M > 1 ``model`` ranks (prefill and training),
each rank runs the heads :func:`repro_torch.distributed.sharding.ssm_view`
gives it: its z, x and dt columns of the packed ``in_proj`` and its x
columns of the conv, the B and C of the groups those heads read (with one
group, B and C whole), its slice of ``A_log``, ``D`` and ``dt_bias``; the
gated norm's sum of squares is summed over ``model`` before the rsqrt, and
``out_proj``'s rows give partial sums (g).  Decode follows the cache's
placement instead (:func:`_decode_model`).

A meta tensor (a dry run) takes the kernels' route at prefill: their
wrappers' meta route allocates what the kernels would and reports their
cost; it never reaches the plain version.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
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
    seq: bool = False,
) -> tuple[torch.Tensor, dict[str, Any] | None]:
    """Mamba2 mixer.  With ``cache`` performs one decode step (S==1) and
    returns the new conv and SSM states (the caller stores them).  With M
    > 1 ``model`` ranks the parameters are this rank's stored shards and
    ``seq`` says x (and the output) is its sequence shard."""
    cd = as_dtype(compute_dtype)
    full_inner = d_inner
    if cache is not None and mesh_ctx.axis_size("model") > 1:
        return _decode_model(x, p, cache, d_inner=d_inner, state_dim=state_dim,
                             head_dim=head_dim, n_groups=n_groups, cd=cd)
    p, x, d_inner, n_groups, leave, sliced = _tp_view(
        p, x, d_inner, state_dim, head_dim, n_groups, seq)
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
    elif x.is_cuda or x.is_meta or use_kernels:
        y, _ = kssd.ssd_scan(x_scaled, log_a, b_mat, c_mat, chunk=chunk)
    else:
        y, _ = ssd_chunked(x_scaled, log_a, b_mat, c_mat, chunk=chunk)

    y = y + xs.to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, d_inner)
    # gated RMSNorm (mamba2: norm(y * silu(z)))
    y = y.float() * F.silu(z.float())
    y = _gated_norm(y.to(cd), p["norm"], 1e-5, full_inner, sliced)
    return leave(y @ cast(p["out_proj"], cd)), new_cache


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float, d_inner: int,
                sliced: bool) -> torch.Tensor:
    """The gated RMSNorm over ``d_inner`` channels; on a ``model`` rank's
    slice of them, with the sum of squares summed over ``model``."""
    if not sliced:
        return rms_norm(y, scale, eps)
    y32 = y.float()
    var = mesh_ctx.model_stat_sum(y32.square().sum(dim=-1, keepdim=True)) / d_inner
    return (y32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(y.dtype)


def _head_groups(t: torch.Tensor, h0: int, h1: int, rep: int) -> torch.Tensor:
    """The B or C rows (B, G, N) that heads [h0, h1) read, for
    :func:`ssd_step` (head h reads group h // rep): the groups the heads
    cover where they are whole groups or lie in one group, else one row
    per head."""
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    if (h0 % rep == 0 and h1 % rep == 0) or g1 - g0 == 1:
        return t[:, g0:g1]
    return t[:, torch.arange(h0, h1, device=t.device) // rep]


def _decode_model(x: torch.Tensor, p: dict[str, Any], cache: dict[str, Any], *,
                  d_inner: int, state_dim: int, head_dim: int, n_groups: int,
                  cd: torch.dtype) -> tuple[torch.Tensor, dict[str, Any]]:
    """One decode step on this ``model`` rank's cache shard, by the cache's
    placement (:func:`repro_torch.distributed.sharding.ssm_cache_view`):
    ``in_proj``'s stored columns give their outputs and the (B, 1, ·) row
    is gathered; the conv runs on the stored channels (its cache shard and
    ``conv_w``/``conv_b`` columns) and its outputs are gathered; the SSM
    step runs on the stored heads, or on all of them where the state is
    stored whole; the gated norm's sum of squares is summed over ``model``
    where the heads are split; ``out_proj``'s stored rows, then g where
    they are split.  Only activations move."""
    m, j = mesh_ctx.axis_size("model"), mesh_ctx.model_rank()
    view = shd.ssm_cache_view(d_inner, head_dim, state_dim, n_groups, m, j)
    bsz = x.shape[0]
    h, gn = d_inner // head_dim, n_groups * state_dim
    in_ch = 2 * d_inner + 2 * gn + h
    zxbcdt = cast(x, cd) @ cast(p["in_proj"], cd)
    if p["in_proj"].shape[-1] != in_ch:
        zxbcdt = mesh_ctx.decode_gather(zxbcdt, -1)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, h], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    c0, c1 = view["conv"]
    xbc_act, conv_state = _causal_conv(xbc[..., c0:c1], p["conv_w"], p["conv_b"],
                                       cache["conv"])
    if view["conv_split"]:
        xbc_act = mesh_ctx.decode_gather(xbc_act, -1)
    xbc_act = F.silu(xbc_act.float()).to(cd)
    xs, b_mat, c_mat = torch.split(xbc_act, [d_inner, gn, gn], dim=-1)

    h0, h1 = view["heads"]
    rep = h // n_groups
    xs = xs.reshape(bsz, h, head_dim)[:, h0:h1]
    dt = dt.reshape(bsz, h)[:, h0:h1]
    a = -torch.exp(p["A_log"].float())[h0:h1]
    x_scaled = xs * dt[..., None].to(cd)
    new_state, y = ssd_step(
        cache["ssm"], x_scaled, dt * a,
        _head_groups(b_mat.reshape(bsz, n_groups, state_dim), h0, h1, rep),
        _head_groups(c_mat.reshape(bsz, n_groups, state_dim), h0, h1, rep))
    y = y + xs.to(y.dtype) * p["D"].to(y.dtype)[h0:h1, None]
    y = y.reshape(bsz, 1, (h1 - h0) * head_dim)
    y = (y.float() * F.silu(z[..., h0 * head_dim:h1 * head_dim].float())).to(cd)
    # the gated norm over d_inner: a sum of squares over the rank's heads,
    # summed over model where they are split; then out_proj's stored rows
    y32 = y.float()
    sq = y32.square().sum(dim=-1, keepdim=True)
    if not view["whole"]:
        sq = mesh_ctx.decode_sum(sq)
    wo = p["out_proj"]
    r0, r1 = shd.leaf_block(d_inner, wo.shape[-2], m, j)
    y32 = y32[..., r0 - h0 * head_dim:r1 - h0 * head_dim]
    y = (y32 * torch.rsqrt(sq / d_inner + 1e-5) * (1.0 + p["norm"].float())).to(cd)
    out = y @ cast(wo, cd)
    if wo.shape[-2] != d_inner:
        out = mesh_ctx.model_sum(out)
    return out, {"conv": conv_state, "ssm": new_state, "pos": cache["pos"] + 1}


def _tp_view(p: dict[str, Any], x: torch.Tensor, d_inner: int, state_dim: int,
             head_dim: int, n_groups: int, seq: bool):
    """(parameters, x, d_inner, groups, the output's way out, sliced) of
    this ``model`` rank: with one rank, all as given."""
    m = mesh_ctx.axis_size("model")
    if m == 1:
        return p, x, d_inner, n_groups, lambda y: y, False
    h = d_inner // head_dim
    gn = n_groups * state_dim
    view = shd.ssm_view(d_inner, head_dim, state_dim, n_groups, m,
                        mesh_ctx.model_rank())
    sliced = view is not None
    conv_ch, in_ch = d_inner + 2 * gn, 2 * d_inner + 2 * gn + h
    if sliced:
        (h0, h1), (g0, g1) = view["heads"], view["groups"]
        heads, inner = ((h0, h1),), view["inner"]
        in_r, conv_r = view["in_proj"], view["conv"]
    else:
        heads, inner = ((0, h),), ((0, d_inner),)
        in_r, conv_r = ((0, in_ch),), ((0, conv_ch),)
    where = {"in_proj": (-1, in_r, in_ch), "conv_w": (-1, conv_r, conv_ch),
             "conv_b": (-1, conv_r, conv_ch), "norm": (-1, inner, d_inner),
             "out_proj": (-2, inner, d_inner), "A_log": (-1, heads, h),
             "D": (-1, heads, h), "dt_bias": (-1, heads, h)}
    local = {k: mesh_ctx.model_view(w, where[k][0], where[k][1], where[k][2],
                                    sliced=sliced) for k, w in p.items()}
    if not sliced:
        return (local, mesh_ctx.enter_replicated(x, seq), d_inner, n_groups,
                lambda y: mesh_ctx.leave_replicated(y, seq), False)
    return (local, mesh_ctx.enter(x, seq), (h1 - h0) * head_dim, g1 - g0,
            lambda y: mesh_ctx.leave(y, seq), True)


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
