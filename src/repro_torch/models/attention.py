"""Attention: GQA/MQA/MHA, causal + bidirectional, sliding-window.

Port of ``repro.models.attention``.  Shapes: q (B,S,Hq,D); k,v
(B,S,Hkv,D); GQA groups Hq into Hkv bundles.

* ``full_attention``  — S×S masked attention (causal or bidirectional).
* ``local_attention`` — chunk-banded SWA over the own and previous chunk.
* ``decode_attention``— one query against a KV cache (online softmax over
  cache blocks, plain torch: the reference has no kernel for it).

``attn_block`` sends prefill attention on a CUDA tensor to the
flash-attention kernel, whatever ``use_kernels`` says; on a CPU tensor it
takes the reference's branches exactly.

Under an ambient mesh with M > 1 ``model`` ranks, prefill and training
compute on each rank the query heads that
:func:`repro_torch.distributed.sharding.attn_view` gives it, whole KV
groups or, with fewer KV heads than ranks, part of one group whose KV
head it computes whole; RoPE and ``qk_norm`` see whole heads.  Where the
heads do not split, every rank runs the block whole.  Decode follows the
cache's placement instead (:func:`repro_torch.distributed.sharding.cache_view`,
:func:`_decode_model`): a rank stores whole KV heads, or a slice of every
head's dim, and computes what it stores; only small activations move.

``attn_block`` sends prefill attention on a meta tensor (a dry run) to
the kernel's wrapper too, whose meta route allocates what the kernel
would and reports its cost; a meta tensor never reaches the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as fa

from .layers import apply_rope, as_dtype, cast, rms_norm, scalar

NEG_INF = -2.0e38


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def _repeat_kv(k: torch.Tensor, n_q: int) -> torch.Tensor:
    """GQA → MHA expansion: (B,S,Hkv,D) → (B,S,Hq,D)."""
    hkv = k.shape[2]
    if hkv == n_q:
        return k
    return k.repeat_interleave(n_q // hkv, dim=2)


def _sdp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None, softcap: float) -> torch.Tensor:
    """Masked softmax(QKᵀ)V on (B,S,H,D) operands, softmax in fp32.

    q is scaled in its own dtype; the score dot is then taken on fp32
    operands, because the reference's dot has an fp32 accumulator and an
    fp32 result (``preferred_element_type``) where a bf16 ``matmul`` would
    round the scores to bf16.  The probs go back to v's dtype before PV."""
    d = q.shape[-1]
    qs = q * scalar(d ** -0.5, q)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    scores = _softcap(scores, softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, softcap: float = 0.0,
                   q_chunk: int = 0) -> torch.Tensor:
    """Masked softmax attention; ``q_chunk`` > 0 streams query blocks so
    the score buffer never exceeds (q_chunk, Sk)."""
    b, sq, hq, d = q.shape
    kf = _repeat_kv(k, hq)
    vf = _repeat_kv(v, hq)
    sk = kf.shape[1]

    if not q_chunk or sq <= q_chunk:
        mask = None
        if causal:
            mask = torch.ones((sq, sk), dtype=torch.bool,
                              device=q.device).tril(diagonal=sk - sq)
        return _sdp(q, kf, vf, mask, softcap)

    if sq % q_chunk:
        raise ValueError(f"seq {sq} is not a multiple of q_chunk {q_chunk}")
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for start in range(0, sq, q_chunk):
        mask = None
        if causal:
            qpos = start + torch.arange(q_chunk, device=q.device)[:, None]
            mask = qpos >= kpos
        outs.append(_sdp(q[:, start:start + q_chunk], kf, vf, mask, softcap))
    return torch.cat(outs, dim=1)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, causal: bool = True,
                    q_chunk: int = 0) -> torch.Tensor:
    """Chunk-banded sliding-window attention.

    Queries in chunk c attend to keys in chunks c-1 and c, masked to the
    true window: allowed iff 0 <= q_pos - k_pos < window.  Unlike ``_sdp``,
    the unchunked path takes the score einsum in the input dtype and casts
    to fp32 after it, as the reference does (attention.py:153-154)."""
    b, s, hq, d = q.shape
    w = min(window, s)
    pad = (w - s % w) % w
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    sp = q.shape[1]
    c = sp // w
    kf = _repeat_kv(k, hq)
    vf = _repeat_kv(v, hq)
    qc = q.reshape(b, c, w, hq, d)
    kc = kf.reshape(b, c, w, hq, d)
    vc = vf.reshape(b, c, w, hq, d)
    # previous chunk: shift right; chunk 0's "previous" is masked out
    k2 = torch.cat([torch.roll(kc, 1, dims=1), kc], dim=2)      # (B,C,2W,·)
    v2 = torch.cat([torch.roll(vc, 1, dims=1), vc], dim=2)

    i = torch.arange(w, device=q.device)[:, None]
    j = torch.arange(2 * w, device=q.device)[None, :]
    dist = i + w - j
    band = (dist >= 0) & (dist < w) if causal else (dist.abs() < w)

    if q_chunk:
        outs = []
        for idx in range(c):
            mask = band & ~((idx == 0) & (j < w))                # (W, 2W)
            outs.append(_sdp(qc[:, idx], k2[:, idx], v2[:, idx],
                             mask[None, None], 0.0))
        out = torch.stack(outs, dim=1)
    else:
        scores = torch.einsum("bcqhd,bckhd->bchqk", qc * scalar(d ** -0.5, qc),
                              k2).float()
        chunk_idx = torch.arange(c, device=q.device)[:, None, None]
        mask = band[None] & ~((chunk_idx == 0) & (j[None] < w))  # (C,W,2W)
        scores = torch.where(mask[None, :, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bchqk,bckhd->bcqhd", probs, v2)
    out = out.reshape(b, sp, hq, d)
    return out[:, :s] if pad else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     softcap: float = 0.0, *, head_dim: int = 0,
                     score_sum=None) -> torch.Tensor:
    """One new query per sequence against the KV cache.

    q (B,1,Hq,D); caches (B,T,Hkv,D); lengths (B,) valid entries.  The
    reference's flash-decode: cache blocks of up to 4096 entries under an
    online softmax in fp32; products in the cache dtype, sums in fp32.

    For a rank that holds a slice of every head's dim (decode over
    ``model``), D is the slice, ``head_dim`` the whole head's (the scale's
    1/sqrt) and ``score_sum`` sums each block's partial scores over the
    ranks before the softmax; the output is the rank's slice of every
    head's."""
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    q0 = q[:, 0].reshape(b, hkv, g, d)
    qg = q0 * scalar((head_dim or d) ** -0.5, q0)                # (B,Hkv,G,D)
    blk = t if t % 4096 else 4096

    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for start in range(0, t, blk):
        k_blk = k_cache[:, start:start + blk]
        v_blk = v_cache[:, start:start + blk]
        s = torch.sum(qg[:, None] * k_blk[:, :, :, None, :], dim=-1,
                      dtype=torch.float32)                       # (B,blk,Hkv,G)
        if score_sum is not None:
            s = score_sum(s)
        s = _softcap(s, softcap)
        kpos = start + torch.arange(blk, device=q.device)
        valid = (kpos[None, :] < lengths[:, None])[:, :, None, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=1))                  # (B,Hkv,G)
        p = torch.exp(s - m_new[:, None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[..., None] + torch.sum(
            p[..., None].to(v_blk.dtype) * v_blk[:, :, :, None, :],
            dim=1, dtype=torch.float32)                          # (B,Hkv,G,D)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention sub-block (projections + rope + attention + out-proj)
# ---------------------------------------------------------------------------

def attn_block(
    x: torch.Tensor,
    p: dict[str, torch.Tensor],
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    kind: str,                 # attn | swa | enc
    window: int,
    positions: torch.Tensor,
    rope_theta: float,
    q_chunk: int = 0,
    softcap: float = 0.0,
    qk_norm: bool = False,
    norm_eps: float = 1e-6,
    compute_dtype: str | torch.dtype = torch.bfloat16,
    use_kernels: bool = False,
    cache: dict | None = None,
    seq: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """Complete attention sub-layer.  With ``cache`` (decode), x is
    (B,1,d) and the cache tensors are written in place at ``cache['pos']``
    (the cache's 0-d tensor, or a Python int), where the reference returns
    updated copies.  With M > 1 ``model`` ranks the parameters are this
    rank's stored shards and ``seq`` says x (and the output) is its
    sequence shard."""
    cd = as_dtype(compute_dtype)
    m = mesh_ctx.axis_size("model")
    if cache is not None:
        return _decode_model(
            x, p, cache, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
            kind=kind, window=window, positions=positions, rope_theta=rope_theta,
            softcap=softcap, qk_norm=qk_norm, norm_eps=norm_eps, cd=cd)
    p, x, n_heads, n_kv_heads, leave = _tp_view(
        p, x, m, n_heads, n_kv_heads, head_dim, seq)
    b, s, _ = x.shape
    xc = cast(x, cd)
    q = (xc @ cast(p["wq"], cd)).reshape(b, s, n_heads, head_dim)
    k = (xc @ cast(p["wk"], cd)).reshape(b, s, n_kv_heads, head_dim)
    v = (xc @ cast(p["wv"], cd)).reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if x.is_cuda or x.is_meta:
        # all prefill attention on the card goes to the kernel, including
        # swa with s > window (its window mask is exact) and enc
        # (bidirectional); a meta tensor takes the kernel's meta route
        if softcap and softcap > 0:
            raise NotImplementedError(
                "the flash-attention kernel has no logit softcap")
        out = fa.flash_attention(q, k, v, causal=kind != "enc",
                                 window=window if kind == "swa" else 0)
    elif kind == "swa" and window and s > window:
        out = local_attention(q, k, v, window, causal=True, q_chunk=q_chunk)
    elif kind == "enc":
        out = full_attention(q, k, v, causal=False, softcap=softcap,
                             q_chunk=q_chunk)
    elif use_kernels:
        out = fa.flash_attention(q, k, v, causal=True,
                                 window=window if kind == "swa" else 0)
    else:
        out = full_attention(q, k, v, causal=True, softcap=softcap,
                             q_chunk=q_chunk)
    out = out.reshape(b, s, n_heads * head_dim)
    return leave(out @ cast(p["wo"], cd)), None


def _decode_write_attend(q, k, v, cache: dict, kind: str, window: int,
                         softcap: float, head_dim: int = 0, score_sum=None):
    """Decode: write k, v at ``pos`` (ring slot pos % t for SWA), then
    attend.  Returns (out, the new cache).  ``pos`` is the cache's 0-d
    tensor or a Python int; the slot and the valid length are formed on
    the device (a remainder and a clamp, then ``index_copy_``), so the
    write neither synchronises nor bakes the position into a captured
    graph."""
    b = q.shape[0]
    t = cache["k"].shape[1]
    pos = cache["pos"]
    at = (pos if isinstance(pos, torch.Tensor)
          else torch.full((), pos, device=q.device)).reshape(1).long()
    # a ring's slot; past a full cache, dynamic_update_slice clamps its start
    slot = (torch.remainder(at, t) if kind == "swa" and window > 0
            else at.clamp(max=t - 1))
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    lengths = (at + 1).clamp(max=t).expand(b)
    out = decode_attention(q, cache["k"], cache["v"], lengths, softcap,
                           head_dim=head_dim, score_sum=score_sum)
    return out, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _decode_model(x: torch.Tensor, p: dict[str, torch.Tensor], cache: dict, *,
                  n_heads: int, n_kv_heads: int, head_dim: int, kind: str,
                  window: int, positions: torch.Tensor, rope_theta: float,
                  softcap: float, qk_norm: bool, norm_eps: float,
                  cd: torch.dtype) -> tuple[torch.Tensor, dict]:
    """One decode step on this ``model`` rank's cache shard, by the cache's
    placement (:func:`repro_torch.distributed.sharding.attn_cache_view`);
    with one ``model`` rank the shard is the whole cache and nothing moves.
    Each projection is the product of x (B, 1, d) with the rank's stored
    columns; a row is gathered only where those are not the heads the rank
    computes.  KV heads split: the rank's KV heads and their query groups
    from its own columns, no gather.  Head dim split: q, k and v formed
    whole (RoPE and ``qk_norm`` read whole heads), sliced to the stored
    range, scores over the slice summed over ``model``, and each head's
    output slices gathered for ``wo``'s stored rows.  Then ``wo``'s rows
    and g (the sum over ``model``) where ``wo`` is split."""
    m, j = mesh_ctx.axis_size("model"), mesh_ctx.model_rank()
    view = shd.attn_cache_view(n_heads, n_kv_heads, head_dim, m, j)
    d = head_dim
    (q0, q1), (k0, k1), (d0, d1) = view["q_heads"], view["kv_heads"], view["d"]
    b = x.shape[0]
    xc = cast(x, cd)

    def proj(key: str, heads: int, want: tuple[int, int]) -> torch.Tensor:
        w = p[key]
        y = xc @ cast(w, cd)
        if shd.leaf_block(heads * d, w.shape[-1], m, j) == (want[0] * d, want[1] * d):
            return y
        if w.shape[-1] != heads * d:
            y = mesh_ctx.decode_gather(y, -1)
        return y[..., want[0] * d:want[1] * d]

    q = proj("wq", n_heads, (q0, q1)).reshape(b, 1, q1 - q0, d)
    k = proj("wk", n_kv_heads, (k0, k1)).reshape(b, 1, k1 - k0, d)
    v = proj("wv", n_kv_heads, (k0, k1)).reshape(b, 1, k1 - k0, d)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    split_d = view["split"] == "d"
    if split_d:
        q, k, v = (t[..., d0:d1] for t in (q, k, v))
    out, new_cache = _decode_write_attend(
        q, k, v, cache, kind, window, softcap, head_dim=d,
        score_sum=mesh_ctx.decode_sum if split_d else None)
    if split_d:
        out = mesh_ctx.decode_gather(out, -1)
    out = out.reshape(b, 1, (q1 - q0) * d)
    wo = p["wo"]
    rows = shd.leaf_block(n_heads * d, wo.shape[-2], m, j)
    if rows != (q0 * d, q1 * d):
        out = out[..., rows[0] - q0 * d:rows[1] - q0 * d]
    y = out @ cast(wo, cd)
    return (mesh_ctx.model_sum(y) if wo.shape[-2] != n_heads * d else y), new_cache


def _tp_view(p: dict[str, torch.Tensor], x: torch.Tensor, m: int, n_heads: int,
             n_kv_heads: int, head_dim: int, seq: bool):
    """(parameters, x, query heads, KV heads, the output's way out) of this
    ``model`` rank: with one rank, all as given and the identity."""
    if m == 1:
        return p, x, n_heads, n_kv_heads, lambda y: y
    view = shd.attn_view(n_heads, n_kv_heads, head_dim, m, mesh_ctx.model_rank())
    sliced = view is not None
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    # (dim, whole size) of each leaf; q_norm and k_norm: every head reads them
    where = {"wq": (-1, q_dim), "wk": (-1, kv_dim), "wv": (-1, kv_dim),
             "wo": (-2, q_dim), "q_norm": (0, head_dim), "k_norm": (0, head_dim)}

    def one(key, w):
        dim, size = where[key]
        ranges = view[key] if sliced and key in view else ((0, size),)
        return mesh_ctx.model_view(w, dim, ranges, size, sliced=sliced)

    local = {k: one(k, w) for k, w in p.items()}
    if not sliced:
        return (local, mesh_ctx.enter_replicated(x, seq), n_heads, n_kv_heads,
                lambda y: mesh_ctx.leave_replicated(y, seq))
    (h0, h1), (k0, k1) = view["heads"], view["kv_heads"]
    return (local, mesh_ctx.enter(x, seq), h1 - h0, k1 - k0,
            lambda y: mesh_ctx.leave(y, seq))

