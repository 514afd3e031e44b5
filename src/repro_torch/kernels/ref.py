"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def _scaled_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 scores q·k / sqrt(D) as (B, Hkv, G, S, S) and the (S, S) mask."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).float() * d ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = i >= j
    if window > 0:
        mask = mask & (i - j < window)
    return scores, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense masked attention oracle. q (B,S,Hq,D); k,v (B,S,Hkv,D).

    Scores, softmax and PV in fp32; output in q's dtype."""
    b, s, hq, d = q.shape
    scores, mask = _scaled_scores(q, k, causal, window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of its masked scaled scores, (B, Hq, S) fp32,
    natural log; -inf for a row whose every key is masked."""
    b, s, hq, _ = q.shape
    scores, mask = _scaled_scores(q, k, causal, window)
    lse = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return lse.reshape(b, hq, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            *, causal: bool = True, window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of attention from the forward's output ``o`` and its rows'
    log-sum-exp ``lse`` (B, Hq, S), densely in fp32 (FA2's formulas):
    delta = rowsum(dO∘O), P = exp(QKᵀ·scale − LSE), dV = PᵀdO,
    dS = P∘(dO·Vᵀ − delta), dQ = dS·K·scale, dK = dSᵀ·Q·scale.  dK and dV
    sum over the query heads of each KV group.  A row whose LSE is -inf
    (it saw no key) has P = 0.  Returns (dq, dk, dv) in q's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scores, mask = _scaled_scores(q, k, causal, window)
    lse_g = lse.float().reshape(b, hkv, g, s)[..., None]
    live = mask & torch.isfinite(lse_g)
    p = torch.where(live, torch.exp(scores - torch.where(live, lse_g, 0.0)), 0.0)
    do_g = do.reshape(b, s, hkv, g, d).float()
    o_g = o.reshape(b, s, hkv, g, d).float()
    delta = (do_g * o_g).sum(-1).permute(0, 2, 3, 1)[..., None]    # (B,Hkv,G,S,1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do_g)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do_g, v.float())
    ds = p * (dp - delta)
    scale = d ** -0.5
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.reshape(b, s, hkv, g, d).float()) * scale
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))


def ssd_scan_ref(x: torch.Tensor, log_a: torch.Tensor, b_mat: torch.Tensor,
                 c_mat: torch.Tensor, initial_state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential SSD recurrence, one time step at a time, in fp32.

    x (B,S,H,P); log_a (B,S,H); b_mat, c_mat (B,S,G,N); initial_state
    (B,H,P,N).  Returns (y (B,S,H,P), final state (B,H,P,N)), both in x's
    dtype.  Head h reads group h // (H/G)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    bh = b_mat.float().repeat_interleave(rep, dim=2)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        a = torch.exp(log_a[:, t].float())[..., None, None]
        state = state * a + torch.einsum("bhp,bhn->bhpn", x[:, t].float(),
                                         bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Per-row expert matmul oracle: ``y[t] = x[t] @ w[expert_of(t)]`` for
    rows sorted by expert.  x (T,d); w (E,d,f); group_sizes (E,) summing to
    T.  Products and sums in fp32; output (T,f) in x's dtype.

    One product per non-empty expert over its rows, at offsets from a
    cumulative sum, rather than the (T,d,f) gathered weight the JAX oracle
    builds (at olmoe-1b-7b prefill that tensor would be 550 GB)."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for e, start, end in _groups(group_sizes):
        out[start:end] = x[start:end].float() @ w[e].float()
    return out.to(x.dtype)


def _groups(group_sizes: torch.Tensor) -> list[tuple[int, int, int]]:
    """(expert, first row, end row) of each expert that has rows."""
    ends = torch.cumsum(group_sizes, 0).tolist()
    return [(e, start, end) for e, (start, end) in enumerate(zip([0] + ends, ends))
            if end > start]


def grouped_matmul_dx_ref(dy: torch.Tensor, w: torch.Tensor,
                          group_sizes: torch.Tensor) -> torch.Tensor:
    """The grouped matmul's gradient for x: ``dx[t] = dy[t] @ w[e(t)]ᵀ``.
    dy (T,f) rows sorted by expert; w (E,d,f).  fp32 products, one per
    non-empty expert; output (T,d) in dy's dtype."""
    out = torch.zeros((dy.shape[0], w.shape[1]), dtype=torch.float32,
                      device=dy.device)
    for e, start, end in _groups(group_sizes):
        out[start:end] = dy[start:end].float() @ w[e].float().mT
    return out.to(dy.dtype)


def grouped_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                          group_sizes: torch.Tensor) -> torch.Tensor:
    """The grouped matmul's gradient for w: ``dw[e] = x_eᵀ @ dy_e`` over
    expert e's rows.  x (T,d), dy (T,f), rows sorted by expert.  fp32 sums,
    one product per non-empty expert; an empty expert's slab is exactly
    zero.  Output (E,d,f) in x's dtype."""
    out = torch.zeros((group_sizes.shape[0], x.shape[1], dy.shape[1]),
                      dtype=torch.float32, device=x.device)
    for e, start, end in _groups(group_sizes):
        out[e] = x[start:end].float().mT @ dy[start:end].float()
    return out.to(x.dtype)
