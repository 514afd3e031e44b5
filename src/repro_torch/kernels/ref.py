"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense masked attention oracle. q (B,S,Hq,D); k,v (B,S,Hkv,D).

    Scores, softmax and PV in fp32; output in q's dtype."""
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
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)
