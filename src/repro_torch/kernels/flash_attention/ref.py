"""Plain PyTorch prefill attention: the twin of
``repro/kernels/flash_attention/ref.py`` and the CUDA kernel's plain
version."""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd] with H % KV == 0.  Returns [B,S,H,hd]
    in q's dtype, computed in f32.

    Query position i is aligned so that the last query attends to the last
    key: pos_q[i] = i + (T - S).
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    qg = q.reshape(b, s, kv, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    pos_q = torch.arange(s, device=q.device) + (t - s)
    pos_k = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q[:, None] >= pos_k[None, :]
    if window:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    p = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
