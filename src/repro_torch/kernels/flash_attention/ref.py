"""Plain PyTorch prefill attention: the twin of
``repro/kernels/flash_attention/ref.py`` and the CUDA kernel's plain
version, with the plain version of the backward kernel beside it."""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -2.0e38


def _mask(s: int, t: int, causal: bool, window: int, device):
    """[S, T] bool: the (query, key) pairs the end-aligned mask keeps."""
    pos_q = torch.arange(s, device=device) + (t - s)
    pos_k = torch.arange(t, device=device)
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_q[:, None] >= pos_k[None, :]
    if window:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    return mask


def _acc(dtype):
    """The type the arithmetic runs in: f32, or f64 for f64 inputs (so a
    float64 gradcheck sees exact arithmetic)."""
    return torch.promote_types(dtype, torch.float32)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd] with H % KV == 0.  Returns [B,S,H,hd]
    in q's dtype, computed in f32; with ``return_lse`` also each row's
    log-sum-exp over its kept keys, [B,H,S] in f32 (f64 for f64 inputs;
    +inf for a row no key reaches), as the kernel gives it.

    Query position i is aligned so that the last query attends to the last
    key: pos_q[i] = i + (T - S).
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    acc = _acc(q.dtype)
    qg = q.reshape(b, s, kv, g, hd).to(acc)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(acc)) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    mask = _mask(s, t, causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True)
    p = p / (denom + 1e-30)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.to(acc))
    out = out.reshape(b, s, h, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(denom > 0, m + torch.log(denom),
                      torch.full_like(denom, float("inf")))
    return out, lse.reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """The backward kernel's plain version, by formula (not autograd):
    q/o/do [B,S,H,hd], k/v [B,T,KV,hd], lse f32 [B,H,S] from the forward.
    In f32: P = exp(score - lse) on the kept pairs (0 elsewhere),
    D = rowsum(dO * O), dS = P * (dO V^T - D) times softcap's derivative
    1 - tanh^2 and the scale; dq = dS K, dk = dS^T Q and dv = P^T dO,
    summed over the G query heads of each kv head.  Returns (dq, dk, dv)
    in the inputs' dtype."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    acc = _acc(q.dtype)
    qg = q.reshape(b, s, kv, g, hd).to(acc)
    dog = do.reshape(b, s, kv, g, hd).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    x = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
    dcap = None
    if softcap is not None:
        th = torch.tanh(x / softcap)
        x = th * softcap
        dcap = 1.0 - th * th
    mask = _mask(s, t, causal, window, q.device)
    lse_g = lse.reshape(b, kv, g, s, 1).to(acc)
    p = torch.where(mask, torch.exp(x - lse_g), torch.zeros_like(x))
    dsum = (do.to(acc) * o.to(acc)).sum(-1)               # [B,S,H]
    dsum = dsum.reshape(b, s, kv, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    ds = p * (dp - dsum)
    if dcap is not None:
        ds = ds * dcap
    ds = ds * scale
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf).reshape(b, s, h, hd)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
