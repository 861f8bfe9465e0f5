"""Plain PyTorch RWKV-6 WKV recurrence: the twin of
``repro/kernels/rwkv6_scan/ref.py`` and the CUDA kernel's plain version."""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Sequential reference of the RWKV-6 time-mix recurrence, in f32.

    r/k/v/w  [B, S, H, hd]   (w in (0,1): per-step decay)
    u        [H, hd]          bonus for the current token
    s0       [B, H, hd, hd]   initial state (optional, zeros when None)
    Returns (y [B,S,H,hd] in r's dtype, s_final [B,H,hd,hd] f32).
    """
    b, s, h, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float().clone())
    ys = torch.zeros((b, s, h, hd), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # [B,H,hd,hd]
        ys[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                st + uf[None, :, :, None] * kv)
        st = wf[:, t, :, :, None] * st + kv
    return ys.to(r.dtype), st
