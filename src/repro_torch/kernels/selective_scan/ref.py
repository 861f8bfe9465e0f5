"""Plain PyTorch Mamba selective scan: the twin of
``repro/kernels/selective_scan/ref.py`` and the CUDA kernel's plain
version."""
from __future__ import annotations

import torch


def selective_scan_ref(x, delta, a, b, c, d, h0=None):
    """Sequential reference of  h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t;
    y_t = C_t h_t + D x_t, in f32.

    x      [B, S, D]      input activations (post conv)
    delta  [B, S, D]      softplus'd timestep
    a      [D, N]         state matrix (diagonal, = -exp(A_log))
    b      [B, S, N]      input matrix
    c      [B, S, N]      output matrix
    d      [D]            skip
    h0     [B, D, N]      initial state (optional, zeros when None)
    Returns (y [B,S,D] in x's dtype, h_final [B,D,N] f32); y is formed in
    f32 and rounded once.
    """
    bb, s, dd = x.shape
    n = a.shape[1]
    xf, df = x.float(), delta.float()
    af, bf, cf, skip = a.float(), b.float(), c.float(), d.float()
    h = (torch.zeros((bb, dd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys = torch.zeros((bb, s, dd), dtype=torch.float32, device=x.device)
    for t in range(s):
        da = torch.exp(df[:, t, :, None] * af[None])               # [B,D,N]
        dbx = df[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None]
        h = da * h + dbx
        ys[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t]) + skip * xf[:, t]
    return ys.to(x.dtype), h
