"""Plain PyTorch Mamba selective scan: the twin of
``repro/kernels/selective_scan/ref.py`` and the CUDA kernel's plain
version, with the plain version of the backward kernel beside it."""
from __future__ import annotations

import torch


def _acc(*dtypes):
    """The type the arithmetic runs in: f32, or f64 for f64 inputs (so a
    float64 gradcheck sees exact arithmetic)."""
    acc = torch.float32
    for dt in dtypes:
        acc = torch.promote_types(acc, dt)
    return acc


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
    f32 and rounded once (f64 throughout for f64 inputs).
    """
    bb, s, dd = x.shape
    n = a.shape[1]
    acc = _acc(x.dtype, delta.dtype)
    xf, df = x.to(acc), delta.to(acc)
    af, bf, cf, skip = a.to(acc), b.to(acc), c.to(acc), d.to(acc)
    h = (torch.zeros((bb, dd, n), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc).clone())
    ys = torch.zeros((bb, s, dd), dtype=acc, device=x.device)
    for t in range(s):
        da = torch.exp(df[:, t, :, None] * af[None])               # [B,D,N]
        dbx = df[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None]
        h = da * h + dbx
        ys[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t]) + skip * xf[:, t]
    return ys.to(x.dtype), h


def selective_scan_bwd_ref(x, delta, a, b, c, d, h0, dy, dh_final):
    """The backward kernel's plain version, by formula (not autograd), a
    reverse-time loop in f32 (f64 for f64 inputs).  Per (b, channel), with
    the state h [N] of the forward ``h_t = e^{delta_t A} h_{t-1} +
    delta_t B_t x_t``, ``y_t = C_t . h_t + D x_t``, the adjoint
    g_t = dL/dh_t starts at ``g_T = dh_final + C_T dy_T`` and runs
    ``g_{t-1} = e^{delta_t A} g_t + C_{t-1} dy_{t-1}``; then
      dx_t = D dy_t + delta_t sum_n g_t[n] B_t[n]
      ddelta_t = sum_n g_t[n] (A[n] e^{delta_t A[n]} h_{t-1}[n] + B_t[n] x_t)
      dA[n] = sum_{b,t} g_t[n] delta_t e^{delta_t A[n]} h_{t-1}[n]
      dB_t[n] = sum_d g_t[n] delta_t x_t,   dC_t[n] = sum_d dy_t h_t[n]
      dD = sum_{b,t} dy_t x_t,   dh0 = e^{delta_1 A} g_1.
    h_{t-1} is kept from a forward pass, never formed by dividing by
    e^{delta A} (which flushes to 0).  h0 / dh_final may be None (zeros).
    Returns (dx, ddelta, da, db, dc, dd, dh0), each in its input's dtype
    (h0's: f32 when None)."""
    bb, s, dd = x.shape
    n = a.shape[1]
    acc = _acc(x.dtype, delta.dtype)
    xf, df, dyf = x.to(acc), delta.to(acc), dy.to(acc)
    af, bf, cf, skip = a.to(acc), b.to(acc), c.to(acc), d.to(acc)
    h = (torch.zeros((bb, dd, n), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    prev = []                                  # h_{t-1} for every step t
    for t in range(s):
        prev.append(h)
        h = torch.exp(df[:, t, :, None] * af) * h + (
            df[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None])
    g = (torch.zeros((bb, dd, n), dtype=acc, device=x.device)
         if dh_final is None else dh_final.to(acc).clone())
    dx, ddelta = torch.zeros_like(xf), torch.zeros_like(df)
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    da, dskip = torch.zeros_like(af), torch.zeros_like(skip)
    for t in reversed(range(s)):
        dt, xt, dyt = df[:, t, :, None], xf[:, t, :, None], dyf[:, t, :, None]
        bt, ct = bf[:, t, None, :], cf[:, t, None, :]
        ea = torch.exp(dt * af)                                 # [B,D,N]
        g = g + ct * dyt
        ht = ea * prev[t] + dt * bt * xt
        gb = (g * bt).sum(-1)                                   # [B,D]
        dx[:, t] = skip * dyf[:, t] + df[:, t] * gb
        ddelta[:, t] = (g * af * ea * prev[t]).sum(-1) + gb * xf[:, t]
        da += (g * dt * ea * prev[t]).sum(0)
        db[:, t] = (g * dt * xt).sum(1)
        dc[:, t] = (dyt * ht).sum(1)
        dskip += (dyf[:, t] * xf[:, t]).sum(0)
        g = ea * g
    dh0_dtype = torch.float32 if h0 is None else h0.dtype
    return (dx.to(x.dtype), ddelta.to(delta.dtype), da.to(a.dtype),
            db.to(b.dtype), dc.to(c.dtype), dskip.to(d.dtype),
            g.to(dh0_dtype))
