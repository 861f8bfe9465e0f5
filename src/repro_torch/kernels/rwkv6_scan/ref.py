"""Plain PyTorch RWKV-6 WKV recurrence: the twin of
``repro/kernels/rwkv6_scan/ref.py`` and the CUDA kernel's plain version,
with the plain version of the backward kernel beside it."""
from __future__ import annotations

import torch


def _acc(dtype):
    """The type the arithmetic runs in: f32, or f64 for f64 inputs (so a
    float64 gradcheck sees exact arithmetic)."""
    return torch.promote_types(dtype, torch.float32)


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Sequential reference of the RWKV-6 time-mix recurrence, in f32.

    r/k/v/w  [B, S, H, hd]   (w in (0,1): per-step decay)
    u        [H, hd]          bonus for the current token
    s0       [B, H, hd, hd]   initial state (optional, zeros when None)
    Returns (y [B,S,H,hd] in r's dtype, s_final [B,H,hd,hd] f32; f64 for
    f64 inputs).
    """
    b, s, h, hd = r.shape
    acc = _acc(r.dtype)
    rf, kf, vf, wf = (t.to(acc) for t in (r, k, v, w))
    uf = u.to(acc)
    st = (torch.zeros((b, h, hd, hd), dtype=acc, device=r.device)
          if s0 is None else s0.to(acc).clone())
    ys = torch.zeros((b, s, h, hd), dtype=acc, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # [B,H,hd,hd]
        ys[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                st + uf[None, :, :, None] * kv)
        st = wf[:, t, :, :, None] * st + kv
    return ys.to(r.dtype), st


def rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, ds_final):
    """The backward kernel's plain version, by formula (not autograd), a
    reverse-time loop in f32 (f64 for f64 inputs).  Per (b, h), with the
    state S [hd, hd] (row i key, column j value) of the forward
    ``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, the adjoint G_t = dL/dS_t
    starts at ``ds_final`` and runs ``G_{t-1} = diag(w_t) G_t + r_t dy_t^T``;
    then
      dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
      dk_t[i] = sum_j G_t[i][j] v_t[j] + u[i] r_t[i] (v_t . dy_t)
      dv_t[j] = sum_i G_t[i][j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
      dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
      du[i] = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t),   ds0 = G_0.
    S_{t-1} is kept from a forward pass, never formed by dividing by w
    (which underflows to 0).  s0 / ds_final may be None (zeros).
    Returns (dr, dk, dv, dw, du, ds0), each in its input's dtype (s0's:
    f32 when None)."""
    b, s, h, hd = r.shape
    acc = _acc(r.dtype)
    rf, kf, vf, wf, dyf = (t.to(acc) for t in (r, k, v, w, dy))
    uf = u.to(acc)
    zeros = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device)
    st = zeros if s0 is None else s0.to(acc)
    prev = []                                  # S_{t-1} for every step t
    for t in range(s):
        prev.append(st)
        st = wf[:, t, :, :, None] * st + kf[:, t, :, :, None] * vf[
            :, t, :, None, :]
    g = zeros.clone() if ds_final is None else ds_final.to(acc).clone()
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(s)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
        q = (vt * dyt).sum(-1, keepdim=True)                    # v . dy
        p = (rt * uf * kt).sum(-1, keepdim=True)                # r u k
        dr[:, t] = torch.einsum("bhij,bhj->bhi", prev[t], dyt) + uf * kt * q
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + uf * rt * q
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) + p * dyt
        dw[:, t] = (g * prev[t]).sum(-1)
        du += (rt * kt * q).sum(0)
        g = wt[..., None] * g + rt[..., :, None] * dyt[..., None, :]
    ds0_dtype = torch.float32 if s0 is None else s0.dtype
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), g.to(ds0_dtype))
