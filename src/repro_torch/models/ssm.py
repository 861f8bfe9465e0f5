"""Mamba-1 selective state-space mixer (Jamba's SSM layers): the PyTorch twin
of ``repro/models/ssm.py``.

Prefill and decode both run the recurrence through
``kernels/selective_scan`` (the CUDA kernel on the card, its plain version
on the CPU), where the JAX module runs an associative scan over
materialised ``[B,S,d_inner,N]`` coefficients in prefill and one state
update in decode; the scan takes delta, A, B and C as they are and never
forms ``exp(delta A)`` or ``delta B x`` as tensors.  Decode is prefill at
S = 1 from the cached state, written back IN PLACE.  State per layer:
  conv [B, d_inner, d_conv-1]  (depthwise conv tail)
  ssm  [B, d_inner, d_state]   (float32)

With a sharded step's ``part`` (``models/partition.py``) a layer whose
``d_inner`` is split over ``model`` runs on this rank's channels:
``in_proj`` column-parallel, the conv, ``dt_proj``, ``dt_bias``,
``A_log``, ``D`` and the scan on its ``d_inner / m`` channels; ``x_proj``
contracts over ``d_inner``, so its ``dt | B | C`` output is summed over
``model`` before use; ``out_proj`` row-parallel, then a sum; the conv and
ssm states hold the rank's channels.

One deliberate difference: the conv state takes the model dtype, where the
JAX plan fixes it at bfloat16.  For every bf16 config the two are the
same; for a float32 config the JAX decode step refuses to write its f32
conv tail into the bf16 state (``dynamic_update_slice`` needs equal
dtypes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.common import NO_POLICY, ShardPolicy, einsum
from repro_torch.models.params import P


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_plan(cfg: ModelConfig) -> dict:
    m = cfg.mamba
    d = cfg.d_model
    d_inner, dt_rank = _dims(cfg)
    return {
        "in_proj": P((d, 2, d_inner), pspec=("data", None, "model")),
        "conv_w": P((d_inner, m.d_conv), init="small", pspec=("model", None)),
        "conv_b": P((d_inner,), init="zeros", pspec=("model",)),
        "x_proj": P((d_inner, dt_rank + 2 * m.d_state),
                    pspec=("model", None)),
        "dt_proj": P((dt_rank, d_inner), fan_in=dt_rank,
                     pspec=(None, "model")),
        "dt_bias": P((d_inner,), dtype="float32", init="small",
                     pspec=("model",)),
        "A_log": P((d_inner, m.d_state), dtype="float32",
                   init="identity_decay", pspec=("model", None)),
        "D": P((d_inner,), dtype="float32", init="ones", pspec=("model",)),
        "out_proj": P((d_inner, d), fan_in=d_inner, pspec=("model", "data")),
    }


def mamba_state_plan(cfg: ModelConfig, batch: int, *,
                     policy: ShardPolicy = NO_POLICY) -> dict:
    m = cfg.mamba
    d_inner, _ = _dims(cfg)
    sp = policy.state or ()
    return {
        "conv": P((batch, d_inner, m.d_conv - 1), dtype=cfg.dtype, pspec=sp),
        "ssm": P((batch, d_inner, m.d_state), dtype="float32", pspec=sp),
    }


def _ssm_coeffs(params, xc, cfg: ModelConfig, part=None):
    """xc: [B, S, d_inner] post-conv activations -> (delta [B,S,d_inner],
    A [d_inner,N], B [B,S,N], C [B,S,N]), all f32 and contiguous.  With
    ``part`` (``d_inner`` split) the partial ``x_proj`` products meet in a
    sum and re-enter the split compute through ``f``."""
    m = cfg.mamba
    _, dt_rank = _dims(cfg)
    proj = einsum("bsd,dr->bsr", xc, params["x_proj"])
    if part is not None:
        proj = part.f(part.g(proj))
    dt = proj[..., :dt_rank]
    bmat = proj[..., dt_rank: dt_rank + m.d_state].float().contiguous()
    cmat = proj[..., dt_rank + m.d_state:].float().contiguous()
    pre = (einsum("bsr,rd->bsd", dt, params["dt_proj"]).float()
           + params["dt_bias"])
    delta = torch.logaddexp(pre, torch.zeros_like(pre))      # softplus
    a = -torch.exp(params["A_log"].float())
    return delta, a, bmat, cmat


def _causal_conv(xpad, w, b):
    """Depthwise causal conv.  xpad: [B, S+pad, d_inner] (the tail first);
    w: [d_inner, d_conv].  Taps summed in f32, rounded once to the
    activations' dtype, then the bias, as the JAX einsum does."""
    k = w.shape[1]
    s = xpad.shape[1] - (k - 1)
    wf = w.float()
    acc = xpad[:, 0:s].float() * wf[:, 0]
    for i in range(1, k):
        acc = acc + xpad[:, i: i + s].float() * wf[:, i]
    return acc.to(xpad.dtype) + b


def mamba_prefill(params, x, cfg: ModelConfig, conv_init=None,
                  ssm_init=None, *, impl: str = "auto", part=None):
    """x: [B,S,d].  Returns (out [B,S,d], state {conv, ssm} for decode);
    with ``part`` on this rank's channels when ``d_inner`` is split."""
    m = cfg.mamba
    if part is not None and params["in_proj"].shape[2] == _dims(cfg)[0]:
        part = None                       # d_inner whole: computed whole
    if part is not None:
        x = part.f(x)
    xz = einsum("bsd,dci->bsci", x, params["in_proj"])
    xin, z = xz[..., 0, :], xz[..., 1, :]                    # [B,S,d_inner]
    pad = m.d_conv - 1
    if conv_init is not None:
        tail = conv_init.transpose(1, 2).to(xin.dtype)       # [B,pad,d_in]
    else:
        tail = torch.zeros((xin.shape[0], pad, xin.shape[2]),
                           dtype=xin.dtype, device=xin.device)
    xpad = torch.cat([tail, xin], dim=1)                     # [B,S+pad,d_in]
    xc = F.silu(_causal_conv(xpad, params["conv_w"], params["conv_b"]))
    delta, a, bmat, cmat = _ssm_coeffs(params, xc, cfg, part)
    y, h_final = selective_scan(
        xc.contiguous(), delta, a, bmat, cmat,
        params["D"].float().contiguous(),
        None if ssm_init is None else ssm_init.contiguous(), impl=impl)
    y = y.to(x.dtype) * F.silu(z)
    out = einsum("bsd,do->bso", y, params["out_proj"])
    if part is not None:
        out = part.g(out)
    # conv tail: last (d_conv-1) inputs, shape [B, d_inner, d_conv-1]
    state = {"conv": xpad[:, -pad:].transpose(1, 2).contiguous(),
             "ssm": h_final}
    return out, state


def mamba_decode(params, x, state, cfg: ModelConfig, *, impl: str = "auto",
                 part=None):
    """x: [B,1,d]; state: {conv [B,d_inner,pad], ssm [B,d_inner,n]}, this
    layer's slot-cache views, updated IN PLACE.  Returns out [B,1,d].

    One recurrent step is prefill at S = 1 from the cached state, so the
    scan kernel runs once per decode step over every slot."""
    out, new = mamba_prefill(params, x, cfg, conv_init=state["conv"],
                             ssm_init=state["ssm"], impl=impl, part=part)
    state["conv"].copy_(new["conv"])
    state["ssm"].copy_(new["ssm"])
    return out
