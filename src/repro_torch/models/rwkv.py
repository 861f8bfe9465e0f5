"""RWKV-6 "Finch" mixer: token-shift + data-dependent decay WKV recurrence
[arXiv:2404.05892], the PyTorch twin of ``repro/models/rwkv.py``.

Per-head state S in R^{hd x hd}:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      (u = "bonus" for current token)
with w_t = exp(-exp(w0 + lora_w(x_t))) elementwise in (0,1).

The recurrence runs through ``kernels/rwkv6_scan`` (the CUDA kernel on the
card, its plain version on the CPU) in prefill (S = prompt) and decode
(S = 1), where the JAX module runs a ``lax.scan``.  State per layer:
  shift_att [B, d], shift_ffn [B, d]   (previous token for token-shift)
  wkv       [B, H, hd, hd]             (float32)

With a sharded step's ``part`` (``models/partition.py``) a layer whose
heads are split over ``model`` runs on this rank's heads: ``wr``, ``wk``,
``wv``, ``wg``, ``w_lora_b``, ``w0`` and ``u`` by heads (each replicated
input enters through ``f``), the WKV scan and ``_group_norm`` on them with
the matching slice of ``ln_x``, ``wo`` row-parallel and a sum; the
channel-mix runs ``cm_wk`` column- and ``cm_wv`` row-parallel, and the
receptance, split by ``cm_wr``'s columns, is gathered over ``model`` to
gate the summed output (it is the smaller operand).  The token-shift
states stay whole.

One deliberate difference: the shift states take the model dtype, where
the JAX plan fixes them at bfloat16.  For every bf16 config the two are the
same; for a float32 config the JAX decode step refuses to write its f32
shift into the bf16 state (``dynamic_update_slice`` needs equal dtypes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.models.common import NO_POLICY, ShardPolicy, einsum
from repro_torch.models.params import P


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def _mm(x, w):
    """``x @ w`` with jnp's type promotion (see ``common.einsum``)."""
    return einsum("...d,de->...e", x, w)


def rwkv_plan(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    r = cfg.rwkv
    heads, hd = _dims(cfg)
    return {
        # token-shift interpolation weights (r,k,v,g,w)
        "mu": P((5, d), init="small", pspec=(None, "data")),
        "wr": P((d, d), pspec=("data", "model")),
        "wk": P((d, d), pspec=("data", "model")),
        "wv": P((d, d), pspec=("data", "model")),
        "wg": P((d, d), pspec=("data", "model")),
        "wo": P((d, d), pspec=("model", "data")),
        "w0": P((d,), dtype="float32", init="small", pspec=("model",)),
        "w_lora_a": P((d, r.decay_lora), init="small", pspec=("data", None)),
        "w_lora_b": P((r.decay_lora, d), init="small", pspec=(None, "model")),
        "u": P((heads, hd), dtype="float32", init="small",
               pspec=("model", None)),
        "ln_x": P((d,), dtype="float32", init="zeros", pspec=()),
        # channel-mix
        "cm_mu": P((2, d), init="small", pspec=(None, "data")),
        "cm_wr": P((d, d), pspec=("data", "model")),
        "cm_wk": P((d, r.d_ffn), pspec=("data", "model")),
        "cm_wv": P((r.d_ffn, d), fan_in=r.d_ffn, pspec=("model", "data")),
    }


def rwkv_state_plan(cfg: ModelConfig, batch: int, *,
                    policy: ShardPolicy = NO_POLICY) -> dict:
    heads, hd = _dims(cfg)
    bsp = tuple((policy.state or ())[:1])
    return {
        "shift_att": P((batch, cfg.d_model), dtype=cfg.dtype,
                       pspec=bsp + (None,)),
        "shift_ffn": P((batch, cfg.d_model), dtype=cfg.dtype,
                       pspec=bsp + (None,)),
        "wkv": P((batch, heads, hd, hd), dtype="float32",
                 pspec=bsp + ("model", None, None)),
    }


def _token_shift(x, prev, mu):
    """x: [B,S,d]; prev: [B,d] last token of previous chunk."""
    shifted = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return x + mu.to(x.dtype) * (shifted - x)


def _split(params, key: str, whole: int, part):
    """``part`` when ``params[key]``'s columns are split over ``model``."""
    return part if part is not None and params[key].shape[1] != whole \
        else None


def _f(x, part):
    return x if part is None else part.f(x)


def _rkvgw(params, x, prev, cfg, part=None):
    """Project token-shifted inputs to r,k,v,g and decay w (on this rank's
    heads when ``part`` splits them)."""
    _, hd = _dims(cfg)
    heads = params["u"].shape[0]
    mu = params["mu"]
    xr = _token_shift(x, prev, mu[0])
    xk = _token_shift(x, prev, mu[1])
    xv = _token_shift(x, prev, mu[2])
    xg = _token_shift(x, prev, mu[3])
    xw = _token_shift(x, prev, mu[4])
    b, s, _ = x.shape
    r = _mm(_f(xr, part), params["wr"]).reshape(b, s, heads, hd)
    k = _mm(_f(xk, part), params["wk"]).reshape(b, s, heads, hd)
    v = _mm(_f(xv, part), params["wv"]).reshape(b, s, heads, hd)
    g = F.silu(_mm(_f(xg, part), params["wg"]))
    lora = _mm(_f(_mm(xw, params["w_lora_a"]), part), params["w_lora_b"])
    w_log = params["w0"] + lora          # f32 + bf16 promotes to f32
    w = torch.exp(-torch.exp(w_log.float())).reshape(b, s, heads, hd)
    return r, k, v, g, w


def _group_norm(y, weight, heads, eps=1e-5):
    """Per-head LayerNorm of [B,S,H,hd] flattened back to [B,S,d]
    (population variance, as ``jnp.var``)."""
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    yn = (y - mean) * torch.rsqrt(var + eps)
    b, s, h, hd = y.shape
    return yn.reshape(b, s, h * hd) * (1.0 + weight)


def rwkv_time_mix(params, x, state_shift, state_wkv, cfg: ModelConfig, *,
                  impl: str = "auto", part=None):
    """x: [B,S,d].  Returns (out, (new_shift, new_wkv)); with ``part`` the
    WKV state holds this rank's heads when they are split."""
    part = _split(params, "wr", cfg.d_model, part)
    heads = params["u"].shape[0]
    if part is not None and heads * _dims(cfg)[1] != params["wr"].shape[1]:
        raise ValueError("the model axis splits RWKV-6's heads")
    r, k, v, g, w = _rkvgw(params, x, state_shift, cfg, part)
    y, s_final = rwkv6_scan(r.float().contiguous(), k.float().contiguous(),
                            v.float().contiguous(), w.contiguous(),
                            params["u"].float().contiguous(),
                            state_wkv.contiguous(), impl=impl)
    ln_x = params["ln_x"] if part is None else part.model_slice(
        params["ln_x"], 0)
    y = _group_norm(y, ln_x, heads).to(x.dtype) * g
    out = _mm(y, params["wo"])
    if part is not None:
        out = part.g(out)
    return out, (x[:, -1], s_final)


def rwkv_channel_mix(params, x, state_shift, *, cfg=None, part=None):
    """RWKV channel-mix FFN.  x: [B,S,d].  With ``part`` (and ``cfg``),
    on this rank's columns where ``cm_wr`` / ``cm_wk`` are split."""
    mu = params["cm_mu"]
    xr = _token_shift(x, state_shift, mu[0])
    xk = _token_shift(x, state_shift, mu[1])
    pr = _split(params, "cm_wr", x.shape[-1], part)
    pk = None if part is None else _split(params, "cm_wk", cfg.rwkv.d_ffn,
                                          part)
    r = torch.sigmoid(_mm(_f(xr, pr), params["cm_wr"]))
    if pr is not None:
        r = pr.gather_model(r, r.dim() - 1)
    kk = torch.square(F.relu(_mm(_f(xk, pk), params["cm_wk"])))
    o = _mm(kk, params["cm_wv"])
    if pk is not None:
        o = pk.g(o)
    out = r * o
    return out, x[:, -1]


def stabilize_random(params, plan, repeats: int) -> None:
    """Rescale random weights drawn from the model plan, in place, so that
    a deep RWKV-6 stack stays finite.

    The plan's random init diverges: a stacked period leaf without a
    ``fan_in`` scales by ``1/sqrt(repeats)`` (the JAX package's rule, which
    the port keeps), and the channel-mix's squared ReLU runs on the
    residual stream without a norm, so the stream grows doubly
    exponentially; the JAX model's logits are NaN from 4 layers on at the
    reduced width.  Each such matrix is rescaled to ``1/sqrt(its own
    fan-in)``, and the two residual-branch outputs (``wo``, ``cm_wv``) by
    ``1/sqrt(2 * repeats)``, as GPT-2 scales its residual projections.
    Trained weights need none of this."""
    for sub, lp in params.get("period", {}).items():
        if "rwkv" not in lp:
            continue
        weights, leaves = lp["rwkv"], plan["period"][sub]["rwkv"]
        for name, t in weights.items():
            if leaves[name].init == "normal" and leaves[name].fan_in is None:
                t.mul_((repeats / leaves[name].shape[1]) ** 0.5)
        for name in ("wo", "cm_wv"):
            weights[name].mul_((2 * repeats) ** -0.5)
