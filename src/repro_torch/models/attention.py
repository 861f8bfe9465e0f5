"""GQA attention (with RoPE / sliding-window / logit softcap): the PyTorch
twin of the GQA part of ``repro/models/attention.py``.

Decode uses a fixed-capacity slot cache ``[batch, cap, KV, hd]``:
  * full attention  — capacity = seq_cap, write slot = position
  * sliding window  — capacity = window, ring buffer, write slot = pos % W
Every cache carries a per-slot ``pos`` array (int32, -1 = empty) used for
masking, which keeps ring buffers and continuous batching exact.

Differences from the JAX module, none of which changes a result:

* prefill attention goes through ``kernels/flash_attention`` (the CUDA
  kernel on the card, its plain version on the CPU) instead of the jnp
  path, which computes the same function for prefill's ``arange``
  positions;
* ``gqa_decode`` writes K/V (with their int8 scales) and positions IN
  PLACE into the cache it is given (``index_put_``), where the JAX code
  returns a new cache.

``REPRO_KV_INT8=1`` selects the reference's int8 slot cache: int8 K/V with
one bf16 scale per (token, kv head), quantized on write and dequantized to
the model dtype on read.  MLA and cross-attention are later slices.
"""
from __future__ import annotations

import os

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import apply_rope, einsum, softcap
from repro_torch.models.params import P

_NEG_INF = -2.0e38


def attention_plan(cfg: ModelConfig, layer: LayerSpec) -> dict:
    a = cfg.attn
    if a.kind != "gqa":
        raise NotImplementedError(
            f"attention kind {a.kind!r} is not ported yet (only GQA)")
    d = cfg.d_model
    return {
        "wq": P((d, a.num_heads, a.head_dim)),
        "wk": P((d, a.num_kv_heads, a.head_dim)),
        "wv": P((d, a.num_kv_heads, a.head_dim)),
        "wo": P((a.num_heads, a.head_dim, d), fan_in=a.num_heads * a.head_dim),
    }


def kv_quantized() -> bool:
    """The reference's opt-in int8 dense KV cache (``REPRO_KV_INT8=1``)."""
    return os.environ.get("REPRO_KV_INT8", "0") == "1"


def attn_cache_plan(cfg: ModelConfig, layer: LayerSpec, batch: int,
                    seq_len: int) -> dict:
    """Decode-cache plan for one GQA layer: int8 K/V with bf16 scales per
    (token, kv head) under ``REPRO_KV_INT8=1``, else the model dtype (fp32
    configs keep fp32 so cached K/V match prefill exactly)."""
    a = cfg.attn
    if a.kind != "gqa":
        raise NotImplementedError(
            f"attention kind {a.kind!r} is not ported yet (only GQA)")
    cap = min(seq_len, layer.window) if layer.window else seq_len
    if kv_quantized():
        return {
            "k": P((batch, cap, a.num_kv_heads, a.head_dim), dtype="int8"),
            "v": P((batch, cap, a.num_kv_heads, a.head_dim), dtype="int8"),
            "k_scale": P((batch, cap, a.num_kv_heads), dtype="bfloat16"),
            "v_scale": P((batch, cap, a.num_kv_heads), dtype="bfloat16"),
            "pos": P((batch, cap), dtype="int32"),
        }
    return {
        "k": P((batch, cap, a.num_kv_heads, a.head_dim), dtype=cfg.dtype),
        "v": P((batch, cap, a.num_kv_heads, a.head_dim), dtype=cfg.dtype),
        "pos": P((batch, cap), dtype="int32"),
    }


def _quantize_kv(x):
    """x: [..., hd] -> (int8 values, per-row scale rounded through bf16).

    The codes are computed against the f32 scale; the returned scale is the
    bf16-rounded one, as in the JAX package (the page pools then store it
    as f32)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _qkv(params, x, positions, cfg: ModelConfig):
    """Projections and RoPE.  x: [B,S,d]; positions: [B,S]."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("bsd,dhk->bshk", x, params["wk"])
    v = einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    return p / (p.sum(dim=-1, keepdim=True) + 1e-30)


def gqa_prefill(params, x, positions, layer: LayerSpec, cfg: ModelConfig, *,
                causal: bool = True, impl: str = "auto"):
    """x: [B,S,d]; positions: [B,S] int32, each row ``arange(S)`` as prefill
    makes them (RoPE reads them; the mask is the flash kernel's end-aligned
    one with T = S, which is the JAX mask ``pos_k <= pos_q`` (and
    ``pos_k > pos_q - window``) for such positions).  Returns
    (out [B,S,d], (k, v))."""
    a = cfg.attn
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg)
    ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=causal, window=layer.window,
                          softcap=a.logit_softcap, impl=impl)
    out = einsum("bshk,hkd->bsd", ctx.reshape(b, s, a.num_heads, a.head_dim),
                 params["wo"])
    return out, (k, v)


def build_gqa_cache(k, v, positions, layer: LayerSpec, seq_cap: int):
    """Turn prefill K/V into a decode cache (ring-buffered if windowed):
    the last ``min(S, cap)`` tokens, each at slot ``pos % cap``; int8 with
    bf16 scales under ``REPRO_KV_INT8=1``."""
    b, s = positions.shape
    cap = min(seq_cap, layer.window) if layer.window else seq_cap
    kvh, hd = k.shape[2], k.shape[3]
    dev = k.device
    quant = kv_quantized()
    store_dt = torch.int8 if quant else k.dtype
    ck = torch.zeros((b, cap, kvh, hd), dtype=store_dt, device=dev)
    cv = torch.zeros((b, cap, kvh, hd), dtype=store_dt, device=dev)
    cpos = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    take = min(s, cap)
    k_t, v_t, p_t = k[:, -take:], v[:, -take:], positions[:, -take:]
    slots = (p_t % cap).long()                            # [B, take]
    bidx = torch.arange(b, device=dev)[:, None]
    cpos[bidx, slots] = p_t.to(torch.int32)
    out = {"k": ck, "v": cv, "pos": cpos}
    if quant:
        kq, ks = _quantize_kv(k_t)
        vq, vs = _quantize_kv(v_t)
        ck[bidx, slots] = kq
        cv[bidx, slots] = vq
        out["k_scale"] = torch.zeros((b, cap, kvh), dtype=torch.bfloat16,
                                     device=dev)
        out["v_scale"] = torch.zeros_like(out["k_scale"])
        out["k_scale"][bidx, slots] = ks
        out["v_scale"][bidx, slots] = vs
    else:
        ck[bidx, slots] = k_t
        cv[bidx, slots] = v_t
    return out


def gqa_decode(params, x, cache, positions, layer: LayerSpec,
               cfg: ModelConfig):
    """x: [B,1,d]; positions: [B] int32.  Writes this token's K/V (int8
    with its scales when the cache holds ``k_scale``) and position into
    ``cache`` in place and returns the attention output [B,1,d]."""
    a = cfg.attn
    b = x.shape[0]
    scale = 1.0 / float(a.head_dim) ** 0.5
    q, k, v = _qkv(params, x, positions[:, None], cfg)
    cap = cache["k"].shape[1]
    slots = (positions % cap if layer.window else positions).long()
    idx = (torch.arange(b, device=x.device), slots)
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k[:, 0])
        vq, vs = _quantize_kv(v[:, 0])
        cache["k"].index_put_(idx, kq)
        cache["v"].index_put_(idx, vq)
        cache["k_scale"].index_put_(idx, ks)
        cache["v_scale"].index_put_(idx, vs)
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"].index_put_(idx, k[:, 0].to(cache["k"].dtype))
        cache["v"].index_put_(idx, v[:, 0].to(cache["v"].dtype))
        k_read, v_read = cache["k"], cache["v"]
    cache["pos"].index_put_(idx, positions.to(torch.int32))
    g = a.num_heads // a.num_kv_heads
    qg = q.reshape(b, 1, a.num_kv_heads, g, a.head_dim)
    # the JAX einsum accumulates in f32 (preferred_element_type)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k_read.float()) * scale         # [B,KV,G,1,T]
    scores = softcap(scores, a.logit_softcap)
    pt = cache["pos"][:, None, None, None, :]
    ps = positions[:, None, None, None, None]
    mask = (pt >= 0) & (pt <= ps)
    if layer.window:
        mask = mask & (pt > ps - layer.window)
    p = _masked_softmax(scores, mask)
    ctx = einsum("bkgst,btkh->bskgh", p.to(x.dtype), v_read)
    ctx = ctx.reshape(b, 1, a.num_heads, a.head_dim)
    return einsum("bshk,hkd->bsd", ctx, params["wo"])
