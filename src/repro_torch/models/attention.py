"""Attention family: GQA (with RoPE / sliding-window / logit softcap), MLA
(DeepSeek-V2 multi-head latent attention) and enc-dec cross-attention, the
PyTorch twin of ``repro/models/attention.py``.

Decode uses a fixed-capacity slot cache:
  * full attention  — ``[batch, seq_cap, KV, hd]``, write slot = position
  * sliding window  — capacity = window, ring buffer, write slot = pos % W
  * MLA             — compressed ``ckv [batch, seq_cap, kv_lora]`` and
                      ``krope [batch, seq_cap, rope]``, absorbed decode
  * cross-attention — the encoder memory's K/V ``[batch, enc_len, KV, hd]``,
                      read-only in decode
Every self-attention cache carries a per-slot ``pos`` array (int32, -1 =
empty) used for masking, which keeps ring buffers and continuous batching
exact.

Differences from the JAX module, none of which changes a result:

* prefill attention goes through ``kernels/flash_attention`` (the CUDA
  kernel on the card, its plain version on the CPU) instead of the jnp
  path, which computes the same function for prefill's ``arange``
  positions: GQA layers (causal, or non-causal in the encoder), MLA
  prefill (Q and K ``[nope | rope]``, V zero-padded to their width) and
  the prefill's cross-attention (non-causal over the frames);
* ``gqa_decode`` and ``mla_decode`` write this token's cache rows IN PLACE
  into the cache they are given (``index_put_``), where the JAX code
  returns a new cache;
* decode cross-attention takes a per-row count of valid frames, so the
  dense engine's slot cache can hold frames of several lengths (the JAX
  code attends over every frame of its cache).

``REPRO_KV_INT8=1`` selects the reference's int8 slot cache for GQA: int8
K/V with one bf16 scale per (token, kv head), quantized on write and
dequantized to the model dtype on read.  MLA and cross-attention caches
keep the model dtype, as in the reference.
"""
from __future__ import annotations

import os

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (NO_POLICY, ShardPolicy, apply_rope,
                                      einsum, rms_norm, softcap)
from repro_torch.models.params import P

_NEG_INF = -2.0e38


def attention_plan(cfg: ModelConfig, layer: LayerSpec) -> dict:
    a = cfg.attn
    d = cfg.d_model
    if a.kind == "mla":
        return {
            "wq_a": P((d, a.q_lora_rank), pspec=("data", None)),
            "q_norm": P((a.q_lora_rank,), dtype="float32", init="zeros",
                        pspec=()),
            "wq_b": P((a.q_lora_rank, a.num_heads,
                       a.nope_head_dim + a.rope_head_dim),
                      fan_in=a.q_lora_rank, pspec=(None, "model", None)),
            "wkv_a": P((d, a.kv_lora_rank + a.rope_head_dim),
                       pspec=("data", None)),
            "kv_norm": P((a.kv_lora_rank,), dtype="float32", init="zeros",
                         pspec=()),
            "wk_b": P((a.kv_lora_rank, a.num_heads, a.nope_head_dim),
                      fan_in=a.kv_lora_rank, pspec=(None, "model", None)),
            "wv_b": P((a.kv_lora_rank, a.num_heads, a.v_head_dim),
                      fan_in=a.kv_lora_rank, pspec=(None, "model", None)),
            "wo": P((a.num_heads, a.v_head_dim, d),
                    fan_in=a.num_heads * a.v_head_dim,
                    pspec=("model", None, "data")),
        }
    return cross_attention_plan(cfg)


def cross_attention_plan(cfg: ModelConfig) -> dict:
    """GQA projections (a self-attention layer's and a cross-attention
    block's are laid out alike): heads over ``model``, ``d`` over
    ``data``; K/V replicate their heads when ``model`` does not divide
    them (``alt``)."""
    a = cfg.attn
    d = cfg.d_model
    return {
        "wq": P((d, a.num_heads, a.head_dim), pspec=("data", "model", None)),
        "wk": P((d, a.num_kv_heads, a.head_dim),
                pspec=("data", "model", None), alt=("data", None, None)),
        "wv": P((d, a.num_kv_heads, a.head_dim),
                pspec=("data", "model", None), alt=("data", None, None)),
        "wo": P((a.num_heads, a.head_dim, d), fan_in=a.num_heads * a.head_dim,
                pspec=("model", None, "data")),
    }


def kv_quantized() -> bool:
    """The reference's opt-in int8 dense KV cache (``REPRO_KV_INT8=1``)."""
    return os.environ.get("REPRO_KV_INT8", "0") == "1"


def attn_cache_plan(cfg: ModelConfig, layer: LayerSpec, batch: int,
                    seq_len: int, *, policy: ShardPolicy = NO_POLICY) -> dict:
    """Decode-cache plan for one attention layer, sharded as the policy's
    ``kv_cache`` (GQA) or ``mla_cache`` (MLA) says.  MLA: the compressed
    ``ckv``/``krope`` rows, planned in bf16 whatever the model dtype and
    never int8, as the reference plans them (so a float32 engine rounds
    them to bf16 on their way into the slot cache, as the JAX engine
    does).  GQA:
    int8 K/V with bf16 scales per (token, kv head) under
    ``REPRO_KV_INT8=1``, else the model dtype (fp32 configs keep fp32 so
    cached K/V match prefill exactly)."""
    a = cfg.attn
    cap = min(seq_len, layer.window) if layer.window else seq_len
    kvp = policy.kv_cache or ()
    pos_spec = tuple(kvp[:2])
    if a.kind == "mla":
        mp = policy.mla_cache or ()
        return {
            "ckv": P((batch, cap, a.kv_lora_rank), pspec=mp),
            "krope": P((batch, cap, a.rope_head_dim), pspec=tuple(mp[:2])),
            "pos": P((batch, cap), dtype="int32", pspec=tuple(mp[:2])),
        }
    if kv_quantized():
        scale_spec = tuple(kvp[:3])
        return {
            "k": P((batch, cap, a.num_kv_heads, a.head_dim), dtype="int8",
                   pspec=kvp),
            "v": P((batch, cap, a.num_kv_heads, a.head_dim), dtype="int8",
                   pspec=kvp),
            "k_scale": P((batch, cap, a.num_kv_heads), dtype="bfloat16",
                         pspec=scale_spec),
            "v_scale": P((batch, cap, a.num_kv_heads), dtype="bfloat16",
                         pspec=scale_spec),
            "pos": P((batch, cap), dtype="int32", pspec=pos_spec),
        }
    return {
        "k": P((batch, cap, a.num_kv_heads, a.head_dim), dtype=cfg.dtype,
               pspec=kvp),
        "v": P((batch, cap, a.num_kv_heads, a.head_dim), dtype=cfg.dtype,
               pspec=kvp),
        "pos": P((batch, cap), dtype="int32", pspec=pos_spec),
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


def cross_cache_plan(cfg: ModelConfig, batch: int, enc_len: int, *,
                     policy: ShardPolicy = NO_POLICY) -> dict:
    """The encoder memory's K/V for one cross-attention block."""
    a = cfg.attn
    kvp = policy.kv_cache or ()
    return {
        "ck": P((batch, enc_len, a.num_kv_heads, a.head_dim), dtype=cfg.dtype,
                pspec=kvp),
        "cv": P((batch, enc_len, a.num_kv_heads, a.head_dim), dtype=cfg.dtype,
                pspec=kvp),
    }


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_qkv_prefill(params, x, positions, cfg: ModelConfig):
    """Low-rank Q (normed latent, then per head ``[nope | rope]``) and the
    compressed KV row (normed ``ckv`` and the shared RoPE key).
    x: [B,S,d]; positions: [B,S]."""
    a = cfg.attn
    q_lat = rms_norm(einsum("bsd,dr->bsr", x, params["wq_a"]),
                     params["q_norm"], cfg.norm_eps)
    q = einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., : a.nope_head_dim], q[..., a.nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = einsum("bsd,dr->bsr", x, params["wkv_a"])
    ckv = rms_norm(kv[..., : a.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, a.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]        # [B,S,rope]
    return q_nope, q_rope, ckv, k_rope


def mla_prefill(params, x, positions, layer: LayerSpec, cfg: ModelConfig, *,
                impl: str = "auto"):
    """x: [B,S,d]; positions: [B,S], each row ``arange(S)``.  Decompresses
    per-head K/V once and runs the flash kernel on ``[nope | rope]`` rows:
    Q ``[q_nope | q_rope]``, K ``[k_nope | k_rope]`` (the RoPE key shared
    by every head), V zero-padded to the same width, scale
    1/sqrt(nope + rope) as in the reference; the output's first
    ``v_head_dim`` columns are the context.  Returns (out [B,S,d],
    (ckv, k_rope))."""
    a = cfg.attn
    b, s, _ = x.shape
    h, qk = a.num_heads, a.nope_head_dim + a.rope_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv_prefill(params, x, positions, cfg)
    k_nope = einsum("btr,rhk->bthk", ckv, params["wk_b"])
    v = einsum("btr,rhv->bthv", ckv, params["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h,
                                                      a.rope_head_dim)],
                  dim=-1)
    v = torch.nn.functional.pad(v, (0, qk - a.v_head_dim))
    ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, scale=1.0 / float(qk) ** 0.5,
                          impl=impl)
    out = einsum("bshv,hvd->bsd", ctx[..., : a.v_head_dim], params["wo"])
    return out, (ckv, k_rope)


def build_mla_cache(ckv, k_rope, positions, seq_cap: int):
    """The compressed decode cache: the last ``min(S, seq_cap)`` rows, each
    at slot ``pos``, in the dtype of ``ckv``."""
    b, s = positions.shape
    dev = ckv.device
    out = {"ckv": torch.zeros((b, seq_cap) + ckv.shape[2:], dtype=ckv.dtype,
                              device=dev),
           "krope": torch.zeros((b, seq_cap) + k_rope.shape[2:],
                                dtype=k_rope.dtype, device=dev),
           "pos": torch.full((b, seq_cap), -1, dtype=torch.int32,
                             device=dev)}
    take = min(s, seq_cap)
    bidx = torch.arange(b, device=dev)[:, None]
    slots = positions[:, -take:].long()
    out["ckv"][bidx, slots] = ckv[:, -take:]
    out["krope"][bidx, slots] = k_rope[:, -take:]
    out["pos"][bidx, slots] = positions[:, -take:].to(torch.int32)
    return out


def mla_decode(params, x, cache, positions, layer: LayerSpec,
               cfg: ModelConfig):
    """Absorbed-matmul MLA decode: ``wk_b`` folded into the query, f32
    scores over the compressed ``ckv`` and ``krope`` rows, the compressed
    context multiplied by ``wv_b``; never materialises per-head K/V.
    x: [B,1,d]; positions: [B] int32.  Writes this token's rows and
    position into ``cache`` in place and returns the output [B,1,d]."""
    a = cfg.attn
    b = x.shape[0]
    scale = 1.0 / float(a.nope_head_dim + a.rope_head_dim) ** 0.5
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv_prefill(
        params, x, positions[:, None], cfg)
    idx = (torch.arange(b, device=x.device), positions.long())
    cache["ckv"].index_put_(idx, ckv_new[:, 0].to(cache["ckv"].dtype))
    cache["krope"].index_put_(idx, kr_new[:, 0].to(cache["krope"].dtype))
    cache["pos"].index_put_(idx, positions.to(torch.int32))
    ckv, krope = cache["ckv"], cache["krope"]
    q_abs = einsum("bshk,rhk->bshr", q_nope, params["wk_b"])
    # the JAX einsums accumulate in f32 (preferred_element_type)
    scores = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope.float())) * scale      # [B,H,1,T]
    pt = cache["pos"][:, None, None, :]
    mask = (pt >= 0) & (pt <= positions[:, None, None, None])
    p = _masked_softmax(scores, mask)
    ctx_c = einsum("bhst,btr->bshr", p.to(x.dtype), ckv)  # compressed ctx
    ctx = einsum("bshr,rhv->bshv", ctx_c, params["wv_b"])
    return einsum("bshv,hvd->bsd", ctx, params["wo"])


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec decoder layers)
# ---------------------------------------------------------------------------

def cross_attn_kv(params, memory):
    """memory: [B,F,d] encoder output -> (ck, cv) [B,F,KV,hd]."""
    return (einsum("bfd,dhk->bfhk", memory, params["wk"]),
            einsum("bfd,dhk->bfhk", memory, params["wv"]))


def cross_attn(params, x, ck, cv, cfg: ModelConfig, *, kv_len=None,
               impl: str = "auto"):
    """x: [B,S,d]; attends (non-causal, no RoPE) over the encoder memory's
    K/V [B,F,KV,hd].  Without ``kv_len`` every frame counts and the call
    goes through the flash kernel (prefill); with ``kv_len`` [B] (decode
    over the slot cache) frames past each row's count are masked, in
    plain PyTorch as ``gqa_decode`` attends."""
    a = cfg.attn
    b, s, _ = x.shape
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if kv_len is None:
        ctx = flash_attention(q.contiguous(), ck.contiguous(),
                              cv.contiguous(), causal=False, impl=impl)
    else:
        g = a.num_heads // a.num_kv_heads
        qg = q.reshape(b, s, a.num_kv_heads, g, a.head_dim)
        scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                              ck.float()) / float(a.head_dim) ** 0.5
        frames = torch.arange(ck.shape[1], device=x.device)
        mask = (frames[None, :] < kv_len[:, None])[:, None, None, None, :]
        p = _masked_softmax(scores, mask)
        ctx = einsum("bkgst,btkh->bskgh", p.to(x.dtype), cv)
    ctx = ctx.reshape(b, s, a.num_heads, a.head_dim)
    return einsum("bshk,hkd->bsd", ctx, params["wo"])
