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

With a sharded step's ``part`` (``models/partition.py``) each function
runs on this rank's share of ``model``, as the parameters' resolved specs
split them (read from the local shapes): ``wq`` / ``wk`` / ``wv`` (MLA:
``wq_b`` / ``wk_b`` / ``wv_b``) column-parallel by heads, the flash kernel
on the rank's heads, ``wo`` row-parallel and a sum over ``model``.  K/V
heads that do not divide ``model`` are computed whole on every rank and
each rank reads the KV heads its query heads use.  A decode cache whose
sequence is split (over ``model``, or ``data`` and ``model``) is never
gathered: each rank scores its own slots, writes the slots it holds, and
the partial maxima, exponential sums and weighted values meet in two
all-reduces (max, then sum), as flash-decoding merges its splits; a rank
with no valid slot adds nothing.  When the query heads are split over
``model`` and the cache's sequence too, the query (one token) is gathered
over ``model`` first and each rank keeps its heads of the context.
Under sequence parallelism (``part.seq``) a prefill's input is this
rank's rows of the stream: each block takes it whole through
``part.enter`` (MLA's latent projections run on the rows first) and
gives its output back through ``part.leave``; the K/V it returns cover
the whole sequence.

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
from repro_torch.launch import collectives as coll
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

def _qkv(params, x, positions, cfg: ModelConfig, part=None):
    """Projections and RoPE.  x: [B,S,d] (under ``part.seq`` this rank's
    rows); positions: [B,S].  With ``part``: q on this rank's heads; k
    and v on its KV heads, or whole (every rank alike) when the KV heads
    are not split."""
    if part is not None:
        split = _q_split(params, cfg, part)
        xe = part.enter(x, split)
        q = einsum("bsd,dhk->bshk", xe, params["wq"])
        if split and params["wk"].shape[1] == cfg.attn.num_kv_heads:
            xa = part.alike(xe, x)
            k = part.f(einsum("bsd,dhk->bshk", xa, params["wk"]))
            v = part.f(einsum("bsd,dhk->bshk", xa, params["wv"]))
        else:
            k = einsum("bsd,dhk->bshk", xe, params["wk"])
            v = einsum("bsd,dhk->bshk", xe, params["wv"])
    else:
        q = einsum("bsd,dhk->bshk", x, params["wq"])
        k = einsum("bsd,dhk->bshk", x, params["wk"])
        v = einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _q_split(params, cfg: ModelConfig, part) -> bool:
    """True when this rank holds a block of the query heads."""
    if part is None:
        return False
    key = "wq_b" if cfg.attn.kind == "mla" else "wq"
    return params[key].shape[1] != cfg.attn.num_heads


def _kv_for_heads(kv, first: int, hl: int, heads: int):
    """The KV heads of ``kv`` [B,T,KV,hd] that query heads
    ``[first, first + hl)`` of ``heads`` read, laid out so that the
    kernel's group rule (query head j reads KV head j // (hl / KV'))
    holds."""
    kvh = kv.shape[2]
    group = heads // kvh
    if hl % group == 0:
        return kv.narrow(2, first // group, hl // group)
    if group % hl == 0:
        return kv.narrow(2, first // group, 1)
    idx = torch.tensor([(first + j) // group for j in range(hl)],
                       device=kv.device)
    return kv.index_select(2, idx)


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    return p / (p.sum(dim=-1, keepdim=True) + 1e-30)


def gqa_prefill(params, x, positions, layer: LayerSpec, cfg: ModelConfig, *,
                causal: bool = True, impl: str = "auto", part=None):
    """x: [B,S,d]; positions: [B,S] int32, each row ``arange(S)`` as prefill
    makes them (RoPE reads them; the mask is the flash kernel's end-aligned
    one with T = S, which is the JAX mask ``pos_k <= pos_q`` (and
    ``pos_k > pos_q - window``) for such positions).  Returns
    (out [B,S,d], (k, v)); under ``part.seq`` x and out are this rank's
    rows, k and v whole."""
    a = cfg.attn
    q, k, v = _qkv(params, x, positions, cfg, part)
    b, s = q.shape[:2]
    split = _q_split(params, cfg, part)
    hl = q.shape[2]
    ka, va = k, v
    if split and k.shape[2] == a.num_kv_heads:
        ka = _kv_for_heads(k, part.mi * hl, hl, a.num_heads)
        va = _kv_for_heads(v, part.mi * hl, hl, a.num_heads)
    ctx = flash_attention(q.contiguous(), ka.contiguous(), va.contiguous(),
                          causal=causal, window=layer.window,
                          softcap=a.logit_softcap, impl=impl)
    out = einsum("bshk,hkd->bsd", ctx.reshape(b, s, hl, a.head_dim),
                 params["wo"])
    if part is not None:
        out = part.leave(out, split)
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
               cfg: ModelConfig, *, part=None, cspec=None):
    """x: [B,1,d]; positions: [B] int32.  Writes this token's K/V (int8
    with its scales when the cache holds ``k_scale``) and position into
    ``cache`` in place and returns the attention output [B,1,d].  With
    ``part``, ``cache`` is this rank's stored shard and ``cspec`` its
    resolved specs."""
    a = cfg.attn
    b = x.shape[0]
    scale = 1.0 / float(a.head_dim) ** 0.5
    seq = _SeqSplit(part, cspec, "k", cache["k"].shape[1])
    split = _q_split(params, cfg, part)
    if split or seq.groups:
        return _gqa_decode_split(params, x, cache, positions, layer, cfg,
                                 part, seq, scale)
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
    ctx = _attend_decode(q, k_read, v_read, cache["pos"], positions, layer,
                         a.logit_softcap, scale, x.dtype)
    return einsum("bshk,hkd->bsd", ctx, params["wo"])


def _attend_decode(q, k_read, v_read, cpos, positions, layer: LayerSpec,
                   cap, scale, dtype, merge=()):
    """One query token against cached K/V.  q: [B,1,Hq,hd]; k_read,
    v_read: [B,T,KV,hd] with Hq a multiple of KV; cpos [B,T] (-1 empty).
    Returns the context [B,1,Hq,hd].  ``merge``: the process groups over
    which the cache's slots are split; the partial softmaxes then meet
    (``_merged_context``).  ``dtype``: the activations'."""
    b, _, hq, hd = q.shape
    kvh = k_read.shape[2]
    qg = q.reshape(b, 1, kvh, hq // kvh, hd)
    # the JAX einsum accumulates in f32 (preferred_element_type)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k_read.float()) * scale         # [B,KV,G,1,T]
    scores = softcap(scores, cap)
    pt = cpos[:, None, None, None, :]
    ps = positions[:, None, None, None, None]
    mask = (pt >= 0) & (pt <= ps)
    if layer.window:
        mask = mask & (pt > ps - layer.window)
    if merge:
        ctx = _merged_context(scores, mask, v_read, "bkgst,btkh->bskgh",
                              merge).to(dtype)
    else:
        p = _masked_softmax(scores, mask)
        ctx = einsum("bkgst,btkh->bskgh", p.to(dtype), v_read)
    return ctx.reshape(b, 1, hq, hd)


def _merged_context(scores, mask, values, eq: str, merge):
    """Softmax-weighted ``values`` over slots split across the ranks of
    ``merge``: the global row max by an all-reduce (max), then each
    rank's exponential sums and weighted values (f32) summed in one
    all-reduce.  A rank whose slots are all masked adds zeros."""
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = coll.all_reduce(scores.amax(dim=-1, keepdim=True), merge, "max")
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    vals = values.float()
    vals = torch.cat([vals, torch.ones_like(vals[..., :1])], dim=-1)
    acc = coll.all_reduce(torch.einsum(eq, p, vals), merge)
    return acc[..., :-1] / (acc[..., -1:] + 1e-30)


class _SeqSplit:
    """How this rank holds a cache leaf's sequence (slot) dim: the groups
    it is split over, the first slot held, the slots held and the whole
    capacity."""

    def __init__(self, part, cspec, key: str, held: int):
        entry = None
        if part is not None and cspec is not None and len(cspec[key]) > 1:
            entry = cspec[key][1]
        axes = part.live(entry) if part is not None else ()
        index, n = part.block(entry) if axes else (0, 1)
        self.axes = axes
        self.groups = part.groups_of(axes) if axes else ()
        self.lo, self.held, self.cap = index * held, held, held * n

    def slots(self, positions, window: int):
        """(local slot [B], held [B]) of each row's write slot."""
        slot = (positions % self.cap if window else positions).long()
        own = (slot >= self.lo) & (slot < self.lo + self.held)
        return (slot - self.lo).clamp(0, self.held - 1), own


def _write(leaf, idx, own, value) -> None:
    """``leaf[idx] = value`` on the rows whose slot this rank holds."""
    old = leaf[idx]
    keep = own.reshape((-1,) + (1,) * (value.dim() - 1))
    leaf.index_put_(idx, torch.where(keep, value.to(leaf.dtype), old))


def _gqa_decode_split(params, x, cache, positions, layer: LayerSpec,
                      cfg: ModelConfig, part, seq: "_SeqSplit", scale):
    """``gqa_decode`` on this rank's share: its query heads (or all of
    them, gathered over ``model`` when the cache's slots are split over
    it), its KV heads or slots of the cache."""
    a = cfg.attn
    b = x.shape[0]
    q, k, v = _qkv(params, x, positions[:, None], cfg, part)
    split = _q_split(params, cfg, part)
    hl, kvc = q.shape[2], cache["k"].shape[2]
    if k.shape[2] != kvc:               # whole K/V, the cache's heads split
        k = k.narrow(2, part.mi * kvc, kvc)
        v = v.narrow(2, part.mi * kvc, kvc)
    local, own = seq.slots(positions, layer.window)
    idx = (torch.arange(b, device=x.device), local)
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k[:, 0])
        vq, vs = _quantize_kv(v[:, 0])
        for key, val in (("k", kq), ("v", vq), ("k_scale", ks),
                         ("v_scale", vs)):
            _write(cache[key], idx, own, val)
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        _write(cache["k"], idx, own, k[:, 0])
        _write(cache["v"], idx, own, v[:, 0])
        k_read, v_read = cache["k"], cache["v"]
    _write(cache["pos"], idx, own, positions.to(torch.int32))
    every = split and "model" in seq.axes
    if every:                           # all heads against this rank's slots
        q = part.gather_model(q, 2)
    elif split and kvc == a.num_kv_heads:
        k_read = _kv_for_heads(k_read, part.mi * hl, hl, a.num_heads)
        v_read = _kv_for_heads(v_read, part.mi * hl, hl, a.num_heads)
    ctx = _attend_decode(q, k_read, v_read, cache["pos"], positions, layer,
                         a.logit_softcap, scale, x.dtype, merge=seq.groups)
    if every:
        ctx = ctx.narrow(2, part.mi * hl, hl)
    out = einsum("bshk,hkd->bsd", ctx, params["wo"])
    return part.g(out) if split else out


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _shared(w, part):
    return w if part is None else part.shared(w)


def _mla_qkv_prefill(params, x, positions, cfg: ModelConfig, part=None):
    """Low-rank Q (normed latent, then per head ``[nope | rope]``) and the
    compressed KV row (normed ``ckv`` and the shared RoPE key).
    x: [B,S,d]; positions: [B,S].  With ``part`` Q has this rank's heads
    (the latent, whole on every rank, enters them through ``f``); under
    ``part.seq`` x is this rank's rows, the latents are made on them and
    Q's enters whole (``ckv`` and ``k_rope`` stay this rank's rows)."""
    a = cfg.attn
    q_lat = rms_norm(einsum("bsd,dr->bsr", x, _shared(params["wq_a"], part)),
                     _shared(params["q_norm"], part), cfg.norm_eps)
    if part is not None:
        q_lat = part.enter(q_lat, _q_split(params, cfg, part))
    q = einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., : a.nope_head_dim], q[..., a.nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = einsum("bsd,dr->bsr", x, _shared(params["wkv_a"], part))
    ckv = rms_norm(kv[..., : a.kv_lora_rank],
                   _shared(params["kv_norm"], part), cfg.norm_eps)
    rows = positions if part is None else part.seq_rows(positions)
    k_rope = apply_rope(kv[..., None, a.kv_lora_rank:], rows,
                        cfg.rope_theta)[..., 0, :]        # [B,S,rope]
    return q_nope, q_rope, ckv, k_rope


def mla_prefill(params, x, positions, layer: LayerSpec, cfg: ModelConfig, *,
                impl: str = "auto", part=None):
    """x: [B,S,d]; positions: [B,S], each row ``arange(S)``.  Decompresses
    per-head K/V once and runs the flash kernel on ``[nope | rope]`` rows:
    Q ``[q_nope | q_rope]``, K ``[k_nope | k_rope]`` (the RoPE key shared
    by every head), V zero-padded to the same width, scale
    1/sqrt(nope + rope) as in the reference; the output's first
    ``v_head_dim`` columns are the context.  Returns (out [B,S,d],
    (ckv, k_rope)), the latents over the whole sequence."""
    a = cfg.attn
    qk = a.nope_head_dim + a.rope_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv_prefill(params, x, positions, cfg,
                                                   part)
    b, s, h = q_nope.shape[:3]              # h: this rank's heads
    split = _q_split(params, cfg, part)
    ckv_h, k_rope_h = ckv, k_rope
    if part is not None:
        ckv_h, k_rope_h = part.enter(ckv, split), part.enter(k_rope, split)
    k_nope = einsum("btr,rhk->bthk", ckv_h, params["wk_b"])
    v = einsum("btr,rhv->bthv", ckv_h, params["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h[:, :, None].expand(b, s, h,
                                                        a.rope_head_dim)],
                  dim=-1)
    v = torch.nn.functional.pad(v, (0, qk - a.v_head_dim))
    ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, scale=1.0 / float(qk) ** 0.5,
                          impl=impl)
    out = einsum("bshv,hvd->bsd", ctx[..., : a.v_head_dim], params["wo"])
    if part is not None:
        out = part.leave(out, split)
    return out, (ckv_h, k_rope_h)


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
               cfg: ModelConfig, *, part=None, cspec=None):
    """Absorbed-matmul MLA decode: ``wk_b`` folded into the query, f32
    scores over the compressed ``ckv`` and ``krope`` rows, the compressed
    context multiplied by ``wv_b``; never materialises per-head K/V.
    x: [B,1,d]; positions: [B] int32.  Writes this token's rows and
    position into ``cache`` in place and returns the output [B,1,d].
    With ``part``, ``cache`` is this rank's stored shard and ``cspec`` its
    resolved specs."""
    a = cfg.attn
    b = x.shape[0]
    scale = 1.0 / float(a.nope_head_dim + a.rope_head_dim) ** 0.5
    seq = _SeqSplit(part, cspec, "ckv", cache["ckv"].shape[1])
    if _q_split(params, cfg, part) or seq.groups:
        return _mla_decode_split(params, x, cache, positions, cfg, part, seq,
                                 scale)
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


def _mla_decode_split(params, x, cache, positions, cfg: ModelConfig, part,
                      seq: "_SeqSplit", scale):
    """``mla_decode`` on this rank's heads and slots of the latent cache;
    the absorbed query is gathered over ``model`` when the slots are
    split over it."""
    b = x.shape[0]
    split = _q_split(params, cfg, part)
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv_prefill(
        params, x, positions[:, None], cfg, part)
    local, own = seq.slots(positions, 0)
    idx = (torch.arange(b, device=x.device), local)
    _write(cache["ckv"], idx, own, ckv_new[:, 0])
    _write(cache["krope"], idx, own, kr_new[:, 0])
    _write(cache["pos"], idx, own, positions.to(torch.int32))
    ckv, krope = cache["ckv"], cache["krope"]
    q_abs = einsum("bshk,rhk->bshr", q_nope, params["wk_b"])
    hl = q_abs.shape[2]
    every = split and "model" in seq.axes
    if every:
        q_abs = part.gather_model(q_abs, 2)
        q_rope = part.gather_model(q_rope, 2)
    scores = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope.float())) * scale      # [B,H,1,T]
    pt = cache["pos"][:, None, None, :]
    mask = (pt >= 0) & (pt <= positions[:, None, None, None])
    if seq.groups:
        ctx_c = _merged_context(scores, mask, ckv, "bhst,btr->bshr",
                                seq.groups).to(x.dtype)
    else:
        p = _masked_softmax(scores, mask)
        ctx_c = einsum("bhst,btr->bshr", p.to(x.dtype), ckv)
    if every:
        ctx_c = ctx_c.narrow(2, part.mi * hl, hl)
    ctx = einsum("bshr,rhv->bshv", ctx_c, params["wv_b"])
    out = einsum("bshv,hvd->bsd", ctx, params["wo"])
    return part.g(out) if split else out


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec decoder layers)
# ---------------------------------------------------------------------------

def cross_attn_kv(params, memory, *, cfg=None, part=None):
    """memory: [B,F,d] encoder output (under ``part.seq`` this rank's
    frames) -> (ck, cv) [B,F,KV,hd] over every frame; with ``part`` (and
    ``cfg``) this rank's KV heads, or whole on every rank when they are
    not split."""
    if part is None:
        return (einsum("bfd,dhk->bfhk", memory, params["wk"]),
                einsum("bfd,dhk->bfhk", memory, params["wv"]))
    split = _q_split(params, cfg, part)
    me = part.enter(memory, split)
    if split and params["wk"].shape[1] == cfg.attn.num_kv_heads:
        ma = part.alike(me, memory)
        return (part.f(einsum("bfd,dhk->bfhk", ma, params["wk"])),
                part.f(einsum("bfd,dhk->bfhk", ma, params["wv"])))
    return (einsum("bfd,dhk->bfhk", me, params["wk"]),
            einsum("bfd,dhk->bfhk", me, params["wv"]))


def cross_attn(params, x, ck, cv, cfg: ModelConfig, *, kv_len=None,
               impl: str = "auto", part=None, cspec=None):
    """x: [B,S,d]; attends (non-causal, no RoPE) over the encoder memory's
    K/V [B,F,KV,hd].  Without ``kv_len`` every frame counts and the call
    goes through the flash kernel (prefill); with ``kv_len`` [B] (decode
    over the slot cache) frames past each row's count are masked, in
    plain PyTorch as ``gqa_decode`` attends.  With ``part``: this rank's
    query heads, row-parallel ``wo``; in decode ``ck`` / ``cv`` are the
    stored shards (``cspec``), never gathered."""
    a = cfg.attn
    b, s, _ = x.shape
    split = _q_split(params, cfg, part)
    if split or (part is not None and part.seq) or _SeqSplit(
            part, cspec, "ck", ck.shape[1]).groups:
        return _cross_attn_split(params, x, ck, cv, cfg, kv_len, impl, part,
                                 cspec)
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


def _cross_attn_split(params, x, ck, cv, cfg: ModelConfig, kv_len, impl,
                      part, cspec):
    """``cross_attn`` on this rank's query heads, and in decode on its
    heads or frames of the stored cross cache; under ``part.seq`` on this
    rank's rows of the decoder's stream."""
    a = cfg.attn
    split = _q_split(params, cfg, part)
    q = einsum("bsd,dhk->bshk", part.enter(x, split), params["wq"])
    b, s, hl = q.shape[:3]
    if kv_len is None:
        if split and ck.shape[2] == a.num_kv_heads:
            ck = _kv_for_heads(ck, part.mi * hl, hl, a.num_heads)
            cv = _kv_for_heads(cv, part.mi * hl, hl, a.num_heads)
        ctx = flash_attention(q.contiguous(), ck.contiguous(),
                              cv.contiguous(), causal=False, impl=impl)
    else:
        seq = _SeqSplit(part, cspec, "ck", ck.shape[1])
        every = split and "model" in seq.axes
        if every:
            q = part.gather_model(q, 2)
        elif split and ck.shape[2] == a.num_kv_heads:
            ck = _kv_for_heads(ck, part.mi * hl, hl, a.num_heads)
            cv = _kv_for_heads(cv, part.mi * hl, hl, a.num_heads)
        hq, kvh = q.shape[2], ck.shape[2]
        qg = q.reshape(b, s, kvh, hq // kvh, a.head_dim)
        scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                              ck.float()) / float(a.head_dim) ** 0.5
        frames = seq.lo + torch.arange(ck.shape[1], device=x.device)
        mask = (frames[None, :] < kv_len[:, None])[:, None, None, None, :]
        if seq.groups:
            ctx = _merged_context(scores, mask, cv, "bkgst,btkh->bskgh",
                                  seq.groups).to(x.dtype)
        else:
            p = _masked_softmax(scores, mask)
            ctx = einsum("bkgst,btkh->bskgh", p.to(x.dtype), cv)
        ctx = ctx.reshape(b, s, hq, a.head_dim)
        if every:
            ctx = ctx.narrow(2, part.mi * hl, hl)
    out = einsum("bshk,hkd->bsd", ctx.reshape(b, s, hl, a.head_dim),
                 params["wo"])
    return part.leave(out, split)
