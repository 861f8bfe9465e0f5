"""Model assembly for every config of the repository: decoder stacks of
GQA or MLA attention, Mamba and RWKV-6 mixers with dense or MoE FFNs, the
VLM frontend's patch prefix and the enc-dec encoder with cross-attending
decoder layers; the PyTorch twin of ``repro/models/model.py``: ``train_loss``
for training, ``prefill`` and ``decode_step`` for the dense slot-cache
backend (the paged runtime uses the layer pieces).

Parameters keep the JAX plan's names and layouts (``wq [d,H,hd]``,
``w_in [d,2,ff]``, period leaves stacked ``[repeats, ...]``), so the weight
bridge is a name-for-name copy and the einsums carry over one to one.  The
period (and the encoder) runs as a Python loop over per-repeat views of the
stacked parameters and caches, where the JAX package runs ``lax.scan``;
``decode_step`` writes each layer's self-attention or state cache IN PLACE
through those views (the JAX code returns a new cache) and leaves the
cross-attention K/V untouched, as the reference does.  The MoE
load-balance loss is summed over layers in ``forward_seq`` (``train_loss``
adds it to the loss) and dropped in decode, as serving drops it.  A
training forward builds no cache, and with ``remat`` each period repeat
runs under ``torch.utils.checkpoint``, where JAX checkpoints the scan body.

Under a sharded step's sequence parallelism (``part.seq``,
``models/partition.py``) the residual stream between blocks is this
rank's ``S / m`` rows: the embedding gives them (a reduce-scatter along S
when the vocabulary is split; this rank's tokens' rows when it is whole),
each block enters and leaves through ``part.enter`` / ``part.leave``, the
norms run on the rows, and the head gathers the stream along S.  A VLM's
or an encoder's input is made whole and cut to the rank's rows.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (NO_POLICY, ShardPolicy,
                                      cross_entropy_loss, einsum, gated_ffn,
                                      rms_norm, softcap)
from repro_torch.models.params import P, init_from_plan, map_plan, torch_dtype


# ---------------------------------------------------------------------------
# Parameter plans
# ---------------------------------------------------------------------------

def dense_ffn_plan(cfg: ModelConfig, spec) -> dict:
    d = cfg.d_model
    return {
        "w_in": P((d, 2, spec.d_ff), pspec=("data", None, "model")),
        "w_out": P((spec.d_ff, d), fan_in=spec.d_ff, pspec=("model", "data")),
    }


def _ported(layer: LayerSpec) -> bool:
    if layer.cross_attn and layer.mixer != "attn":
        return False
    if layer.mixer == "rwkv6":
        return layer.ffn == "rwkv_cm"
    return layer.mixer in ("attn", "mamba") and layer.ffn in (
        "dense", "moe", "none")


def layer_plan(cfg: ModelConfig, layer: LayerSpec) -> dict:
    if not _ported(layer):
        raise NotImplementedError(
            f"layer {layer} is not one the port serves (attention or Mamba "
            f"with a dense, MoE or no FFN, cross-attention after attention "
            f"only; RWKV-6 with its channel-mix)")
    d = cfg.d_model
    plan: Dict[str, Any] = {"norm1": P((d,), dtype="float32", init="zeros",
                                       pspec=())}
    if layer.mixer == "attn":
        plan["attn"] = attn_mod.attention_plan(cfg, layer)
    elif layer.mixer == "mamba":
        plan["mamba"] = ssm_mod.mamba_plan(cfg)
    else:
        # rwkv channel-mix params live inside the rwkv plan
        plan["rwkv"] = rwkv_mod.rwkv_plan(cfg)
    if layer.cross_attn:
        plan["norm_x"] = P((d,), dtype="float32", init="zeros", pspec=())
        plan["cross"] = attn_mod.cross_attention_plan(cfg)
    if layer.ffn in ("dense", "moe"):
        plan["norm2"] = P((d,), dtype="float32", init="zeros", pspec=())
        fspec = cfg.ffn_spec_for(layer)
        if layer.ffn == "moe":
            plan["moe"] = moe_mod.moe_plan(cfg, fspec)
        else:
            plan["ffn"] = dense_ffn_plan(cfg, fspec)
    return plan


def _stack_leaf(p: P, n: int) -> P:
    return P((n,) + tuple(p.shape), dtype=p.dtype, init=p.init,
             fan_in=p.fan_in, pspec=(None,) + tuple(p.pspec),
             alt=(None,) + tuple(p.alt) if p.alt is not None else None)


def stack_plan(plan, n: int):
    """Stack every leaf on a leading ``[n]`` axis, keeping ``fan_in`` (a
    leaf without one then scales by ``n``, as in the JAX package); the
    stacked axis is never sharded."""
    return map_plan(lambda p: _stack_leaf(p, n), plan)


# the encoder's layers: non-causal self-attention and a dense FFN
ENCODER_LAYER = LayerSpec(mixer="attn", ffn="dense")


def model_plan(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    plan: Dict[str, Any] = {
        "embed": P((v, d), init="small", pspec=("model", "data")),
        "final_norm": P((d,), dtype="float32", init="zeros", pspec=()),
    }
    if not cfg.tie_embeddings:
        plan["lm_head"] = P((d, v), pspec=("data", "model"))
    if cfg.frontend.kind != "none":
        plan["frontend_proj"] = P((cfg.frontend.embed_dim, d),
                                  pspec=(None, "data"))
    if cfg.prefix:
        plan["prefix"] = {f"layer{i}": layer_plan(cfg, l)
                          for i, l in enumerate(cfg.prefix)}
    if cfg.period:
        period = {f"sub{i}": layer_plan(cfg, l)
                  for i, l in enumerate(cfg.period)}
        plan["period"] = stack_plan(period, cfg.repeats)
    if cfg.encoder:
        plan["encoder"] = {
            "period": stack_plan({"sub0": layer_plan(cfg, ENCODER_LAYER)},
                                 cfg.encoder.num_layers),
            "final_norm": P((d,), dtype="float32", init="zeros", pspec=()),
        }
    return plan


def layer_cache_plan(cfg: ModelConfig, layer: LayerSpec, batch: int,
                     seq_cap: int, enc_len: int = 0, *,
                     policy: ShardPolicy = NO_POLICY) -> dict:
    """A layer's decode cache: ``self`` (attention K/V or the recurrent
    state) and, for a cross-attending layer when ``enc_len`` > 0,
    ``cross`` (the encoder memory's K/V); sharded as ``policy`` says."""
    if layer.mixer == "attn":
        plan = {"self": attn_mod.attn_cache_plan(cfg, layer, batch, seq_cap,
                                                 policy=policy)}
    elif layer.mixer == "mamba":
        plan = {"self": ssm_mod.mamba_state_plan(cfg, batch, policy=policy)}
    elif layer.mixer == "rwkv6":
        plan = {"self": rwkv_mod.rwkv_state_plan(cfg, batch, policy=policy)}
    else:
        raise ValueError(layer.mixer)
    if layer.cross_attn and enc_len:
        plan["cross"] = attn_mod.cross_cache_plan(cfg, batch, enc_len,
                                                  policy=policy)
    return plan


def cache_plan(cfg: ModelConfig, batch: int, seq_cap: int,
               enc_len: int = 0, *, policy: ShardPolicy = NO_POLICY) -> dict:
    """The dense decode cache: prefix leaves ``[batch, ...]``, period
    leaves stacked ``[repeats, batch, ...]``; cross-attention leaves hold
    ``enc_len`` frames."""
    plan: Dict[str, Any] = {}
    if cfg.prefix:
        plan["prefix"] = {
            f"layer{i}": layer_cache_plan(cfg, l, batch, seq_cap, enc_len,
                                          policy=policy)
            for i, l in enumerate(cfg.prefix)}
    if cfg.period:
        period = {f"sub{i}": layer_cache_plan(cfg, l, batch, seq_cap,
                                              enc_len, policy=policy)
                  for i, l in enumerate(cfg.period)}
        plan["period"] = stack_plan(period, cfg.repeats)
    return plan


def layer_walk(cfg: ModelConfig, params, cache=None):
    """(layer params, LayerSpec, layer cache or None, (group, key, repeat))
    per layer in order: the prefix layers (repeat None), then each repeat
    of the period.  Period entries are per-repeat views of the stacked
    leaves, so an in-place write through a cache view lands in the stacked
    cache."""
    walk = []
    for i, layer in enumerate(cfg.prefix):
        key = f"layer{i}"
        walk.append((params["prefix"][key], layer,
                     cache["prefix"][key] if cache is not None else None,
                     ("prefix", key, None)))
    for r in range(cfg.repeats if cfg.period else 0):
        for i, layer in enumerate(cfg.period):
            sub = f"sub{i}"
            lc = (map_plan(lambda a: a[r], cache["period"][sub])
                  if cache is not None else None)
            walk.append((map_plan(lambda a: a[r], params["period"][sub]),
                         layer, lc, ("period", sub, r)))
    return walk


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens, part=None):
    """With ``part``: the embedding gathered at use; when its vocabulary is
    split over ``model``, each rank looks up the tokens of its rows of the
    vocabulary (zeros for the others) and the rows meet in a sum (under
    ``part.seq`` a reduce-scatter along S); a whole vocabulary under
    ``part.seq`` looks up this rank's tokens only."""
    if part is None:
        return params["embed"][tokens].to(torch_dtype(cfg.dtype))
    part.check_seq(tokens.shape[-1], "sequence")
    w = part.gather_params(params["embed"], part.specs["embed"])
    vl = w.shape[0]
    if vl == cfg.vocab_size:
        return part.shared(w)[part.seq_rows(tokens)].to(
            torch_dtype(cfg.dtype))
    local = tokens - part.mi * vl
    inside = (local >= 0) & (local < vl)
    rows = w[local.clamp(0, vl - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return part.leave(rows).to(torch_dtype(cfg.dtype))


def _zero(h):
    return torch.zeros((), dtype=torch.float32, device=h.device)


def _norm(h, w, cfg: ModelConfig, part):
    """``rms_norm`` of the stream, the weight taken through
    ``part.shared`` (its gradient summed over ``model`` under
    ``part.seq``)."""
    return rms_norm(h, w if part is None else part.shared(w), cfg.norm_eps)


def _ffn(lp, h, layer: LayerSpec, cfg: ModelConfig, part=None):
    """Residual dense gated FFN or MoE (``layer.ffn == "none"`` passes
    through; the RWKV channel-mix runs inside the rwkv6 layer, as in JAX).
    Returns (h, aux): aux is the MoE load-balance loss, else 0.  With
    ``part``, MoE routes over the rows of every row rank
    (``moe.moe_ffn``), and a dense FFN whose ``d_ff`` is split over
    ``model`` runs column- then row-parallel."""
    if layer.ffn == "none":
        return h, _zero(h)
    if layer.ffn not in ("dense", "moe"):
        raise ValueError(layer.ffn)
    x = _norm(h, lp["norm2"], cfg, part)
    fspec = cfg.ffn_spec_for(layer)
    if layer.ffn == "moe":
        out, aux = moe_mod.moe_ffn(lp["moe"], x, fspec, cfg, part=part)
        return h + out, aux
    w_in, w_out = lp["ffn"]["w_in"], lp["ffn"]["w_out"]
    if part is not None:
        split = w_in.shape[2] != fspec.d_ff
        return h + part.leave(gated_ffn(part.enter(x, split), w_in, w_out,
                                        fspec.activation), split), _zero(h)
    return h + gated_ffn(x, w_in, w_out, fspec.activation), _zero(h)


def _apply_ffn(lp, h, layer: LayerSpec, cfg: ModelConfig, part=None):
    """``_ffn`` without the load-balance loss (decode and serving)."""
    return _ffn(lp, h, layer, cfg, part)[0]


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _cross(lp, h, cfg: ModelConfig, ck, cv, *, kv_len=None,
           impl: str = "auto", part=None, cspec=None):
    """The residual cross-attention block of an enc-dec decoder layer."""
    xq = _norm(h, lp["norm_x"], cfg, part)
    return h + attn_mod.cross_attn(lp["cross"], xq, ck, cv, cfg,
                                   kv_len=kv_len, impl=impl, part=part,
                                   cspec=cspec)


def apply_layer_seq(lp, h, layer: LayerSpec, cfg: ModelConfig, positions, *,
                    seq_cap: int, memory=None, impl: str = "auto",
                    want_cache: bool = True, part=None):
    """Full-sequence (train / prefill) layer application from an empty
    state.  h: [B,S,d]; positions: [B,S], each row ``arange(S)``;
    ``memory`` [B,F,d], the encoder output a cross-attending layer reads.
    Returns (h, aux, cache): ``aux`` the MoE load-balance loss (0 for
    other FFNs), ``cache`` as ``layer_cache_plan`` lays it out when
    ``want_cache`` (else None, and no K/V copy is made).  With ``part``
    (``models/partition.py``) ``lp`` holds the layer's parameters gathered
    over the batch axes, and each piece runs on this rank's share of
    ``model``; the cache then holds this rank's heads or channels where
    they are split, whole sequences (the step cuts them).  Under
    ``part.seq`` h is this rank's rows and ``memory`` its frames;
    ``positions`` cover the whole sequence."""
    xin = _norm(h, lp["norm1"], cfg, part)
    cache = {} if want_cache else None
    if layer.mixer == "attn":
        if cfg.attn.kind == "mla":
            out, (ckv, krope) = attn_mod.mla_prefill(
                lp["attn"], xin, positions, layer, cfg, impl=impl, part=part)
            if want_cache:
                cache["self"] = attn_mod.build_mla_cache(ckv, krope,
                                                         positions, seq_cap)
        else:
            out, (k, v) = attn_mod.gqa_prefill(lp["attn"], xin, positions,
                                               layer, cfg, impl=impl,
                                               part=part)
            if want_cache:
                cache["self"] = attn_mod.build_gqa_cache(k, v, positions,
                                                         layer, seq_cap)
        h = h + out
        if layer.cross_attn and memory is not None:
            ck, cv = attn_mod.cross_attn_kv(lp["cross"], memory, cfg=cfg,
                                            part=part)
            h = _cross(lp, h, cfg, ck, cv, impl=impl, part=part)
            if want_cache:
                cache["cross"] = {"ck": ck, "cv": cv}
        return (*_ffn(lp, h, layer, cfg, part), cache)
    if layer.mixer == "mamba":
        out, state = ssm_mod.mamba_prefill(lp["mamba"], xin, cfg, impl=impl,
                                           part=part)
        if want_cache:
            cache["self"] = state
        return (*_ffn(lp, h + out, layer, cfg, part), cache)
    if layer.mixer != "rwkv6":
        raise ValueError(layer.mixer)
    b, d = h.shape[0], h.shape[-1]
    _, hd = rwkv_mod._dims(cfg)
    heads = lp["rwkv"]["u"].shape[0]        # this rank's heads
    zeros = torch.zeros((b, d), dtype=h.dtype, device=h.device)
    wkv0 = torch.zeros((b, heads, hd, hd), dtype=torch.float32,
                       device=h.device)
    out, (new_shift, new_wkv) = rwkv_mod.rwkv_time_mix(
        lp["rwkv"], xin, zeros, wkv0, cfg, impl=impl, part=part)
    h = h + out
    # channel-mix (rwkv ffn) with its own shift state
    cm_out, new_cm = rwkv_mod.rwkv_channel_mix(lp["rwkv"], h, zeros,
                                               cfg=cfg, part=part)
    if want_cache:
        cache["self"] = {"shift_att": new_shift, "shift_ffn": new_cm,
                         "wkv": new_wkv}
    return h + cm_out, _zero(h), cache


def apply_layer_decode(lp, h, layer: LayerSpec, cfg: ModelConfig, positions,
                       cache, *, cross_len=None, impl: str = "auto",
                       part=None, cspec=None):
    """Single-token layer application.  h: [B,1,d]; positions: [B];
    ``cross_len`` [B], the valid frames of each row's ``cross`` cache
    (all of them when None).  Updates ``cache["self"]`` (this layer's) in
    place, reads ``cache["cross"]`` only, and returns h.  With ``part``,
    ``cache`` is this rank's stored shard and ``cspec`` its resolved
    specs (``layer_cache_plan``'s keys)."""
    xin = rms_norm(h, lp["norm1"], cfg.norm_eps)
    cspec = cspec or {}
    if layer.mixer == "attn":
        decode = (attn_mod.mla_decode if cfg.attn.kind == "mla"
                  else attn_mod.gqa_decode)
        h = h + decode(lp["attn"], xin, cache["self"], positions, layer, cfg,
                       part=part, cspec=cspec.get("self"))
        if layer.cross_attn and "cross" in cache:
            ck, cv = cache["cross"]["ck"], cache["cross"]["cv"]
            if cross_len is None:
                cross_len = torch.full((h.shape[0],), ck.shape[1],
                                       device=h.device)
            h = _cross(lp, h, cfg, ck, cv, kv_len=cross_len, part=part,
                       cspec=cspec.get("cross"))
        return _apply_ffn(lp, h, layer, cfg, part)
    if layer.mixer == "mamba":
        out = ssm_mod.mamba_decode(lp["mamba"], xin, cache["self"], cfg,
                                   impl=impl, part=part)
        return _apply_ffn(lp, h + out, layer, cfg, part)
    if layer.mixer != "rwkv6":
        raise ValueError(layer.mixer)
    st = cache["self"]
    out, (new_shift, new_wkv) = rwkv_mod.rwkv_time_mix(
        lp["rwkv"], xin, st["shift_att"], st["wkv"], cfg, impl=impl,
        part=part)
    h = h + out
    cm_out, new_cm = rwkv_mod.rwkv_channel_mix(lp["rwkv"], h,
                                               st["shift_ffn"], cfg=cfg,
                                               part=part)
    st["shift_att"].copy_(new_shift)
    st["shift_ffn"].copy_(new_cm)
    st["wkv"].copy_(new_wkv)
    return h + cm_out


def _logits(params, cfg: ModelConfig, h, part=None, last=None):
    """h: [..., d] -> f32 logits [..., V] (upcast before the softcap).
    With ``part``: the head (or the tied embedding) gathered at use, and
    this rank's block of the vocabulary when it is split over ``model``
    (``[..., V / m]``); under ``part.seq`` h [B, S/m, d] is gathered
    along S first.  ``last``: the logits of the last ``last`` positions
    of h [B, S, d] only."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = params[name]
    if part is not None:
        w = part.gather_params(w, part.specs[name])
        vl = w.shape[0] if cfg.tie_embeddings else w.shape[1]
        h = part.enter(h, vl != cfg.vocab_size)
    if last is not None:
        h = h[:, -last:]
    if cfg.tie_embeddings:
        logits = einsum("...d,vd->...v", h, w)
    else:
        logits = einsum("...d,dv->...v", h, w)
    return softcap(logits.float(), cfg.final_logit_softcap)


def _vocab_block(cfg: ModelConfig, logits, part):
    """The first vocabulary id of this rank's logits, and whether the
    vocabulary is split."""
    vl = logits.shape[-1]
    return part.mi * vl, vl != cfg.vocab_size


def _whole_logits(cfg: ModelConfig, logits, part):
    """Logits [..., V]: the ``model`` ranks' blocks gathered (serving)."""
    if part is None or not _vocab_block(cfg, logits, part)[1]:
        return logits
    return part.gather_model(logits, logits.dim() - 1)


def _vocab_parallel_loss(cfg: ModelConfig, logits, labels, part):
    """``cross_entropy_loss`` over logits whose vocabulary is split over
    ``model``: the row max, the exponential sum and the target's logit
    each meet in an all-reduce (the max held out of the gradient)."""
    lo, split = _vocab_block(cfg, logits, part)
    if not split:
        return cross_entropy_loss(logits, labels)
    logits = logits.float()
    vl = logits.shape[-1]
    m = coll.all_reduce(logits.amax(dim=-1, keepdim=True).detach(),
                        part.tp, "max")
    shifted = logits - m
    lse = torch.log(part.g(torch.exp(shifted).sum(dim=-1))) + m[..., 0]
    local = labels.long() - lo
    inside = (local >= 0) & (local < vl)
    tgt = torch.gather(shifted, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = part.g(torch.where(inside, tgt, torch.zeros_like(tgt)))
    tgt = tgt + m[..., 0]
    return (lse - tgt).mean()


# ---------------------------------------------------------------------------
# Full-model forward passes
# ---------------------------------------------------------------------------

def _stack(trees):
    """Stack a list of equal nested dicts of tensors along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _period_repeats(params, cfg: ModelConfig):
    """Per repeat of the period, its layers' parameters as views of the
    stacked leaves: one ``unbind`` a leaf, so a gradient is stacked once a
    step (a view per repeat by indexing would give each repeat's gradient
    the stacked leaf's full size)."""
    unbound = map_plan(lambda a: a.unbind(0), params["period"])
    return [map_plan(lambda t, r=r: t[r], unbound)
            for r in range(cfg.repeats)]


def _period_repeat(lps, h, aux, cfg: ModelConfig, positions, kw):
    """One repeat of the period: (h, aux, {sub: cache}).  With a ``part``
    in ``kw`` its parameters are gathered here, so that under remat the
    backward's recompute gathers them again."""
    part = kw["part"]
    if part is not None:
        lps = part.gather_params(lps, part.specs["period"], stacked=True)
    caches = {}
    for i, layer in enumerate(cfg.period):
        h, a, caches[f"sub{i}"] = apply_layer_seq(lps[f"sub{i}"], h, layer,
                                                  cfg, positions, **kw)
        aux = aux + a
    return h, aux, caches


def _remat_repeat(lps, h, aux, cfg: ModelConfig, positions, kw):
    return _period_repeat(lps, h, aux, cfg, positions, kw)[:2]


def _prefix_layer(lp, h, aux, cfg: ModelConfig, positions, kw, i: int):
    """Prefix layer ``i``: (h, aux, cache), its parameters gathered here
    when ``kw`` has a ``part``."""
    part = kw["part"]
    if part is not None:
        lp = part.gather_params(lp, part.specs["prefix"][f"layer{i}"])
    h, a, c = apply_layer_seq(lp, h, cfg.prefix[i], cfg, positions, **kw)
    return h, aux + a, c


def _remat_prefix(lp, h, aux, cfg: ModelConfig, positions, kw, i: int):
    return _prefix_layer(lp, h, aux, cfg, positions, kw, i)[:2]


def _checkpoint(fn, *args, part=None):
    """``fn`` under ``torch.utils.checkpoint``; on a sharded step with
    more than one rank the recompute runs to the end (no early stop), so
    that it makes every collective the forward made."""
    if part is None or part.ranks == 1:
        return checkpoint(fn, *args, use_reentrant=False)
    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False)


def forward_seq(params, cfg: ModelConfig, h, positions, *, seq_cap: int,
                memory=None, impl: str = "auto", want_cache: bool = True,
                remat: bool = False, part=None):
    """Runs the prefix and the period.  Returns (h, caches, aux): the
    caches laid out as ``cache_plan`` (period leaves stacked
    ``[repeats, ...]``) when ``want_cache``, else None; ``aux`` the MoE
    load-balance loss summed over layers (f32 scalar).  With ``remat`` (a
    training forward, no cache) each period repeat keeps only its input
    for the backward and recomputes the rest there.  With ``part`` each
    prefix layer and each period repeat gathers its parameters alone, and
    under remat a prefix layer is checkpointed too, so no gathered layer
    is kept for the backward."""
    if remat and want_cache:
        raise ValueError("remat is for a training forward, without a cache")
    kw = dict(seq_cap=seq_cap, memory=memory, impl=impl,
              want_cache=want_cache, part=part)
    aux = _zero(h)
    caches: Dict[str, Any] = {}
    for i, layer in enumerate(cfg.prefix):
        key = f"layer{i}"
        lp = params["prefix"][key]
        if part is not None and remat and torch.is_grad_enabled():
            h, aux = _checkpoint(_remat_prefix, lp, h, aux, cfg, positions,
                                 kw, i, part=part)
            continue
        h, aux, c = _prefix_layer(lp, h, aux, cfg, positions, kw, i)
        caches.setdefault("prefix", {})[key] = c
    period: Dict[str, list] = {}
    for lps in (_period_repeats(params, cfg) if cfg.period else ()):
        if remat and torch.is_grad_enabled():
            h, aux = _checkpoint(_remat_repeat, lps, h, aux, cfg, positions,
                                 kw, part=part)
            continue
        h, aux, cs = _period_repeat(lps, h, aux, cfg, positions, kw)
        for key, c in cs.items():
            period.setdefault(key, []).append(c)
    if not want_cache:
        return h, None, aux
    if period:
        caches["period"] = {k: _stack(cs) for k, cs in period.items()}
    return h, caches, aux


def _use(params, name: str, part):
    """A top-level leaf, gathered at use under ``part``."""
    if part is None:
        return params[name]
    return part.gather_params(params[name], part.specs[name])


def _merge_frontend(params, cfg: ModelConfig, tokens, embeds=None,
                    part=None):
    """VLM: project the patch embeds [B,P,E] and put them before the token
    embeddings; without embeds (or a frontend) the token embeddings.
    Under ``part.seq``: this rank's rows of them (the patch prefix and the
    tokens made whole first)."""
    if embeds is None or cfg.frontend.kind == "none":
        return embed_tokens(params, cfg, tokens, part)
    if part is not None:
        part.check_seq(embeds.shape[1] + tokens.shape[1],
                       "patch prefix and sequence")
    h_tok = embed_tokens(params, cfg, tokens,
                         part if part is None else part.whole_seq())
    proj = einsum("bpe,ed->bpd", embeds.to(torch_dtype(cfg.dtype)),
                  _use(params, "frontend_proj", part))
    h = torch.cat([proj, h_tok], dim=1)
    return h if part is None else part.leave(h, False)


def _length(h, part) -> int:
    """The whole sequence's length of the stream h [B, S(/m), d]."""
    return h.shape[1] * (part.m if part is not None and part.seq else 1)


def _positions(h, part=None):
    """[B,S] int32, each row ``arange(S)``, for h [B,S,d] (S the whole
    sequence's length under ``part.seq``)."""
    b, s = h.shape[0], _length(h, part)
    return torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)


def _encoder_layer(lp, h, cfg: ModelConfig, positions, impl: str, part):
    if part is not None:
        lp = part.gather_params(lp, part.specs["encoder"]["period"]["sub0"],
                                stacked=True)
    xin = _norm(h, lp["norm1"], cfg, part)
    out, _ = attn_mod.gqa_prefill(lp["attn"], xin, positions, ENCODER_LAYER,
                                  cfg, causal=False, impl=impl, part=part)
    return _apply_ffn(lp, h + out, ENCODER_LAYER, cfg, part)


def encode(params, cfg: ModelConfig, frames, *, impl: str = "auto",
           part=None, remat: bool = False):
    """The enc-dec encoder.  frames: [B,F,embed_dim] (the stubbed
    frontend's output), projected, then per layer non-causal
    self-attention (RoPE at positions ``arange(F)``, the flash kernel) and
    a dense FFN; returns the normed memory [B,F,d].  With ``part`` each
    layer gathers its parameters alone and runs as a decoder layer does,
    under remat checkpointed as a period repeat is; under ``part.seq``
    the memory is this rank's frames."""
    h = einsum("bfe,ed->bfd", frames.to(torch_dtype(cfg.dtype)),
               _use(params, "frontend_proj", part))
    positions = _positions(h)
    if part is not None:
        part.check_seq(h.shape[1], "encoder's frames")
        h = part.leave(h, False)
    enc = params["encoder"]
    # per-layer views by one unbind a leaf, as _period_repeats
    layers = map_plan(lambda a: a.unbind(0), enc["period"]["sub0"])
    for r in range(cfg.encoder.num_layers):
        lp = map_plan(lambda t: t[r], layers)
        if part is not None and remat and torch.is_grad_enabled():
            h = _checkpoint(_encoder_layer, lp, h, cfg, positions, impl, part,
                            part=part)
        else:
            h = _encoder_layer(lp, h, cfg, positions, impl, part)
    norm = (enc["final_norm"] if part is None else part.gather_params(
        enc["final_norm"], part.specs["encoder"]["final_norm"]))
    return _norm(h, norm, cfg, part)


def train_loss(params, cfg: ModelConfig, batch, *, remat: bool = True,
               impl: str = "auto", part=None):
    """batch: {tokens [B,S], labels [B,S_text], embeds? [B,P,E] (a VLM's
    patches, before the tokens), frames? [B,F,E] (an enc-dec model's
    encoder input)}.  The causal-LM cross-entropy of the logits at the
    last ``S_text`` positions (the text tokens) against the labels, plus
    the MoE load-balance loss; no cache is built.  A scalar f32 tensor.
    ``part``: a sharded step's partition (``models/partition.py``):
    ``params`` and ``batch`` are then this rank's shards and rows, the
    loss this rank's rows' mean (MoE routes over every row rank's rows)."""
    memory = None
    if cfg.encoder is not None:
        memory = encode(params, cfg, batch["frames"], impl=impl, part=part,
                        remat=remat)
        h = embed_tokens(params, cfg, batch["tokens"], part)
    else:
        h = _merge_frontend(params, cfg, batch["tokens"],
                            batch.get("embeds"), part)
    h, _, aux = forward_seq(params, cfg, h, _positions(h, part),
                            seq_cap=_length(h, part), memory=memory,
                            impl=impl, want_cache=False, remat=remat,
                            part=part)
    s_text = batch["labels"].shape[1]
    if part is not None and part.seq:
        # the rows are this rank's: normed here, gathered by the head
        h = _norm(h, _use(params, "final_norm", part), cfg, part)
        logits = _logits(params, cfg, h, part, last=s_text)
    else:
        # the norm and the logits are per position: only the text rows'
        # are made
        h = rms_norm(h[:, -s_text:], _use(params, "final_norm", part),
                     cfg.norm_eps)
        logits = _logits(params, cfg, h, part)
    if part is None:
        return cross_entropy_loss(logits, batch["labels"]) + aux
    return _vocab_parallel_loss(cfg, logits, batch["labels"], part) + aux


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, *, embeds=None, frames=None,
            seq_cap=None, impl: str = "auto", part=None):
    """tokens: [B,S]; ``embeds`` [B,P,E], a VLM's patch embeddings, put
    before the tokens (positions ``arange(P + S)``); ``frames`` [B,F,E],
    an enc-dec model's encoder input (the tokens are then the decoder's).
    Returns (last-token logits [B,V] f32, decode cache with capacity
    ``seq_cap``; an enc-dec cache also holds each layer's ``cross`` K/V
    over the F frames).  With ``part`` the cache holds this rank's rows,
    its heads or channels where they are split over ``model``, and whole
    sequences; the logits are whole (under ``part.seq`` the last
    position's row comes from the last ``model`` rank)."""
    memory = None
    if cfg.encoder is not None:
        memory = encode(params, cfg, frames, impl=impl, part=part)
        h = embed_tokens(params, cfg, tokens, part)
    else:
        h = _merge_frontend(params, cfg, tokens, embeds, part)
    h, caches, _ = forward_seq(params, cfg, h, _positions(h, part),
                               seq_cap=seq_cap or _length(h, part),
                               memory=memory, impl=impl, part=part)
    if part is not None and part.seq:
        h = part.gather_model(h[:, -1:], 1)[:, -1:]
        part = part.whole_seq()
    h = rms_norm(h, _use(params, "final_norm", part), cfg.norm_eps)
    return _whole_logits(cfg, _logits(params, cfg, h[:, -1], part),
                         part), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, token, positions, *,
                cross_len=None, impl: str = "auto", part=None):
    """token: [B]; positions: [B] int32; ``cross_len`` [B], the valid
    frames of each row's cross-attention cache (all when None).  Writes
    this token into ``cache`` in place and returns logits [B,V] f32.
    With ``part``, ``cache`` is this rank's stored shard (its specs in
    ``part.cache_specs``), each layer gathers its parameters alone, and
    the logits are whole.  A ``part`` with a split sequence decodes with
    it whole."""
    if part is not None:
        part = part.whole_seq()
    h = embed_tokens(params, cfg, token[:, None], part)
    for lp, layer, lc, (group, key, r) in layer_walk(cfg, params, cache):
        cspec = None
        if part is not None:
            stacked = r is not None
            lp = part.gather_params(lp, part.specs[group][key], stacked)
            cspec = map_plan(lambda s: s[1:] if stacked else s,
                             part.cache_specs[group][key])
        h = apply_layer_decode(lp, h, layer, cfg, positions, lc,
                               cross_len=cross_len, impl=impl, part=part,
                               cspec=cspec)
    h = rms_norm(h, _use(params, "final_norm", part), cfg.norm_eps)
    return _whole_logits(cfg, _logits(params, cfg, h[:, 0], part), part)


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """A nested dict of tensors held as (frozen) module parameters, so the
    weights move, count and save like any ``nn.Module``'s."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def as_dict(self) -> dict:
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.as_dict() for k, m in self._modules.items()})
        return out


class Model(nn.Module):
    """A config with its plan and its parameters.

    ``params`` (a nested dict of tensors, e.g. from ``models/bridge.py``)
    is taken as given; otherwise the plan is initialised on ``device`` from
    ``generator`` (default: a generator on ``device`` seeded with
    ``seed``), and random RWKV-6 weights are rescaled so that a deep stack
    stays finite (``rwkv.stabilize_random``)."""

    def __init__(self, cfg: ModelConfig, params=None, *,
                 generator: torch.Generator = None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.plan = model_plan(cfg)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(seed)
            params = init_from_plan(self.plan, generator, dev)
            if any(layer.mixer == "rwkv6" for layer in cfg.layer_specs()):
                rwkv_mod.stabilize_random(params, self.plan, cfg.repeats)
        self.tree = _ParamTree(params)

    @property
    def params(self) -> dict:
        return self.tree.as_dict()
