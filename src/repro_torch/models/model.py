"""Model assembly for decoder stacks of GQA attention + dense FFN layers and
RWKV-6 layers: the PyTorch twin of the parts of ``repro/models/model.py``
that serving runs (``prefill`` and ``decode_step`` for the dense slot-cache
backend; the paged runtime uses the layer pieces).

Parameters keep the JAX plan's names and layouts (``wq [d,H,hd]``,
``w_in [d,2,ff]``, period leaves stacked ``[repeats, ...]``), so the weight
bridge is a name-for-name copy and the einsums carry over one to one.  The
period runs as a Python loop over per-repeat views of the stacked
parameters and caches, where the JAX package runs ``lax.scan``;
``decode_step`` writes each layer's cache IN PLACE through those views
(the JAX code returns a new cache).  MoE, Mamba, cross-attention and
frontends are later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import einsum, gated_ffn, rms_norm, softcap
from repro_torch.models.params import P, init_from_plan, map_plan, torch_dtype


# ---------------------------------------------------------------------------
# Parameter plans
# ---------------------------------------------------------------------------

def dense_ffn_plan(cfg: ModelConfig, spec) -> dict:
    d = cfg.d_model
    return {
        "w_in": P((d, 2, spec.d_ff)),
        "w_out": P((spec.d_ff, d), fan_in=spec.d_ff),
    }


def layer_plan(cfg: ModelConfig, layer: LayerSpec) -> dict:
    if layer.cross_attn or (layer.mixer, layer.ffn) not in (
            ("attn", "dense"), ("attn", "none"), ("rwkv6", "rwkv_cm")):
        raise NotImplementedError(
            f"layer {layer} is not ported yet (attention + dense FFN and "
            f"RWKV-6 only)")
    d = cfg.d_model
    plan: Dict[str, Any] = {"norm1": P((d,), dtype="float32", init="zeros")}
    if layer.mixer == "attn":
        plan["attn"] = attn_mod.attention_plan(cfg, layer)
    else:
        # rwkv channel-mix params live inside the rwkv plan
        plan["rwkv"] = rwkv_mod.rwkv_plan(cfg)
    if layer.ffn == "dense":
        plan["norm2"] = P((d,), dtype="float32", init="zeros")
        plan["ffn"] = dense_ffn_plan(cfg, cfg.ffn_spec_for(layer))
    return plan


def stack_plan(plan, n: int):
    """Stack every leaf on a leading ``[n]`` axis, keeping ``fan_in`` (a
    leaf without one then scales by ``n``, as in the JAX package)."""
    return map_plan(lambda p: P((n,) + tuple(p.shape), dtype=p.dtype,
                                init=p.init, fan_in=p.fan_in), plan)


def model_plan(cfg: ModelConfig) -> dict:
    if cfg.encoder is not None or cfg.frontend.kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoders and frontends are not ported yet")
    d, v = cfg.d_model, cfg.vocab_size
    plan: Dict[str, Any] = {
        "embed": P((v, d), init="small"),
        "final_norm": P((d,), dtype="float32", init="zeros"),
    }
    if not cfg.tie_embeddings:
        plan["lm_head"] = P((d, v))
    if cfg.prefix:
        plan["prefix"] = {f"layer{i}": layer_plan(cfg, l)
                          for i, l in enumerate(cfg.prefix)}
    if cfg.period:
        period = {f"sub{i}": layer_plan(cfg, l)
                  for i, l in enumerate(cfg.period)}
        plan["period"] = stack_plan(period, cfg.repeats)
    return plan


def layer_cache_plan(cfg: ModelConfig, layer: LayerSpec, batch: int,
                     seq_cap: int) -> dict:
    if layer.mixer == "attn":
        return {"self": attn_mod.attn_cache_plan(cfg, layer, batch, seq_cap)}
    if layer.mixer == "rwkv6":
        return {"self": rwkv_mod.rwkv_state_plan(cfg, batch)}
    raise NotImplementedError(f"mixer {layer.mixer!r} is not ported yet")


def cache_plan(cfg: ModelConfig, batch: int, seq_cap: int) -> dict:
    """The dense decode cache: prefix leaves ``[batch, ...]``, period
    leaves stacked ``[repeats, batch, ...]``."""
    plan: Dict[str, Any] = {}
    if cfg.prefix:
        plan["prefix"] = {
            f"layer{i}": layer_cache_plan(cfg, l, batch, seq_cap)
            for i, l in enumerate(cfg.prefix)}
    if cfg.period:
        period = {f"sub{i}": layer_cache_plan(cfg, l, batch, seq_cap)
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

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _apply_ffn(lp, h, layer: LayerSpec, cfg: ModelConfig):
    """Residual dense gated FFN (``layer.ffn == "none"`` passes through;
    the RWKV channel-mix runs inside the rwkv6 layer, as in JAX)."""
    if layer.ffn == "none":
        return h
    if layer.ffn != "dense":
        raise NotImplementedError(f"ffn {layer.ffn!r} is not ported yet")
    x = rms_norm(h, lp["norm2"], cfg.norm_eps)
    fspec = cfg.ffn_spec_for(layer)
    return h + gated_ffn(x, lp["ffn"]["w_in"], lp["ffn"]["w_out"],
                         fspec.activation)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def apply_layer_seq(lp, h, layer: LayerSpec, cfg: ModelConfig, positions, *,
                    seq_cap: int, impl: str = "auto"):
    """Full-sequence (prefill) layer application from an empty state.
    h: [B,S,d]; positions: [B,S], each row ``arange(S)``.  Returns
    (h, cache) with ``cache`` as ``layer_cache_plan`` lays it out."""
    xin = rms_norm(h, lp["norm1"], cfg.norm_eps)
    if layer.mixer == "attn":
        out, (k, v) = attn_mod.gqa_prefill(lp["attn"], xin, positions,
                                           layer, cfg, impl=impl)
        cache = {"self": attn_mod.build_gqa_cache(k, v, positions, layer,
                                                  seq_cap)}
        return _apply_ffn(lp, h + out, layer, cfg), cache
    if layer.mixer != "rwkv6":
        raise NotImplementedError(f"mixer {layer.mixer!r} is not ported yet")
    b, d = h.shape[0], h.shape[-1]
    heads, hd = rwkv_mod._dims(cfg)
    zeros = torch.zeros((b, d), dtype=h.dtype, device=h.device)
    wkv0 = torch.zeros((b, heads, hd, hd), dtype=torch.float32,
                       device=h.device)
    out, (new_shift, new_wkv) = rwkv_mod.rwkv_time_mix(
        lp["rwkv"], xin, zeros, wkv0, cfg, impl=impl)
    h = h + out
    # channel-mix (rwkv ffn) with its own shift state
    cm_out, new_cm = rwkv_mod.rwkv_channel_mix(lp["rwkv"], h, zeros)
    cache = {"self": {"shift_att": new_shift, "shift_ffn": new_cm,
                      "wkv": new_wkv}}
    return h + cm_out, cache


def apply_layer_decode(lp, h, layer: LayerSpec, cfg: ModelConfig, positions,
                       cache, *, impl: str = "auto"):
    """Single-token layer application.  h: [B,1,d]; positions: [B].
    Updates ``cache`` (this layer's) in place and returns h."""
    xin = rms_norm(h, lp["norm1"], cfg.norm_eps)
    if layer.mixer == "attn":
        out = attn_mod.gqa_decode(lp["attn"], xin, cache["self"], positions,
                                  layer, cfg)
        return _apply_ffn(lp, h + out, layer, cfg)
    if layer.mixer != "rwkv6":
        raise NotImplementedError(f"mixer {layer.mixer!r} is not ported yet")
    st = cache["self"]
    out, (new_shift, new_wkv) = rwkv_mod.rwkv_time_mix(
        lp["rwkv"], xin, st["shift_att"], st["wkv"], cfg, impl=impl)
    h = h + out
    cm_out, new_cm = rwkv_mod.rwkv_channel_mix(lp["rwkv"], h,
                                               st["shift_ffn"])
    st["shift_att"].copy_(new_shift)
    st["shift_ffn"].copy_(new_cm)
    st["wkv"].copy_(new_wkv)
    return h + cm_out


def _logits(params, cfg: ModelConfig, h):
    """h: [..., d] -> f32 logits [..., V] (upcast before the softcap)."""
    if cfg.tie_embeddings:
        logits = einsum("...d,vd->...v", h, params["embed"])
    else:
        logits = einsum("...d,dv->...v", h, params["lm_head"])
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# Full-model forward passes
# ---------------------------------------------------------------------------

def _stack(trees):
    """Stack a list of equal nested dicts of tensors along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def forward_seq(params, cfg: ModelConfig, h, positions, *, seq_cap: int,
                impl: str = "auto"):
    """Runs the prefix and the period.  Returns (h, caches) laid out as
    ``cache_plan`` (period leaves stacked ``[repeats, ...]``)."""
    caches: Dict[str, Any] = {}
    period: Dict[str, list] = {}
    for lp, layer, _, (group, key, _) in layer_walk(cfg, params):
        h, c = apply_layer_seq(lp, h, layer, cfg, positions,
                               seq_cap=seq_cap, impl=impl)
        if group == "prefix":
            caches.setdefault("prefix", {})[key] = c
        else:
            period.setdefault(key, []).append(c)
    if period:
        caches["period"] = {k: _stack(cs) for k, cs in period.items()}
    return h, caches


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, *, seq_cap=None,
            impl: str = "auto"):
    """tokens: [B,S] (positions ``arange(S)``).  Returns (last-token logits
    [B,V] f32, decode cache with capacity ``seq_cap``)."""
    h = embed_tokens(params, cfg, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    h, caches = forward_seq(params, cfg, h, positions,
                            seq_cap=seq_cap or s, impl=impl)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h[:, -1]), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, token, positions, *,
                impl: str = "auto"):
    """token: [B]; positions: [B] int32.  Writes this token into ``cache``
    in place and returns logits [B,V] f32."""
    h = embed_tokens(params, cfg, token[:, None])
    for lp, layer, lc, _ in layer_walk(cfg, params, cache):
        h = apply_layer_decode(lp, h, layer, cfg, positions, lc, impl=impl)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h[:, 0])


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
