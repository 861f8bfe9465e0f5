"""Model assembly for pure attention + dense-FFN decoder stacks (the part of
``repro/models/model.py`` the paged serving path needs).

Parameters keep the JAX plan's names and layouts (``wq [d,H,hd]``,
``w_in [d,2,ff]``, period leaves stacked ``[repeats, ...]``), so the weight
bridge is a name-for-name copy and the einsums carry over one to one.
MoE, Mamba, RWKV, cross-attention and frontends are later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
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
    if layer.mixer != "attn" or layer.cross_attn or layer.ffn not in (
            "dense", "none"):
        raise NotImplementedError(
            f"layer {layer} is not ported yet (attention + dense FFN only)")
    d = cfg.d_model
    plan: Dict[str, Any] = {"norm1": P((d,), dtype="float32", init="zeros")}
    plan["attn"] = attn_mod.attention_plan(cfg, layer)
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


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _apply_ffn(lp, h, layer: LayerSpec, cfg: ModelConfig):
    """Residual dense gated FFN (``layer.ffn == "none"`` passes through)."""
    if layer.ffn == "none":
        return h
    if layer.ffn != "dense":
        raise NotImplementedError(f"ffn {layer.ffn!r} is not ported yet")
    x = rms_norm(h, lp["norm2"], cfg.norm_eps)
    fspec = cfg.ffn_spec_for(layer)
    return h + gated_ffn(x, lp["ffn"]["w_in"], lp["ffn"]["w_out"],
                         fspec.activation)


def _logits(params, cfg: ModelConfig, h):
    """h: [..., d] -> f32 logits [..., V] (upcast before the softcap)."""
    if cfg.tie_embeddings:
        logits = einsum("...d,vd->...v", h, params["embed"])
    else:
        logits = einsum("...d,dv->...v", h, params["lm_head"])
    return softcap(logits.float(), cfg.final_logit_softcap)


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
    ``seed``)."""

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
        self.tree = _ParamTree(params)

    @property
    def params(self) -> dict:
        return self.tree.as_dict()
