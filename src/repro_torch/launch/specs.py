"""Input stand-ins and their layouts for every model input (the PyTorch
twin of ``repro/launch/specs.py``): ``device="meta"`` tensors (shape and
dtype, no memory) in place of ``ShapeDtypeStruct``s, and DTensor
placements of the resolved specs in place of ``NamedSharding``s.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.shardings import _bd, make_policy, spec_tree_placements
from repro_torch.models.model import cache_plan
from repro_torch.models.params import P, pspecs_from_plan, specs_from_plan


def _decoder_text_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Text positions for multimodal models so total tokens == seq_len."""
    if cfg.frontend.kind == "vision":
        return shape.seq_len - cfg.frontend.num_prefix
    if cfg.encoder is not None:
        # enc-dec: encoder consumes seq_len frames; decoder gets a prompt
        return min(128, shape.seq_len) if shape.mode == "prefill" \
            else shape.seq_len
    return shape.seq_len


def batch_plan(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, P]:
    bd = _bd(mesh)
    b = shape.global_batch
    tok = (bd, None) if b > 1 else ()
    s_text = _decoder_text_len(cfg, shape)
    plan: Dict[str, P] = {}
    if cfg.encoder is not None:
        plan["frames"] = P((b, shape.seq_len, cfg.frontend.embed_dim),
                           dtype="bfloat16", pspec=tok + (None,))
        plan["tokens"] = P((b, s_text), dtype="int32", pspec=tok)
    elif cfg.frontend.kind == "vision":
        plan["embeds"] = P((b, cfg.frontend.num_prefix,
                            cfg.frontend.embed_dim), dtype="bfloat16",
                           pspec=tok + (None,))
        plan["tokens"] = P((b, s_text), dtype="int32", pspec=tok)
    else:
        plan["tokens"] = P((b, shape.seq_len), dtype="int32", pspec=tok)
    if shape.mode == "train":
        plan["labels"] = P(plan["tokens"].shape, dtype="int32", pspec=tok)
    return plan


def decode_arg_plans(cfg: ModelConfig, shape: InputShape, mesh):
    """(cache_plan, token_plan, positions_plan) for serve_step."""
    policy = make_policy(cfg, shape, mesh)
    b = shape.global_batch
    bd = _bd(mesh)
    tok = (bd,) if b > 1 else ()
    enc_len = shape.seq_len if cfg.encoder is not None else 0
    cplan = cache_plan(cfg, b, shape.seq_len, enc_len, policy=policy)
    return (cplan,
            P((b,), dtype="int32", pspec=tok),
            P((b,), dtype="int32", pspec=tok))


def _layout(plan, mesh):
    return spec_tree_placements(pspecs_from_plan(plan, mesh), mesh)


def input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    """All meta-tensor stand-ins and their placements for one combo.

    Returns {"args": tuple, "placements": tuple, "policy": ShardPolicy}
    where args excludes params/opt-state (those come from the model
    plan)."""
    policy = make_policy(cfg, shape, mesh)
    if shape.mode in ("train", "prefill"):
        bplan = batch_plan(cfg, shape, mesh)
        return {"args": (specs_from_plan(bplan),),
                "placements": (_layout(bplan, mesh),),
                "policy": policy}
    plans = decode_arg_plans(cfg, shape, mesh)
    return {"args": tuple(specs_from_plan(p) for p in plans),
            "placements": tuple(_layout(p, mesh) for p in plans),
            "policy": policy}
