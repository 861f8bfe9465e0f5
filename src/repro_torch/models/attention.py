"""GQA attention parameters and int8 KV quantization (the part of
``repro/models/attention.py`` the paged serving path needs; the dense
cache paths, MLA and cross-attention are later slices)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.params import P


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
