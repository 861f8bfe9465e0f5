"""Shared model components: norms, RoPE, activations and the sharding
policy's fields (the PyTorch twin of ``repro/models/common.py``).

The reference's ``shard()`` constrains an activation's layout inside a
jitted program; an eager step has no such program, so the port keeps the
policy's fields only (the cache plans read them) and its step places the
data instead (``launch/steps.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ShardPolicy:
    """Activation sharding policy, resolved per (arch x input shape x
    mesh).  Each field is a spec tuple (or None = no constraint)."""
    act: Optional[Tuple] = None          # [B, S, d]
    heads: Optional[Tuple] = None        # [B, S, H, hd]
    kv_cache: Optional[Tuple] = None     # [B, S, KV, hd]
    mla_cache: Optional[Tuple] = None    # [B, S, ckv(+rope)]
    state: Optional[Tuple] = None        # [B, d_inner, ...] recurrent state
    moe_buf: Optional[Tuple] = None      # [E, C, d]
    logits: Optional[Tuple] = None       # [B, S, V] / [B, V]


NO_POLICY = ShardPolicy()


def einsum(equation: str, *operands):
    """``torch.einsum`` with JAX's type promotion: the operands are cast to
    their promoted dtype first (bf16 weights meet f32 activations in f32,
    exactly, as ``jnp.einsum`` does)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(equation, *(o.to(dt) for o in operands))


def rms_norm(x, weight, eps: float = 1e-5):
    """RMS norm in f32, scaled by ``1 + weight`` (zero-init weights)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """Split-half RoPE.  x: [..., S, H, hd]; positions: broadcastable to
    [..., S].  Angles in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs                  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                          # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def gated_ffn(x, w_in, w_out, activation: str):
    """w_in: [d, 2, ff] (gate, up); w_out: [ff, d].  x: [..., d]."""
    gu = einsum("...d,dcf->...cf", x, w_in)
    gate, up = gu[..., 0, :], gu[..., 1, :]
    h = act_fn(activation)(gate) * up
    return einsum("...f,fd->...d", h, w_out)


def cross_entropy_loss(logits, labels):
    """logits: [B, S, V], labels: [B, S] int.  The mean over tokens of the
    causal-LM cross-entropy, in f32, the row max held out of the gradient
    (JAX's ``stop_gradient``)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    tgt = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    tgt = tgt + m[..., 0]
    return (lse - tgt).mean()
