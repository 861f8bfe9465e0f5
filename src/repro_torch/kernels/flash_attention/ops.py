"""Public entry point for prefill attention, the twin of
``repro/kernels/flash_attention/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs), differentiated by
                   autograd when a gradient is wanted.

When grad mode is on and an input requires a gradient, ``"auto"`` and
``"kernel"`` go through :class:`FlashAttentionFn`: its forward also keeps
the per-row log-sum-exp, and its backward is the backward kernel on CUDA
tensors and that kernel's plain version (by formula) on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import kernel_bwd as _kernel_bwd
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

_IMPLS = ("auto", "kernel", "ref")


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a hand-written backward: (q, k, v) -> out, saving
    q, k, v, out and the f32 log-sum-exp [B,H,S] for the backward.
    ``use_kernel`` picks the CUDA kernels (forward and backward), else
    their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, use_kernel, causal, window, softcap, scale):
        opts = dict(causal=causal, window=window, softcap=softcap,
                    scale=scale)
        fwd = _kernel.flash_attention if use_kernel else flash_attention_ref
        out, lse = fwd(q, k, v, return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.use_kernel = use_kernel
        ctx.opts = opts
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (_kernel_bwd.flash_attention_bwd if ctx.use_kernel
               else flash_attention_bwd_ref)
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, impl: str = "auto"):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd].  Returns [B,S,H,hd]."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if impl == "ref":
        return flash_attention_ref(q, k, v, **opts)
    use_kernel = impl == "kernel" or q.device.type != "cpu"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, use_kernel, causal, window,
                                      softcap, scale)
    fn = _kernel.flash_attention if use_kernel else flash_attention_ref
    return fn(q, k, v, **opts)


__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd_ref",
           "flash_attention_ref"]
