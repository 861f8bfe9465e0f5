"""Public entry point for prefill attention, the twin of
``repro/kernels/flash_attention/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_IMPLS = ("auto", "kernel", "ref")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, impl: str = "auto"):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd].  Returns [B,S,H,hd]."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    use_ref = impl == "ref" or (impl == "auto" and q.device.type == "cpu")
    fn = flash_attention_ref if use_ref else _kernel.flash_attention
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              scale=scale)


__all__ = ["flash_attention", "flash_attention_ref"]
