"""Public entry points for paged attention (decode and ragged mixed), the
twin of ``repro/kernels/paged_attention/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs).

Contract expected by both paths (as in the JAX package): ``block_tables``
may be narrower than the maximum pages per sequence, every table entry is
a valid page index, and every query row's position maps to a key slot
whose page holds real data (pad rows carry position 0).  When the pages are
int8, ``k_scales``/``v_scales`` carry the per-page-row scales
``[P, page, KV]``.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel as _kernel
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_mixed_ref,
    paged_attention_ref,
)

_IMPLS = ("auto", "kernel", "ref")


def _use_ref(impl: str, q) -> bool:
    if impl not in _IMPLS:
        raise ValueError(f"unknown paged_attention impl {impl!r}")
    return impl == "ref" or (impl == "auto" and q.device.type == "cpu")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None, impl: str = "auto",
                    k_scales=None, v_scales=None):
    """q: [B,H,hd]; pages: [P,page,KV,hd]; tables: [B,PPS]; lengths: [B]."""
    fn = paged_attention_ref if _use_ref(impl, q) else _kernel.paged_attention
    return fn(q, k_pages, v_pages, block_tables, lengths, scale=scale,
              k_scales=k_scales, v_scales=v_scales)


def paged_attention_mixed(q, k_pages, v_pages, block_tables, q_positions, *,
                          scale=None, impl: str = "auto",
                          k_scales=None, v_scales=None):
    """q: [B,Q,H,hd]; q_positions: [B,Q] per-row sequence positions."""
    fn = (paged_attention_mixed_ref if _use_ref(impl, q)
          else _kernel.paged_attention_mixed)
    return fn(q, k_pages, v_pages, block_tables, q_positions, scale=scale,
              k_scales=k_scales, v_scales=v_scales)


__all__ = ["paged_attention", "paged_attention_mixed",
           "paged_attention_ref", "paged_attention_mixed_ref"]
