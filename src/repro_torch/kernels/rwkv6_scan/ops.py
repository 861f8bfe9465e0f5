"""Public entry point for the RWKV-6 WKV scan, the twin of
``repro/kernels/rwkv6_scan/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs).
"""
from __future__ import annotations

from repro_torch.kernels.rwkv6_scan import kernel as _kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

_IMPLS = ("auto", "kernel", "ref")


def rwkv6_scan(r, k, v, w, u, s0=None, *, impl: str = "auto"):
    """r/k/v/w: [B,S,H,hd]; u: [H,hd]; s0: [B,H,hd,hd].

    Returns (y [B,S,H,hd], s_final [B,H,hd,hd] f32)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown rwkv6_scan impl {impl!r}")
    use_ref = impl == "ref" or (impl == "auto" and r.device.type == "cpu")
    fn = rwkv6_scan_ref if use_ref else _kernel.rwkv6_scan
    return fn(r, k, v, w, u, s0)


__all__ = ["rwkv6_scan", "rwkv6_scan_ref"]
