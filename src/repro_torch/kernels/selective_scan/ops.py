"""Public entry point for the Mamba selective scan, the twin of
``repro/kernels/selective_scan/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs).
"""
from __future__ import annotations

from repro_torch.kernels.selective_scan import kernel as _kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

_IMPLS = ("auto", "kernel", "ref")


def selective_scan(x, delta, a, b, c, d, h0=None, *, impl: str = "auto"):
    """x/delta: [B,S,D]; a: [D,N]; b/c: [B,S,N]; d: [D]; h0: [B,D,N].

    Returns (y [B,S,D] in x's dtype, h_final [B,D,N] f32)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown selective_scan impl {impl!r}")
    use_ref = impl == "ref" or (impl == "auto" and x.device.type == "cpu")
    fn = selective_scan_ref if use_ref else _kernel.selective_scan
    return fn(x, delta, a, b, c, d, h0)


__all__ = ["selective_scan", "selective_scan_ref"]
