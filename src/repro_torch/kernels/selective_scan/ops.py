"""Public entry point for the Mamba selective scan, the twin of
``repro/kernels/selective_scan/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs).

The kernel has no backward yet (ROADMAP A7.2): on the kernel path, with
grad mode on and an input that requires a gradient, the call raises
rather than return an output that autograd cannot see through.  The
plain version is differentiable, so the CPU path trains.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan import kernel as _kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

_IMPLS = ("auto", "kernel", "ref")


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "selective_scan: the CUDA kernel has no backward yet (it comes "
            "in ROADMAP A7.2), so its output would carry no gradient; "
            "train this model on the CPU path or call under "
            "torch.no_grad()")


def selective_scan(x, delta, a, b, c, d, h0=None, *, impl: str = "auto"):
    """x/delta: [B,S,D]; a: [D,N]; b/c: [B,S,N]; d: [D]; h0: [B,D,N].

    Returns (y [B,S,D] in x's dtype, h_final [B,D,N] f32)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown selective_scan impl {impl!r}")
    use_ref = impl == "ref" or (impl == "auto" and x.device.type == "cpu")
    if not use_ref:
        _refuse_grad(x, delta, a, b, c, d, h0)
    fn = selective_scan_ref if use_ref else _kernel.selective_scan
    return fn(x, delta, a, b, c, d, h0)


__all__ = ["selective_scan", "selective_scan_ref"]
