"""Public entry point for the RWKV-6 WKV scan, the twin of
``repro/kernels/rwkv6_scan/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs), differentiated by
                   autograd when a gradient is wanted.

When grad mode is on and an input requires a gradient, ``"auto"`` and
``"kernel"`` go through :class:`Rwkv6ScanFn`: its backward is the
backward kernel on CUDA tensors and that kernel's plain version (by
formula) on CPU tensors.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.rwkv6_scan import kernel as _kernel
from repro_torch.kernels.rwkv6_scan import kernel_bwd as _kernel_bwd
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_bwd_ref,
                                                rwkv6_scan_ref)

_IMPLS = ("auto", "kernel", "ref")


class Rwkv6ScanFn(torch.autograd.Function):
    """The WKV scan with a hand-written backward: (r, k, v, w, u, s0) ->
    (y, s_final), saving the six inputs; the backward takes the
    cotangents of both outputs (zeros for an unused one).  ``use_kernel``
    picks the CUDA kernels (forward and backward), else their plain
    versions."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, use_kernel):
        fwd = _kernel.rwkv6_scan if use_kernel else rwkv6_scan_ref
        y, s_final = fwd(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.use_kernel = use_kernel
        return y, s_final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds_final):
        bwd = (_kernel_bwd.rwkv6_scan_bwd if ctx.use_kernel
               else rwkv6_scan_bwd_ref)
        grads = bwd(*ctx.saved_tensors, dy.contiguous(),
                    ds_final.contiguous())
        return (*grads, None)


def rwkv6_scan(r, k, v, w, u, s0=None, *, impl: str = "auto"):
    """r/k/v/w: [B,S,H,hd]; u: [H,hd]; s0: [B,H,hd,hd].

    Returns (y [B,S,H,hd], s_final [B,H,hd,hd] f32)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown rwkv6_scan impl {impl!r}")
    if impl == "ref":
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    use_kernel = impl == "kernel" or r.device.type != "cpu"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        if s0 is None:
            b, _, h, hd = r.shape
            s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                             device=r.device)
        return Rwkv6ScanFn.apply(r, k, v, w, u, s0, use_kernel)
    fn = _kernel.rwkv6_scan if use_kernel else rwkv6_scan_ref
    return fn(r, k, v, w, u, s0)


__all__ = ["Rwkv6ScanFn", "rwkv6_scan", "rwkv6_scan_bwd_ref",
           "rwkv6_scan_ref"]
