"""Public entry point for the Mamba selective scan, the twin of
``repro/kernels/selective_scan/ops.py``.

``impl`` selects the execution path:

  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"kernel"`` — always the CUDA kernel (a CPU tensor raises);
  * ``"ref"``    — always the plain PyTorch version (only ever asked for
                   explicitly, e.g. by parity runs), differentiated by
                   autograd when a gradient is wanted.

When grad mode is on and an input requires a gradient, ``"auto"`` and
``"kernel"`` go through :class:`SelectiveScanFn`: its backward is the
backward kernel on CUDA tensors and that kernel's plain version (by
formula) on CPU tensors.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.selective_scan import kernel as _kernel
from repro_torch.kernels.selective_scan import kernel_bwd as _kernel_bwd
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)

_IMPLS = ("auto", "kernel", "ref")


class SelectiveScanFn(torch.autograd.Function):
    """The selective scan with a hand-written backward: (x, delta, a, b,
    c, d, h0) -> (y, h_final), saving the seven inputs; the backward takes
    the cotangents of both outputs (zeros for an unused one).
    ``use_kernel`` picks the CUDA kernels (forward and backward), else
    their plain versions.  The forward kernel runs in its checkpoint mode
    and the backward kernel reruns h from the checkpoints it saves (h
    before every 32nd step)."""

    @staticmethod
    def forward(ctx, x, delta, a, b, c, d, h0, use_kernel):
        ckpt = None
        if use_kernel:
            y, h_final, ckpt = _kernel.selective_scan(x, delta, a, b, c, d,
                                                      h0, ckpt=True)
        else:
            y, h_final = selective_scan_ref(x, delta, a, b, c, d, h0)
        ctx.save_for_backward(x, delta, a, b, c, d, h0, ckpt)
        ctx.use_kernel = use_kernel
        return y, h_final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_final):
        *inputs, ckpt = ctx.saved_tensors
        if ctx.use_kernel:
            grads = _kernel_bwd.selective_scan_bwd(
                *inputs, dy.contiguous(), dh_final.contiguous(), ckpt=ckpt)
        else:
            grads = selective_scan_bwd_ref(*inputs, dy.contiguous(),
                                           dh_final.contiguous())
        return (*grads, None)


def selective_scan(x, delta, a, b, c, d, h0=None, *, impl: str = "auto"):
    """x/delta: [B,S,D]; a: [D,N]; b/c: [B,S,N]; d: [D]; h0: [B,D,N].

    Returns (y [B,S,D] in x's dtype, h_final [B,D,N] f32)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown selective_scan impl {impl!r}")
    if impl == "ref":
        return selective_scan_ref(x, delta, a, b, c, d, h0)
    use_kernel = impl == "kernel" or x.device.type != "cpu"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, delta, a, b, c, d, h0)):
        if h0 is None:
            h0 = torch.zeros((x.shape[0], x.shape[2], a.shape[1]),
                             dtype=torch.float32, device=x.device)
        return SelectiveScanFn.apply(x, delta, a, b, c, d, h0, use_kernel)
    fn = _kernel.selective_scan if use_kernel else selective_scan_ref
    return fn(x, delta, a, b, c, d, h0)


__all__ = ["SelectiveScanFn", "selective_scan", "selective_scan_bwd_ref",
           "selective_scan_ref"]
