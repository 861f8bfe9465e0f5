"""Hopper Mamba selective scan: the PyTorch wrapper of the hand-written CUDA
kernel in ``csrc/selective_scan.cu``.

It replaces the TPU kernel ``repro/kernels/selective_scan/kernel.py::
selective_scan`` and computes the same function for any sequence length
and any channel count (see the note at the top of the CUDA source for what
bounds it on an H100 and how its design answers that).  The library is
built with ``nvcc`` for ``sm_90a`` at first launch (``kernels/build.py``).
The wrapper checks device, dtype, shape, contiguity and limits, allocates
the outputs, launches on PyTorch's current stream and raises if the launch
was refused.  It never falls back to the plain version: a CPU tensor is an
error here (``ops.py`` routes CPU tensors to ``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 64                      # the widest d_state the kernel holds
_GRID_Y_MAX = 65535

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches made through selective_scan since import or since a
# caller last set it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("selective_scan", [SOURCE])
    fn = built.lib.selective_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = built.lib.selective_scan_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan kernel: {msg}")


def selective_scan(x, delta, a, b, c, d, h0=None):
    """x: [B,S,D] float32 or bfloat16; delta: [B,S,D], a: [D,N],
    b/c: [B,S,N], d: [D], h0: [B,D,N] (zeros when None), all float32; all
    contiguous.

    Returns (y [B,S,D] in x's dtype, h_final [B,D,N] f32)."""
    global launches
    _check(x.device.type == "cuda",
           f"x lies on {x.device}; the kernel runs on CUDA tensors only")
    _check(x.dim() == 3, f"x must be [B,S,D], got {tuple(x.shape)}")
    bsz, s, dim = x.shape
    _check(a.dim() == 2 and a.shape[0] == dim,
           f"a must be [{dim},N], got {tuple(a.shape)}")
    n = a.shape[1]
    _check(1 <= n <= MAX_STATE, f"d_state {n} not in [1, {MAX_STATE}]")
    if h0 is None:
        h0 = torch.zeros((bsz, dim, n), dtype=torch.float32, device=x.device)
    tensors = {"x": x, "delta": delta, "a": a, "b": b, "c": c, "d": d,
               "h0": h0}
    shapes = {"delta": (bsz, s, dim), "a": (dim, n), "b": (bsz, s, n),
              "c": (bsz, s, n), "d": (dim,), "h0": (bsz, dim, n)}
    for name, t in tensors.items():
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, shape in shapes.items():
        t = tensors[name]
        _check(t.dtype == torch.float32 and tuple(t.shape) == shape,
               f"{name} must be float32 {list(shape)}, got {t.dtype} "
               f"{tuple(t.shape)}")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32 or bfloat16)")
    _check(bsz <= _GRID_Y_MAX, f"batch {bsz} too large for the grid")
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    if bsz == 0 or dim == 0:
        return y, h_final
    lib = build().lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.selective_scan(x.data_ptr(), delta.data_ptr(), a.data_ptr(),
                            b.data_ptr(), c.data_ptr(), d.data_ptr(),
                            h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                            bsz, s, dim, n, _DTYPES[x.dtype], stream)
    if rc != 0:
        msg = lib.selective_scan_error_string(rc).decode()
        raise RuntimeError(f"selective_scan kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return y, h_final
