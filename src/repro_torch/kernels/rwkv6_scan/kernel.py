"""Hopper RWKV-6 WKV scan: the PyTorch wrapper of the hand-written CUDA
kernel in ``csrc/rwkv6_scan.cu``.

It replaces the TPU kernel ``repro/kernels/rwkv6_scan/kernel.py::
rwkv6_scan`` and computes the same function, for any sequence length (see
the note at the top of the CUDA source for what bounds it on an H100 and
how its design answers that).  The library is built with ``nvcc`` for
``sm_90a`` at first launch (``kernels/build.py``).  The wrapper checks
device, dtype, shape, contiguity and limits, allocates the outputs,
launches on PyTorch's current stream and raises if the launch was refused.
It never falls back to the plain version: a CPU tensor is an error here
(``ops.py`` routes CPU tensors to ``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
HEAD_DIMS = (16, 32, 64, 128)       # the kernel's compiled head widths
_GRID_Y_MAX = 65535

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches made through rwkv6_scan since import or since a caller
# last set it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("rwkv6_scan", [SOURCE])
    fn = built.lib.rwkv6_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = built.lib.rwkv6_scan_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan kernel: {msg}")


def rwkv6_scan(r, k, v, w, u, s0=None):
    """r/k/v/w: [B,S,H,hd], all float32 or all bfloat16; u: [H,hd] f32;
    s0: [B,H,hd,hd] f32 (zeros when None); all contiguous.

    Returns (y [B,S,H,hd] in r's dtype, s_final [B,H,hd,hd] f32)."""
    global launches
    _check(r.device.type == "cuda",
           f"r lies on {r.device}; the kernel runs on CUDA tensors only")
    _check(r.dim() == 4, f"r must be [B,S,H,hd], got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device)
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "s0": s0}
    for name, t in tensors.items():
        _check(t.device == r.device, f"{name} on {t.device}, r on {r.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name in ("k", "v", "w"):
        t = tensors[name]
        _check(t.shape == r.shape, f"{name} {tuple(t.shape)} != r "
                                   f"{tuple(r.shape)}")
        _check(t.dtype == r.dtype, f"{name} dtype {t.dtype} != r {r.dtype}")
    _check(r.dtype in _DTYPES, f"dtype {r.dtype} (float32 or bfloat16)")
    _check(u.dtype == torch.float32 and tuple(u.shape) == (h, hd),
           f"u must be float32 [{h},{hd}], got {u.dtype} {tuple(u.shape)}")
    _check(s0.dtype == torch.float32 and tuple(s0.shape) == (b, h, hd, hd),
           f"s0 must be float32 [{b},{h},{hd},{hd}], got {s0.dtype} "
           f"{tuple(s0.shape)}")
    _check(hd in HEAD_DIMS, f"head_dim {hd} not one of {HEAD_DIMS}")
    _check(b <= _GRID_Y_MAX, f"batch {b} too large for the grid")
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    if b == 0 or h == 0:
        return y, s_final
    lib = build().lib
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                        y.data_ptr(), s_final.data_ptr(), b, s, h, hd,
                        _DTYPES[r.dtype], stream)
    if rc != 0:
        msg = lib.rwkv6_scan_error_string(rc).decode()
        raise RuntimeError(f"rwkv6_scan kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return y, s_final
