"""Hopper prefill attention: the PyTorch wrapper of the hand-written CUDA
kernel in ``csrc/flash_attention.cu``.

It replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention`` and computes the same function (see the note at the top
of the CUDA source for what bounds it on an H100 and how its design answers
that).  The library is built with ``nvcc`` for ``sm_90a`` at first launch
(``kernels/build.py``).  The wrapper checks device, dtype, shape, contiguity
and limits, allocates the output, launches on PyTorch's current stream and
raises if the launch was refused.  It never falls back to the plain
version: a CPU tensor is an error here (``ops.py`` routes CPU tensors to
``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_GRID_YZ_MAX = 65535

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches made through flash_attention since import or since a
# caller last set it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("flash_attention", [SOURCE])
    fn = built.lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = built.lib.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd], all float32 or all bfloat16,
    contiguous.  Returns [B,S,H,hd] in q's dtype (queries end-aligned:
    pos_q = i + T - S)."""
    global launches
    _check(q.device.type == "cuda",
           f"q lies on {q.device}; the kernel runs on CUDA tensors only")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.dim() == 4, f"{name} must be 4-d, got {tuple(t.shape)}")
    b, s, h, hd = q.shape
    t_len, kv = k.shape[1], k.shape[2]
    _check(tuple(k.shape) == (b, t_len, kv, hd),
           f"k must be [{b},T,KV,{hd}], got {tuple(k.shape)}")
    _check(v.shape == k.shape, f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (all float32 or all "
           f"bfloat16)")
    _check(kv >= 1 and h % kv == 0, f"heads {h} not a multiple of kv {kv}")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    _check(h <= _GRID_YZ_MAX and b <= _GRID_YZ_MAX,
           "too many heads or batch rows for the grid")
    _check(window >= 0, f"window {window} must be >= 0")
    _check(softcap is None or softcap > 0, f"softcap {softcap} must be > 0")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    if t_len == 0:
        return out.zero_()
    lib = build().lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t_len, h, kv, hd, float(scale), int(bool(causal)), int(window),
        float(softcap) if softcap is not None else -1.0, _DTYPES[q.dtype],
        stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return out
