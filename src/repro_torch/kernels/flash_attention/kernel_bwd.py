"""Hopper flash-attention backward: the PyTorch wrapper of the hand-written
CUDA kernel in ``csrc/flash_attention_bwd.cu``.

It computes the gradient of ``kernel.py::flash_attention`` (the port of
the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``, which has no backward there; see the note at the top of
the CUDA source for its designs and what bounds it on an H100).  The
source picks one of three hand-written designs by shape; :func:`design`
states that choice in Python.  The
library is built with ``nvcc`` for ``sm_90a`` at first launch
(``kernels/build.py``).  The wrapper checks device, dtype, shape and
contiguity, allocates the gradients and the f32 ``D = rowsum(dO * O)``
scratch, launches on PyTorch's current stream and raises if a launch was
refused.  It never falls back to the plain version: a CPU tensor is an
error here (``ops.FlashAttentionFn`` routes CPU tensors to
``ref.flash_attention_bwd_ref``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library
from repro_torch.kernels.flash_attention.kernel import (_DTYPES,
                                                        _GRID_YZ_MAX,
                                                        MAX_HEAD_DIM)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
_TILE_MIN = 32                  # the smallest row tile of the CUDA source
WGMMA_MAX_HEAD_DIM = 192        # the widest head of the wgmma design (MLA's)
MMA_MAX_HEAD_DIM = 128          # the widest head of the mma.sync design
_WGMMA_TILES = (64, 128)        # (key, query) rows a wgmma block takes

# Backward calls made through flash_attention_bwd since import or since a
# caller last set it to 0 (one per call; each call runs the source's three
# kernels).
launches = 0


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("flash_attention_bwd", [SOURCE])
    fn = built.lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = built.lib.flash_attention_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def design(hd: int, dtype: torch.dtype, aligned: bool) -> str:
    """The design the CUDA source's ``dispatch`` runs for a call: "wgmma"
    (TMA and wgmma) for bf16 with ``hd`` a multiple of 8 up to 192 and
    16-byte-aligned q, k, v, dO (``aligned``), which a TMA map can stride;
    "mma" (mma.sync) for the other bf16 widths up to 128; "cuda_cores"
    for float32 at every width and bf16 beyond those."""
    if dtype == torch.bfloat16:
        if aligned and hd % 8 == 0 and hd <= WGMMA_MAX_HEAD_DIM:
            return "wgmma"
        if hd <= MMA_MAX_HEAD_DIM:
            return "mma"
    return "cuda_cores"


def aligned(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_bwd kernel: {msg}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q/o/do: [B,S,H,hd]; k/v: [B,T,KV,hd], all float32 or all bfloat16;
    lse: f32 [B,H,S], the forward's log-sum-exp.  All contiguous CUDA
    tensors.  Returns (dq, dk, dv) in the inputs' dtype."""
    global launches
    _check(q.device.type == "cuda",
           f"q lies on {q.device}; the kernel runs on CUDA tensors only")
    tensors = (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
               ("do", do))
    for name, t in tensors:
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dim() == 4 and k.dim() == 4,
           f"q/k must be 4-d, got {tuple(q.shape)} / {tuple(k.shape)}")
    b, s, h, hd = q.shape
    t_len, kv = k.shape[1], k.shape[2]
    _check(tuple(k.shape) == (b, t_len, kv, hd),
           f"k must be [{b},T,KV,{hd}], got {tuple(k.shape)}")
    _check(v.shape == k.shape, f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    _check(o.shape == q.shape and do.shape == q.shape,
           f"o {tuple(o.shape)} and do {tuple(do.shape)} must be "
           f"{tuple(q.shape)}")
    _check(tuple(lse.shape) == (b, h, s) and lse.dtype == torch.float32,
           f"lse must be float32 [{b},{h},{s}], got {lse.dtype} "
           f"{tuple(lse.shape)}")
    _check(q.dtype in _DTYPES and all(
        t.dtype == q.dtype for t in (k, v, o, do)),
        f"dtypes {[t.dtype for _, t in tensors]} (q, k, v, o, do all "
        f"float32 or all bfloat16)")
    _check(kv >= 1 and h % kv == 0, f"heads {h} not a multiple of kv {kv}")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    _check(h <= _GRID_YZ_MAX and b <= _GRID_YZ_MAX
           and -(-max(s, t_len) // _TILE_MIN) < 2 ** 31,
           "too many heads, batch rows or tiles for the grid")
    if design(hd, q.dtype, aligned(q, k, v, do)) == "wgmma":
        # the tiles run down the grid's y dimension, the heads across x
        _check(-(-t_len // _WGMMA_TILES[0]) <= _GRID_YZ_MAX
               and -(-s // _WGMMA_TILES[1]) <= _GRID_YZ_MAX
               and h * b < 2 ** 31, "too many tiles for the wgmma grid")
    _check(window >= 0, f"window {window} must be >= 0")
    _check(softcap is None or softcap > 0, f"softcap {softcap} must be > 0")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if b == 0 or s == 0 or t_len == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = build().lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, t_len, h, kv, hd, float(scale),
        int(bool(causal)), int(window),
        float(softcap) if softcap is not None else -1.0, _DTYPES[q.dtype],
        stream)
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return dq, dk, dv
