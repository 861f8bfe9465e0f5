"""Hopper paged attention (ragged mixed prefill+decode): the PyTorch wrapper
of the hand-written CUDA kernel in ``csrc/paged_attention.cu``.

It replaces the TPU kernel ``repro/kernels/paged_attention/kernel.py::
paged_attention_mixed`` and computes the same function (see the note at the
top of the CUDA source for what bounds it on an H100 and how its design
answers that).  The library is built with ``nvcc`` for ``sm_90a`` at first
launch (``kernels/build.py``).  The wrapper checks device, dtype, shape,
contiguity and limits, allocates the output, launches on PyTorch's current
stream and raises if the launch was refused.  It never falls back to the
plain version: a CPU tensor is an error here (``ops.py`` routes CPU tensors
to ``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
MAX_HEAD_DIM = 256
_ROWS_PER_BLOCK = 16            # the f32 kernel's kRows (bf16 takes 64)
_GRID_YZ_MAX = 65535

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Kernel launches made through paged_attention_mixed (and paged_attention)
# since import or since a caller last set it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("paged_attention", [SOURCE])
    fn = built.lib.paged_attention_mixed
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = built.lib.paged_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention_mixed(q, k_pages, v_pages, block_tables, q_positions, *,
                          scale=None, k_scales=None, v_scales=None):
    """q: [B,Q,H,hd] f32/bf16; pages: [P,page,KV,hd] f32/bf16/int8;
    block_tables: [B,PPS] int32; q_positions: [B,Q] int32;
    k_scales/v_scales: [P,page,KV] f32 (required for int8 pages).
    Returns [B,Q,H,hd] in q's dtype.

    Every table entry must be a valid page index (the kernel reads pages
    up to the one holding each block's largest position)."""
    global launches
    _check(q.device.type == "cuda",
           f"q lies on {q.device}; the kernel runs on CUDA tensors only")
    tensors = {"k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "q_positions": q_positions}
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_attention kernel: pass both k_scales and "
                         "v_scales or neither")
    if k_scales is not None:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in {"q": q, **tensors}.items():
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dim() == 4, f"q must be [B,Q,H,hd], got {tuple(q.shape)}")
    b, qn, h, hd = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape[-1] == hd,
           f"k_pages must be [P,page,KV,{hd}], got {tuple(k_pages.shape)}")
    _check(v_pages.shape == k_pages.shape,
           f"v_pages {tuple(v_pages.shape)} != k_pages "
           f"{tuple(k_pages.shape)}")
    n_pages, page, kv, _ = k_pages.shape
    _check(q.dtype in _Q_DTYPES, f"q dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
           f"page dtypes {k_pages.dtype}/{v_pages.dtype} "
           f"(float32, bfloat16 or int8, both the same)")
    if k_pages.dtype == torch.int8:
        _check(k_scales is not None, "int8 pages need k_scales/v_scales")
    if k_scales is not None:
        for name in ("k_scales", "v_scales"):
            s = tensors[name]
            _check(s.dtype == torch.float32 and
                   tuple(s.shape) == (n_pages, page, kv),
                   f"{name} must be float32 [{n_pages},{page},{kv}], got "
                   f"{s.dtype} {tuple(s.shape)}")
    _check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
           and block_tables.shape[0] == b,
           f"block_tables must be int32 [{b},PPS], got "
           f"{block_tables.dtype} {tuple(block_tables.shape)}")
    _check(q_positions.dtype == torch.int32 and
           tuple(q_positions.shape) == (b, qn),
           f"q_positions must be int32 [{b},{qn}], got "
           f"{q_positions.dtype} {tuple(q_positions.shape)}")
    _check(kv >= 1 and h % kv == 0, f"heads {h} not a multiple of kv {kv}")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    _check(page >= 1, f"page size {page}")
    _check(kv <= _GRID_YZ_MAX and
           -(-qn * (h // kv) // _ROWS_PER_BLOCK) <= _GRID_YZ_MAX,
           "too many kv heads or query rows per lane for the grid")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    out = torch.empty_like(q)
    if b == 0 or qn == 0:
        return out
    lib = build().lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_attention_mixed(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        b, qn, h, kv, hd, page, block_tables.shape[1], float(scale),
        _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype], stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None, k_scales=None, v_scales=None):
    """Single-token decode: q [B,H,hd], lengths [B] — the q_len=1 case."""
    qpos = (lengths - 1)[:, None].to(torch.int32).contiguous()
    out = paged_attention_mixed(q[:, None].contiguous(), k_pages, v_pages,
                                block_tables, qpos, scale=scale,
                                k_scales=k_scales, v_scales=v_scales)
    return out[:, 0]
