"""Hopper RWKV-6 WKV backward: the PyTorch wrapper of the hand-written CUDA
kernel in ``csrc/rwkv6_scan_bwd.cu``.

It computes the gradient of ``kernel.py::rwkv6_scan`` (the port of the
TPU kernel ``repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan``, which has
no backward there: JAX differentiates the ``lax.scan`` of
``repro/models/rwkv.py``; see the note at the top of the CUDA source for
the design and what bounds it on an H100).  One call launches one
thread-block cluster of ``cluster_size(hd)`` blocks per (batch row, head),
whose cross-block sums meet in distributed shared memory, then the sum of
du's per-batch-row shares.  The library is built with ``nvcc`` for
``sm_90a`` at first launch (``kernels/build.py``).  The wrapper checks
device, dtype, shape and contiguity, and that a cluster of the head
width's kernel fits the card, allocates the gradients and the scratch of
``scratch_shapes`` (the chunk checkpoints of S and the batch rows' shares
of du), launches on PyTorch's current stream and raises if a launch was
refused.  It never falls back to the plain version: a CPU tensor is an
error here (``ops.Rwkv6ScanFn`` routes CPU tensors to
``ref.rwkv6_scan_bwd_ref``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library
from repro_torch.kernels.rwkv6_scan.kernel import _GRID_Y_MAX, HEAD_DIMS

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan_bwd.cu"
CHUNK = 32              # steps between the source's checkpoints of S
# key rows a block of a cluster owns, by head width (the source's Pick)
ROWS = {16: 16, 32: 16, 64: 32, 128: 16}

# Backward calls made through rwkv6_scan_bwd since import or since a caller
# last set it to 0 (one per call; each call runs the source's two
# kernels).
launches = 0


def cluster_size(hd: int) -> int:
    """Blocks in the cluster of one (batch row, head): one per ``ROWS[hd]``
    key rows (2 at hd 64, 8 at hd 128)."""
    return hd // ROWS[hd]


def scratch_shapes(b: int, s: int, h: int, hd: int) -> dict:
    """The scratch one call allocates, by name: S at the start of every
    32-step chunk, and each batch row's share of du."""
    return {"ckpt": (b, h, -(-s // CHUNK), hd, hd), "du_part": (b, h, hd)}


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("rwkv6_scan_bwd", [SOURCE])
    fn = built.lib.rwkv6_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fits = built.lib.rwkv6_scan_bwd_max_clusters
    fits.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fits.restype = ctypes.c_int
    err = built.lib.rwkv6_scan_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


@functools.lru_cache(maxsize=None)
def max_clusters(hd: int) -> int:
    """How many clusters of the head width's kernel the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = build().lib
    out = ctypes.c_int(0)
    rc = lib.rwkv6_scan_bwd_max_clusters(hd, ctypes.byref(out))
    if rc != 0:
        msg = lib.rwkv6_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"rwkv6_scan_bwd: occupancy query for head_dim "
                           f"{hd} failed: {msg} (cudaError {rc})")
    return out.value


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan_bwd kernel: {msg}")


def rwkv6_scan_bwd(r, k, v, w, u, s0, dy, ds_final=None):
    """r/k/v/w/dy: [B,S,H,hd]; u: [H,hd]; s0/ds_final: [B,H,hd,hd] (zeros
    when ds_final is None); all float32, contiguous CUDA tensors.

    Returns (dr, dk, dv, dw [B,S,H,hd], du [H,hd], ds0 [B,H,hd,hd]), f32."""
    global launches
    _check(r.device.type == "cuda",
           f"r lies on {r.device}; the kernel runs on CUDA tensors only")
    _check(r.dim() == 4, f"r must be [B,S,H,hd], got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    if ds_final is None:
        ds_final = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                               device=r.device)
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "s0": s0, "dy": dy,
               "ds_final": ds_final}
    shapes = {"k": r.shape, "v": r.shape, "w": r.shape, "dy": r.shape,
              "u": (h, hd), "s0": (b, h, hd, hd), "ds_final": (b, h, hd, hd)}
    for name, t in tensors.items():
        _check(t.device == r.device, f"{name} on {t.device}, r on {r.device}")
        _check(t.dtype == torch.float32,
               f"{name} dtype {t.dtype}: the backward takes float32 only "
               f"(the model casts r, k, v to float32 before the scan)")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        if name in shapes:
            _check(tuple(t.shape) == tuple(shapes[name]),
                   f"{name} {tuple(t.shape)} != {tuple(shapes[name])}")
    _check(hd in HEAD_DIMS, f"head_dim {hd} not one of {HEAD_DIMS}")
    _check(b <= _GRID_Y_MAX and h <= _GRID_Y_MAX,
           f"batch {b} or heads {h} too large for the grid")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    if b == 0 or h == 0 or s == 0:
        return (dr.zero_(), dk.zero_(), dv.zero_(), dw.zero_(), du,
                ds_final.clone())
    _check(max_clusters(hd) > 0,
           f"head_dim {hd}: a cluster of {cluster_size(hd)} blocks does not "
           f"fit this card")
    # the states are read 16 bytes at a time
    s0, ds_final = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (s0, ds_final))
    ds0 = torch.empty_like(s0)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=r.device)
               for name, shape in scratch_shapes(b, s, h, hd).items()}
    lib = build().lib
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), dy.data_ptr(), ds_final.data_ptr(),
        scratch["ckpt"].data_ptr(), scratch["du_part"].data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), b, s, h, hd, stream)
    if rc != 0:
        msg = lib.rwkv6_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return dr, dk, dv, dw, du, ds0
