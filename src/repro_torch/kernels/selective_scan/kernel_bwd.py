"""Hopper Mamba selective-scan backward: the PyTorch wrapper of the
hand-written CUDA kernels in ``csrc/selective_scan_bwd.cu``.

It computes the gradient of ``kernel.py::selective_scan`` (the port of the
TPU kernel ``repro/kernels/selective_scan/kernel.py::selective_scan``,
which has no backward there: JAX differentiates the associative scan of
``repro/models/ssm.py``; see the note at the top of the CUDA source for
the design and what bounds it on an H100).  One call launches the walk
(blocks of 64 channels, 16 for d_state > 16, each storing its plane of
dB / dC partials), then three passes that sum the planes and the batch
rows' dA and dD shares in a fixed order.  It reruns h from the
forward's checkpoints (``kernel.selective_scan(..., ckpt=True)``, which
``ops.SelectiveScanFn`` saves); a caller that has none passes
``ckpt=None`` and the wrapper first runs the forward kernel in its
checkpoint mode, which it does not count as a forward launch.  The library
is built with ``nvcc`` for ``sm_90a`` at first launch
(``kernels/build.py``).  The wrapper checks device, dtype, shape and
contiguity, and that the walk's block fits the card, allocates the
gradients and the scratch of ``scratch_shapes``, launches on PyTorch's
current stream and raises if a launch was refused.  It never falls back to
the plain version: a CPU tensor is an error here (``ops.SelectiveScanFn``
routes CPU tensors to ``ref.selective_scan_bwd_ref``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, load_library
from repro_torch.kernels.selective_scan import kernel as _fwd
from repro_torch.kernels.selective_scan.kernel import (_DTYPES, _GRID_Y_MAX,
                                                       MAX_STATE, ckpt_shape)

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan_bwd.cu"
THREADS = 256           # a block's threads, 4 elements each (kThreads, kPer)
XSTEPS = 4              # steps whose dx / ddelta shares meet at once (kXSteps)

# Backward calls made through selective_scan_bwd since import or since a
# caller last set it to 0 (one per call; each call runs the walk and three
# sums, after the forward's checkpoint mode when no ckpt is given).
launches = 0


@functools.lru_cache(maxsize=None)
def build() -> BuiltLibrary:
    """Compile (or reuse) and load the kernel's library, binding its C
    interface."""
    built = load_library("selective_scan_bwd", [SOURCE])
    fn = built.lib.selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = built.lib.selective_scan_bwd_occupancy
    occ.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    err = built.lib.selective_scan_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan_bwd kernel: {msg}")


def channels_per_block(n: int) -> int:
    """The channels a block of the source holds for d_state n: 64 for
    n <= 16, 16 for n <= 64 (each thread 2 channels x 2 states)."""
    return THREADS // ((16 if n <= 16 else MAX_STATE) // 4)


def scratch_shapes(b: int, s: int, d: int, n: int) -> dict:
    """The scratch one call allocates, by name: dB / dC by channel block
    (one plane each), each batch row's share of dA, and of dD by batch
    row and step offset in ``XSTEPS``."""
    blocks = -(-d // channels_per_block(n))
    return {"bc_part": (blocks, 2, b, s, n), "a_part": (b, d, n),
            "d_part": (b, XSTEPS, d)}


@functools.lru_cache(maxsize=None)
def blocks_per_sm(n: int, dtype: torch.dtype) -> int:
    """How many of the walk's blocks an SM holds for d_state n and x dtype
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = build().lib
    blocks = ctypes.c_int(0)
    rc = lib.selective_scan_bwd_occupancy(n, _DTYPES[dtype],
                                          ctypes.byref(blocks))
    if rc != 0:
        msg = lib.selective_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"selective_scan_bwd: occupancy query for "
                           f"d_state {n} failed: {msg} (cudaError {rc})")
    return blocks.value


def selective_scan_bwd(x, delta, a, b, c, d, h0, dy, dh_final=None,
                       ckpt=None):
    """x/dy: [B,S,D], both float32 or both bfloat16; delta: [B,S,D],
    a: [D,N], b/c: [B,S,N], d: [D], h0/dh_final: [B,D,N] (zeros when
    dh_final is None), all float32; ckpt: the forward's checkpoints of h,
    ``kernel.ckpt_shape(B, S, D, N)`` float32 (made here with the forward
    kernel's checkpoint mode when None); all contiguous CUDA tensors.

    Returns (dx [B,S,D] in x's dtype, ddelta [B,S,D], da [D,N],
    db/dc [B,S,N], dd [D], dh0 [B,D,N]), the rest float32."""
    global launches
    _check(x.device.type == "cuda",
           f"x lies on {x.device}; the kernel runs on CUDA tensors only")
    _check(x.dim() == 3, f"x must be [B,S,D], got {tuple(x.shape)}")
    bsz, s, dim = x.shape
    _check(a.dim() == 2 and a.shape[0] == dim,
           f"a must be [{dim},N], got {tuple(a.shape)}")
    n = a.shape[1]
    _check(1 <= n <= MAX_STATE, f"d_state {n} not in [1, {MAX_STATE}]")
    if dh_final is None:
        dh_final = torch.zeros((bsz, dim, n), dtype=torch.float32,
                               device=x.device)
    tensors = {"x": x, "delta": delta, "a": a, "b": b, "c": c, "d": d,
               "h0": h0, "dy": dy, "dh_final": dh_final}
    shapes = {"delta": (bsz, s, dim), "a": (dim, n), "b": (bsz, s, n),
              "c": (bsz, s, n), "d": (dim,), "h0": (bsz, dim, n),
              "dh_final": (bsz, dim, n)}
    if ckpt is not None:
        tensors["ckpt"] = ckpt
        shapes["ckpt"] = ckpt_shape(bsz, s, dim, n)
    for name, t in tensors.items():
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, shape in shapes.items():
        t = tensors[name]
        _check(t.dtype == torch.float32 and tuple(t.shape) == shape,
               f"{name} must be float32 {list(shape)}, got {t.dtype} "
               f"{tuple(t.shape)}")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32 or bfloat16)")
    _check(dy.dtype == x.dtype and dy.shape == x.shape,
           f"dy must be {x.dtype} {list(x.shape)}, got {dy.dtype} "
           f"{tuple(dy.shape)}")
    _check(bsz <= _GRID_Y_MAX, f"batch {bsz} too large for the grid")
    dx = torch.empty_like(x)
    ddelta = torch.empty_like(delta)
    da, dd = torch.zeros_like(a), torch.zeros_like(d)
    dbc = torch.zeros((2, bsz, s, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or dim == 0 or s == 0:
        return (dx.zero_(), ddelta.zero_(), da, dbc[0], dbc[1], dd,
                dh_final.clone())
    _check(blocks_per_sm(n, x.dtype) > 0,
           f"d_state {n}, x {x.dtype}: the walk's block does not fit this "
           f"card")
    if ckpt is None:
        # the forward kernel's checkpoint mode, not a forward launch
        _, _, ckpt = _fwd.scan(x, delta, a, b, c, d, h0, ckpt=True)
    dh0 = torch.empty_like(h0)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
               for name, shape in scratch_shapes(bsz, s, dim, n).items()}
    lib = build().lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.selective_scan_bwd(
        x.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), dy.data_ptr(), dh_final.data_ptr(),
        ckpt.data_ptr(), scratch["bc_part"].data_ptr(),
        scratch["a_part"].data_ptr(), scratch["d_part"].data_ptr(),
        dx.data_ptr(), ddelta.data_ptr(), da.data_ptr(), dbc.data_ptr(),
        dd.data_ptr(), dh0.data_ptr(), bsz, s, dim, n, _DTYPES[x.dtype],
        stream)
    if rc != 0:
        msg = lib.selective_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return dx, ddelta, da, dbc[0], dbc[1], dd, dh0
