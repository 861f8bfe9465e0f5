"""The port's Mamba selective scan against the JAX package on the same numpy
inputs: the plain version of the scan kernel against the JAX oracle
(``selective_scan_ref``) and the Pallas kernel (interpret mode) on the
shapes of tests/test_kernels.py at rtol = atol = 1e-4 in f32, a ragged S
against the oracle alone (the Pallas kernel needs chunk | S, the port does
not), the chunk-boundary continuity property, bf16 x, and the kernel
route's refusal of CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import selective_scan as jax_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref
from repro_torch.kernels.selective_scan import kernel as tkernel
from repro_torch.kernels.selective_scan.ops import selective_scan

TOL = 1e-4


def _inputs(seed, b, s, d, n):
    """x/delta/a/b/c/d/h0 as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)) * 0.5
    dt = np.abs(rng.standard_normal((b, s, d))) * 0.1
    a = -np.abs(rng.standard_normal((d, n))) - 0.1
    bb = rng.standard_normal((b, s, n)) * 0.5
    c = rng.standard_normal((b, s, n)) * 0.5
    dd = rng.standard_normal((d,))
    h0 = rng.standard_normal((b, d, n)) * 0.1
    return [v.astype(np.float32) for v in (x, dt, a, bb, c, dd, h0)]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("b,s,d,n,block_d,chunk", [
    (2, 64, 128, 16, 64, 32),
    (1, 256, 256, 8, 128, 64),
    (1, 96, 64, 4, 64, 96),
])
def test_plain_version_matches_jax_ref_and_pallas(b, s, d, n, block_d,
                                                  chunk):
    args = _inputs(s * 10 + n, b, s, d, n)
    y, hf = selective_scan(*map(torch.from_numpy, args), impl="ref")
    ya, hfa = selective_scan(*map(torch.from_numpy, args))  # CPU auto: ref
    np.testing.assert_array_equal(_np(y), _np(ya))
    np.testing.assert_array_equal(_np(hf), _np(hfa))
    jargs = list(map(jnp.asarray, args))
    for yj, hj in (jax_ref(*jargs),
                   jax_scan(*jargs, block_d=block_d, chunk=chunk)):
        np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_np(hf), np.asarray(hj), rtol=TOL,
                                   atol=TOL)


def test_ragged_sequence_and_channels_match_jax_ref():
    """S = 37 and D = 40 fit no Pallas chunk or block: the port's scan
    takes them as they are, and so does the JAX oracle."""
    args = _inputs(11, 2, 37, 40, 16)
    y, hf = selective_scan(*map(torch.from_numpy, args))
    yj, hj = jax_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(hf), np.asarray(hj), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="divisible"):
        jax_scan(*map(jnp.asarray, args), block_d=40, chunk=16)


def test_chunk_boundary_state_continuity():
    """The scan over S equals two halves chained through the state, from a
    zero state (``h0=None``) as test_kernels.py runs it."""
    x, dt, a, bb, c, dd, _ = map(torch.from_numpy, _inputs(12, 1, 64, 32, 8))
    y, hf = selective_scan(x, dt, a, bb, c, dd)
    y1, h1 = selective_scan(x[:, :32], dt[:, :32], a, bb[:, :32],
                            c[:, :32], dd)
    y2, h2 = selective_scan(x[:, 32:], dt[:, 32:], a, bb[:, 32:],
                            c[:, 32:], dd, h1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(h2), _np(hf), rtol=TOL, atol=TOL)
    yj, hj = jax_scan(*map(jnp.asarray, _inputs(12, 1, 64, 32, 8)[:6]),
                      chunk=16)
    np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(hf), np.asarray(hj), rtol=TOL, atol=TOL)


def test_bf16_x_gives_bf16_y_and_f32_state():
    """bf16 x (as the bf16 model feeds the scan): y leaves in bf16, formed
    in f32 from the same bf16 values as the Pallas kernel, and rounded
    once; the state stays f32."""
    x, dt, a, bb, c, dd, h0 = _inputs(13, 2, 32, 64, 16)
    xb = torch.from_numpy(x).bfloat16()
    rest = list(map(torch.from_numpy, (dt, a, bb, c, dd, h0)))
    y, hf = selective_scan(xb, *rest)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    yj, hj = jax_scan(jnp.asarray(x, jnp.bfloat16),
                      *map(jnp.asarray, (dt, a, bb, c, dd, h0)), chunk=16,
                      block_d=64)
    # one bf16 ulp is 2^-8 of |y|
    np.testing.assert_allclose(_np(y), np.asarray(yj, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(hf), np.asarray(hj), rtol=TOL, atol=TOL)


def test_kernel_route_refuses_cpu_tensors():
    args = list(map(torch.from_numpy, _inputs(14, 1, 4, 8, 4)))
    before = tkernel.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        selective_scan(*args, impl="kernel")
    with pytest.raises(ValueError, match="unknown selective_scan impl"):
        selective_scan(*args, impl="pallas")
    assert tkernel.launches == before
    assert tkernel.build.cache_info().currsize == 0
