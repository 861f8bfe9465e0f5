"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one (a CUDA kernel has no
CPU mode).  The file imports nothing of JAX, so it runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as tkernel
from repro_torch.kernels.paged_attention.ops import paged_attention_mixed
from repro_torch.models.attention import _quantize_kv


def _mixed_inputs(seed, b, qn, h, kv, hd, page, pps, npages):
    """Ragged rows: lane 0 a run of consecutive positions, other lanes
    random positions, a pad-row tail at position 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, qn, h, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kv, hd)).astype(np.float32)
    bt = rng.integers(0, npages, (b, pps)).astype(np.int32)
    qpos = rng.integers(0, pps * page, (b, qn)).astype(np.int32)
    qpos[0] = np.arange(qn) + rng.integers(0, pps * page - qn + 1)
    qpos[:, qn - qn // 2:] = 0
    return [torch.from_numpy(a) for a in (q, kp, vp, bt, qpos)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_int8,h,kv,hd,tol", [
    (torch.bfloat16, False, 32, 32, 80, 2e-2),
    (torch.bfloat16, True, 32, 32, 80, 2e-2),
    (torch.float32, False, 32, 32, 80, 2e-3),
    (torch.bfloat16, False, 32, 8, 128, 2e-2),
    (torch.bfloat16, True, 32, 8, 128, 2e-2),    # GQA with int8 pages
    (torch.bfloat16, False, 4, 2, 72, 2e-2),     # hd padded to 80
    (torch.bfloat16, True, 4, 4, 50, 2e-2),      # hd % 8 != 0: no cp.async
])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, kv_int8, h,
                                           kv, hd, tol):
    b, qn, page, pps, npages = 6, 5, 16, 12, 80
    q, kp, vp, bt, qpos = _mixed_inputs(7, b, qn, h, kv, hd, page, pps,
                                        npages)
    kw = {}
    if kv_int8:
        kp, ks = _quantize_kv(kp)
        vp, vs = _quantize_kv(vp)
        kw = dict(k_scales=ks.float().to(cuda_device),
                  v_scales=vs.float().to(cuda_device))
    pdt = torch.int8 if kv_int8 else dtype
    args = [q.to(cuda_device, dtype), kp.to(cuda_device, pdt),
            vp.to(cuda_device, pdt), bt.to(cuda_device),
            qpos.to(cuda_device)]
    before = tkernel.launches
    out = paged_attention_mixed(*args, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert tkernel.launches == before + 1
    ref = paged_attention_mixed(*args, impl="ref", **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


def _lane_major_inputs(seed, qn, h, kv, hd, page=16, pps=24, npages=120):
    """Three lanes as the serving runtime lays them out: a decode lane (one
    row, then pad rows at position 0), a prefill chunk of ``qn`` rows, and
    a speculative lane of 4 rows; every pad row reads its own lane's table."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, qn, h, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kv, hd)).astype(np.float32)
    bt = rng.permutation(npages)[:3 * pps].reshape(3, pps).astype(np.int32)
    qpos = np.zeros((3, qn), np.int32)
    qpos[0, 0] = 300
    qpos[1] = 100 + np.arange(qn)
    qpos[2, :4] = 200 + np.arange(4)
    return [torch.from_numpy(a) for a in (q, kp, vp, bt, qpos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_int8,qn,h,kv,hd,tol", [
    (torch.bfloat16, False, 64, 32, 32, 80, 2e-2),
    (torch.bfloat16, False, 80, 32, 32, 80, 2e-2),   # a chunk past 64 rows
    (torch.bfloat16, True, 64, 32, 32, 80, 2e-2),
    (torch.bfloat16, True, 24, 32, 8, 128, 2e-2),    # GQA: 96 rows a lane
    (torch.float32, False, 80, 32, 32, 80, 2e-3),
])
def test_cuda_kernel_lane_major_matches_plain_version(cuda_device, dtype,
                                                      kv_int8, qn, h, kv, hd,
                                                      tol):
    q, kp, vp, bt, qpos = _lane_major_inputs(qn + hd, qn, h, kv, hd)
    kw = {}
    if kv_int8:
        kp, ks = _quantize_kv(kp)
        vp, vs = _quantize_kv(vp)
        kw = dict(k_scales=ks.float().to(cuda_device),
                  v_scales=vs.float().to(cuda_device))
    pdt = torch.int8 if kv_int8 else dtype
    args = [q.to(cuda_device, dtype), kp.to(cuda_device, pdt),
            vp.to(cuda_device, pdt), bt.to(cuda_device),
            qpos.to(cuda_device)]
    before = tkernel.launches
    out = paged_attention_mixed(*args, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert tkernel.launches == before + 1
    ref = paged_attention_mixed(*args, impl="ref", **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    q, kp, vp, bt, qpos = _mixed_inputs(8, 2, 3, 4, 2, 80, 16, 4, 8)
    args = [t.to(cuda_device) for t in (q, kp, vp, bt, qpos)]
    with pytest.raises(ValueError, match="int32"):
        tkernel.paged_attention_mixed(args[0], args[1], args[2],
                                      args[3].long(), args[4])
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.paged_attention_mixed(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="scales"):
        tkernel.paged_attention_mixed(args[0], args[1].to(torch.int8),
                                      args[2].to(torch.int8), *args[3:])


# ------------------------------------------------------------------ flash
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap,dtype,tol", [
    (1, 200, 200, 32, 32, 80, True, 0, None, torch.bfloat16, 2e-2),
    (1, 200, 200, 32, 32, 80, True, 0, None, torch.float32, 2e-3),
    (2, 64, 192, 4, 1, 64, True, 0, None, torch.float32, 2e-3),
    (1, 130, 130, 4, 4, 64, False, 0, None, torch.float32, 2e-3),
    (1, 300, 300, 8, 2, 128, True, 128, 50.0, torch.bfloat16, 2e-2),
    (1, 70, 70, 2, 2, 256, True, 0, None, torch.float32, 2e-3),
    (1, 200, 200, 4, 4, 72, True, 0, None, torch.bfloat16, 2e-2),
    (2, 100, 150, 4, 2, 50, True, 0, None, torch.bfloat16, 2e-2),
    (1, 100, 40, 4, 4, 64, True, 0, None, torch.bfloat16, 2e-2),  # zero rows
    (1, 150, 150, 4, 4, 256, True, 0, None, torch.bfloat16, 2e-2),
])
def test_flash_kernel_matches_plain_version(cuda_device, b, s, t, h, kv, hd,
                                            causal, window, cap, dtype, tol):
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    rng = np.random.default_rng(s + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    kw = dict(causal=causal, window=window, softcap=cap)
    before = fkernel.launches
    out = flash_attention(q, k, v, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert fkernel.launches == before + 1
    ref = flash_attention(q, k, v, impl="ref", **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


# ------------------------------------------------------------------- wkv
def _wkv_inputs(seed, b, s, h, hd):
    """r/k/v/w (w in (0.45, 0.95)), u and a random initial state, f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)) * 0.5 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, s, h, hd))))
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)) for a in (r, k, v, w, u,
                                                             s0)]


def _check_wkv(seq, u, s0, tol):
    from repro_torch.kernels.rwkv6_scan import kernel as wkernel
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    before = wkernel.launches
    y, sf = rwkv6_scan(*seq, u, s0, impl="kernel")
    torch.cuda.synchronize()
    assert wkernel.launches == before + 1
    assert y.dtype == seq[0].dtype and sf.dtype == torch.float32
    yr, sr = rwkv6_scan(*seq, u, s0, impl="ref")
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(sf.cpu().numpy(), sr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,dtype,tol", [
    (1, 300, 32, 64, torch.float32, 1e-4),
    (8, 1, 32, 64, torch.float32, 1e-4),
    (2, 33, 4, 32, torch.float32, 1e-4),
    (1, 64, 4, 64, torch.bfloat16, 1e-2),
    # the column-tile geometry's edges: every head width, S off the
    # 64-step chunk and the 16-step pair of groups, B = 3 x H = 5 blocks
    (1, 1000, 32, 64, torch.float32, 1e-4),
    (3, 33, 5, 16, torch.float32, 1e-4),
    (3, 1000, 5, 32, torch.float32, 1e-4),
    (3, 33, 5, 128, torch.float32, 1e-4),
    (1, 7, 2, 128, torch.float32, 1e-4),
    (3, 33, 5, 16, torch.bfloat16, 1e-2),
    (2, 70, 3, 128, torch.bfloat16, 1e-2),
    # calls of fewer than 8 steps at hd <= 64 take the column-per-thread
    # kernel
    (4, 5, 3, 16, torch.float32, 1e-4),
    (4, 3, 3, 32, torch.bfloat16, 1e-2),
])
def test_wkv_kernel_matches_plain_version(cuda_device, b, s, h, hd, dtype,
                                          tol):
    r, k, v, w, u, s0 = _wkv_inputs(s * 10 + hd, b, s, h, hd)
    seq = [t.to(cuda_device, dtype) for t in (r, k, v, w)]
    _check_wkv(seq, u.to(cuda_device), s0.to(cuda_device), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_wkv_kernel_misaligned_inputs(cuda_device, dtype, tol):
    """Contiguous views that start off a 16-byte boundary are staged
    element by element, to the same result."""
    b, s, h, hd = 2, 45, 3, 64
    r, k, v, w, u, s0 = _wkv_inputs(11, b, s, h, hd)
    seq = []
    for t in (r, k, v, w):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t.to(dtype))
        assert view.data_ptr() % 16 != 0
        seq.append(view)
    _check_wkv(seq, u.to(cuda_device), s0.to(cuda_device), tol)


# ------------------------------------------------------------ selective scan
def _scan_inputs(seed, b, s, d, n, x_dtype, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, s, d)) * 0.5,
              np.abs(rng.standard_normal((b, s, d))) * 0.1,
              -np.abs(rng.standard_normal((d, n))) - 0.1,
              rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((d,)),
              rng.standard_normal((b, d, n)) * 0.1)
    out = [torch.from_numpy(a.astype(np.float32)).to(device)
           for a in arrays]
    out[0] = out[0].to(x_dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype,tol", [
    (1, 300, 8192, 16, torch.float32, 1e-4),
    (8, 1, 8192, 16, torch.float32, 1e-4),
    (2, 37, 100, 8, torch.float32, 1e-4),     # ragged S, D off the block
    (1, 70, 256, 40, torch.float32, 1e-4),    # the wide-state build
    (1, 130, 512, 16, torch.bfloat16, 1e-2),  # y rounded to bf16
    # the channel tile's edges: D off the tile, every state count's
    # padding, one step
    (1, 70, 8200, 16, torch.bfloat16, 1e-2),
    (2, 45, 8200, 16, torch.float32, 1e-4),
    (2, 50, 96, 1, torch.float32, 1e-4),
    (2, 50, 104, 13, torch.float32, 1e-4),
    (1, 40, 72, 64, torch.float32, 1e-4),
    (3, 1, 8200, 64, torch.bfloat16, 1e-2),
    (3, 1, 100, 13, torch.float32, 1e-4),
])
def test_scan_kernel_matches_plain_version(cuda_device, b, s, d, n, dtype,
                                           tol):
    from repro_torch.kernels.selective_scan import kernel as skernel
    from repro_torch.kernels.selective_scan.ops import selective_scan
    args = _scan_inputs(s * 10 + n, b, s, d, n, dtype, cuda_device)
    before = skernel.launches
    y, hf = selective_scan(*args, impl="kernel")
    torch.cuda.synchronize()
    assert skernel.launches == before + 1
    assert y.dtype == dtype and hf.dtype == torch.float32
    yr, hr = selective_scan(*args, impl="ref")
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(hf.cpu().numpy(), hr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_scan_kernel_exponent_range(cuda_device, dtype, tol):
    """delta * A spans the whole range that reaches 2^x, from 0 down past
    -126 (log2 units), where the special-function unit's 2^x flushes to
    0 and the state is only the new input, while the plain version's exp
    passes through denormals."""
    from repro_torch.kernels.selective_scan.ops import selective_scan
    b, s, d, n = 2, 96, 160, 16
    x, dt, a, bm, cm, dd, h0 = _scan_inputs(17, b, s, d, n, dtype,
                                            cuda_device)
    rng = np.random.default_rng(18)
    # A from -0.01 to -1000; delta from 0 to 1
    a = -torch.from_numpy(np.exp(rng.uniform(np.log(0.01), np.log(1000.0),
                                             (d, n))).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0, 1, (b, s, d)).astype(np.float32))
    a, dt = a.to(cuda_device), dt.to(cuda_device)
    e = (dt[..., None] * a * 1.4426950408889634).flatten()
    assert float(e.min()) < -200 and float(e.max()) > -0.05
    assert float((e < -126).float().mean()) > 0.1
    y, hf = selective_scan(x, dt, a, bm, cm, dd, h0, impl="kernel")
    torch.cuda.synchronize()
    yr, hr = selective_scan(x, dt, a, bm, cm, dd, h0, impl="ref")
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(hf.cpu().numpy(), hr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_scan_kernel_chained_halves_and_zero_state(cuda_device):
    """Two halves chained through the state give one call's y and state;
    ``h0=None`` starts from zeros."""
    from repro_torch.kernels.selective_scan.ops import selective_scan
    x, dt, a, bm, cm, dd, _ = _scan_inputs(5, 2, 96, 300, 16,
                                           torch.float32, cuda_device)
    y, hf = selective_scan(x, dt, a, bm, cm, dd, impl="kernel")
    parts = [t.contiguous() for t in (x[:, :40], dt[:, :40], bm[:, :40],
                                      cm[:, :40], x[:, 40:], dt[:, 40:],
                                      bm[:, 40:], cm[:, 40:])]
    y1, h1 = selective_scan(parts[0], parts[1], a, parts[2], parts[3], dd,
                            impl="kernel")
    y2, h2 = selective_scan(parts[4], parts[5], a, parts[6], parts[7], dd,
                            h1, impl="kernel")
    torch.cuda.synchronize()
    np.testing.assert_allclose(torch.cat([y1, y2], 1).cpu().numpy(),
                               y.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h2.cpu().numpy(), hf.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    yr, hr = selective_scan(x, dt, a, bm, cm, dd, impl="ref")
    np.testing.assert_allclose(y.cpu().numpy(), yr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_scan_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.selective_scan import kernel as skernel
    x, dt, a, bm, cm, dd, h0 = _scan_inputs(6, 1, 8, 64, 16, torch.float32,
                                            cuda_device)
    with pytest.raises(ValueError, match="float32"):
        skernel.selective_scan(x, dt.bfloat16(), a, bm, cm, dd, h0)
    with pytest.raises(ValueError, match="contiguous"):
        skernel.selective_scan(x, dt, a, bm.transpose(1, 2).contiguous()
                               .transpose(1, 2), cm, dd, h0)
    wide = torch.zeros((64, 65), device=cuda_device)
    with pytest.raises(ValueError, match="d_state"):
        skernel.selective_scan(x, dt, wide, bm, cm, dd)
