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
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,dtype,tol", [
    (1, 300, 32, 64, torch.float32, 1e-4),
    (8, 1, 32, 64, torch.float32, 1e-4),
    (2, 33, 4, 32, torch.float32, 1e-4),
    (1, 64, 4, 64, torch.bfloat16, 1e-2),
])
def test_wkv_kernel_matches_plain_version(cuda_device, b, s, h, hd, dtype,
                                          tol):
    from repro_torch.kernels.rwkv6_scan import kernel as wkernel
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    rng = np.random.default_rng(s * 10 + hd)
    r, k, v = (rng.standard_normal((b, s, h, hd)) * 0.5 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, s, h, hd))))
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.1
    seq = [torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
           for a in (r, k, v, w)]
    u, s0 = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
             for a in (u, s0))
    before = wkernel.launches
    y, sf = rwkv6_scan(*seq, u, s0, impl="kernel")
    torch.cuda.synchronize()
    assert wkernel.launches == before + 1
    yr, sr = rwkv6_scan(*seq, u, s0, impl="ref")
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(sf.cpu().numpy(), sr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
