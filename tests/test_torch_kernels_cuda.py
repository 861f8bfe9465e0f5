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
    # this slice's geometries: Phi-3-vision's hd 96, MLA's 128 + 64 (and
    # the reduced 32 + 16 in f32), the encoder's and cross-attention's
    # non-causal calls with T off the 64-key tile
    (1, 200, 200, 4, 4, 96, True, 0, None, torch.bfloat16, 2e-2),
    (1, 150, 150, 4, 4, 192, True, 0, None, torch.bfloat16, 2e-2),
    (1, 100, 100, 4, 4, 48, True, 0, None, torch.float32, 2e-3),
    (1, 777, 777, 4, 4, 64, False, 0, None, torch.bfloat16, 2e-2),
    (2, 1, 777, 4, 4, 64, False, 0, None, torch.bfloat16, 2e-2),
    (2, 1, 100, 4, 4, 64, False, 0, None, torch.float32, 2e-3),
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


# the backward's cases: the forward's option set at sizes off every tile
# (wgmma: 128-key and 128-query blocks of 64-row tiles, 64-key blocks above
# hd 128; mma.sync: 64-row tiles; CUDA cores: 64 rows up to hd 128, 32
# above), GQA, T != S, rows no key reaches; and each design (bf16 hd 50 and
# unaligned views take mma.sync, f32 the CUDA cores, the rest wgmma with
# the descriptors of every 16-column box count from 1 (hd 16) to 12)
FLASH_BWD_CASES = [
    (1, 200, 200, 4, 4, 80, True, 0, None, torch.bfloat16, 2e-2),
    (1, 200, 200, 4, 4, 80, True, 0, None, torch.float32, 2e-3),
    (2, 130, 130, 4, 4, 64, True, 0, None, torch.float32, 2e-3),
    (1, 300, 300, 8, 2, 128, True, 128, 50.0, torch.bfloat16, 2e-2),
    (1, 300, 300, 8, 2, 128, True, 128, 50.0, torch.float32, 2e-3),
    (2, 100, 150, 4, 2, 50, False, 0, None, torch.bfloat16, 2e-2),
    (1, 100, 40, 4, 4, 64, True, 0, None, torch.float32, 2e-3),   # zero rows
    (1, 150, 150, 4, 4, 192, True, 0, None, torch.bfloat16, 2e-2),
    (1, 70, 70, 2, 2, 256, True, 0, None, torch.float32, 2e-3),
    (1, 100, 100, 4, 4, 48, True, 0, None, torch.float32, 2e-3),
    (2, 1, 100, 4, 4, 64, False, 0, None, torch.float32, 2e-3),
    (1, 96, 96, 6, 2, 96, False, 0, 30.0, torch.bfloat16, 2e-2),
    (1, 1000, 1000, 4, 4, 80, True, 0, None, torch.bfloat16, 2e-2),
    (2, 200, 200, 4, 4, 16, True, 0, None, torch.bfloat16, 2e-2),
    (1, 300, 300, 8, 4, 72, True, 64, None, torch.bfloat16, 2e-2),
    (1, 150, 230, 4, 4, 112, False, 0, None, torch.bfloat16, 2e-2),
    (1, 256, 256, 8, 2, 128, True, 0, None, torch.bfloat16, 2e-2),
    (1, 130, 130, 4, 4, 50, True, 0, None, torch.bfloat16, 2e-2),
    (1, 1000, 1000, 2, 2, 192, True, 0, None, torch.bfloat16, 2e-2),
]


def _flash_bwd_inputs(seed, b, s, t, h, kv, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for shape in
            ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd), (b, s, h, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap,dtype,tol",
                         FLASH_BWD_CASES)
def test_flash_lse_matches_plain_version(cuda_device, b, s, t, h, kv, hd,
                                         causal, window, cap, dtype, tol):
    """The forward's log-sum-exp (+inf where no key counts) is the plain
    version's, and asking for it leaves the output as it was."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v, _ = _flash_bwd_inputs(s + hd, b, s, t, h, kv, hd, dtype,
                                   cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = fkernel.flash_attention(q, k, v, return_lse=True, **kw)
    plain_out = fkernel.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    live = torch.isfinite(lse_ref)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_ref[live].cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap,dtype,tol",
                         FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain_version(cuda_device, b, s, t, h, kv,
                                                hd, causal, window, cap,
                                                dtype, tol):
    """dq, dk, dv of the backward kernel against ``flash_attention_bwd_ref``
    on the same inputs, within ``tol`` of each gradient's own max |value|
    (2e-3 f32, 2e-2 bf16), and through ``FlashAttentionFn`` by autograd."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import kernel_bwd as bkernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    q, k, v, do = _flash_bwd_inputs(s + t + hd, b, s, t, h, kv, hd, dtype,
                                    cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    o = o.contiguous()
    before = bkernel.launches
    grads = bkernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert bkernel.launches == before + 1
    refs = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        scale = float(r.float().abs().max())
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
    # the autograd route launches the forward and the backward kernel; its
    # backward reads the forward kernel's own output and log-sum-exp
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qa, ka, va, impl="kernel", **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert bkernel.launches == before + 2
    o_k, lse_k = fkernel.flash_attention(q, k, v, return_lse=True, **kw)
    refs = flash_attention_bwd_ref(q, k, v, o_k, lse_k, do, **kw)
    for name, x, r in zip("qkv", (qa, ka, va), refs):
        scale = float(r.float().abs().max())
        err = float((x.grad.float() - r.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd,kv,dtype,want", [
    (1000, 80, 4, torch.bfloat16, "wgmma"),
    (300, 128, 2, torch.bfloat16, "wgmma"),
    (1000, 192, 4, torch.bfloat16, "wgmma"),
    (130, 50, 4, torch.bfloat16, "mma"),
    (200, 64, 4, torch.float32, "cuda_cores"),
])
def test_flash_bwd_kernel_repeats_its_bits(cuda_device, s, hd, kv, dtype,
                                           want):
    """No atomics: two calls on the same inputs give the same bits, in
    each design."""
    from repro_torch.kernels.flash_attention import kernel_bwd as bkernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v, do = _flash_bwd_inputs(s + hd, 1, s, s, 4, kv, hd, dtype,
                                    cuda_device)
    assert bkernel.design(hd, dtype, bkernel.aligned(q, k, v, do)) == want
    o, lse = flash_attention_ref(q, k, v, return_lse=True)
    o = o.contiguous()
    first = bkernel.flash_attention_bwd(q, k, v, o, lse, do)
    again = bkernel.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, g, g2 in zip("qkv", first, again):
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_flash_bwd_kernel_unaligned_views(cuda_device):
    """bf16 hd 64 on views 2 bytes off a 16-byte boundary: no TMA map can
    take them, so the source runs its mma.sync design, with the same
    result as the plain version."""
    from repro_torch.kernels.flash_attention import kernel_bwd as bkernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    shape = (1, 200, 4, 64)
    tensors = _flash_bwd_inputs(3, *shape[:2], shape[1], 4, 4, 64,
                                torch.bfloat16, cuda_device)
    q, k, v, do = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape)
                   for t in tensors)
    assert q.is_contiguous() and not bkernel.aligned(q, k, v, do)
    assert bkernel.design(64, torch.bfloat16, False) == "mma"
    o, lse = flash_attention_ref(q, k, v, return_lse=True)
    o = o.contiguous()
    grads = bkernel.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, g, r in zip("qkv", grads,
                          flash_attention_bwd_ref(q, k, v, o, lse, do)):
        scale = float(r.float().abs().max())
        assert float((g.float() - r.float()).abs().max()) <= 2e-2 * scale, \
            name


@pytest.mark.cuda
def test_flash_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.flash_attention import kernel_bwd as bkernel
    q, k, v, do = _flash_bwd_inputs(1, 1, 8, 8, 2, 2, 16, torch.float32,
                                    cuda_device)
    lse = torch.zeros((1, 2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="lse"):
        bkernel.flash_attention_bwd(q, k, v, q, lse.bfloat16(), do)
    with pytest.raises(ValueError, match="contiguous"):
        bkernel.flash_attention_bwd(q, k, v, q, lse, do.transpose(1, 2)
                                    .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        bkernel.flash_attention_bwd(q.cpu(), k.cpu(), v.cpu(), q.cpu(),
                                    lse.cpu(), do.cpu())


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


# --------------------------------------------------------- scan backwards
def _hold(grads, refs, names, tol):
    """Each gradient finite and within ``tol`` of its plain version's own
    max |value|."""
    for name, g, r in zip(names, grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(r.float().abs().max())
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,state,underflow", [
    (2, 300, 32, 64, False, False),    # the training shape, S cut
    (2, 100, 8, 64, True, False),      # ragged S, s0 and ds_final
    (3, 45, 5, 16, True, False),
    (3, 70, 5, 32, True, False),
    (3, 70, 5, 128, True, False),
    (2, 80, 4, 64, True, True),        # w = 0 (w_log = 6) on some channels
    (1, 1, 2, 64, True, False),        # one step, 31 pad steps
    (2, 7, 3, 64, True, False),
    (2, 33, 3, 64, True, False),       # one step into a second chunk
    (1, 1000, 2, 128, True, False),    # a cluster of 8, ragged S
    (4, 333, 40, 64, True, False),     # more clusters than fit at once
])
def test_wkv_bwd_kernel_matches_plain_version(cuda_device, b, s, h, hd,
                                              state, underflow):
    """dr, dk, dv, dw, du and ds0 of the backward kernel against
    ``rwkv6_scan_bwd_ref``, within 2e-3 of each gradient's own max
    |value|, and through ``Rwkv6ScanFn`` by autograd."""
    from repro_torch.kernels.rwkv6_scan import kernel as wkernel
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as bkernel
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref
    r, k, v, w, u, s0 = (t.to(cuda_device) for t in
                         _wkv_inputs(s + hd, b, s, h, hd))
    if underflow:
        w[..., ::3] = 0.0
    if not state:
        s0.zero_()
    rng = np.random.default_rng(s + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).to(cuda_device)
    dsf = torch.from_numpy((rng.standard_normal((b, h, hd, hd)) * 0.1)
                           .astype(np.float32)).to(cuda_device)
    if not state:
        dsf.zero_()
    args = (r, k, v, w, u, s0, dy, dsf)
    before = bkernel.launches
    grads = bkernel.rwkv6_scan_bwd(*args)
    torch.cuda.synchronize()
    assert bkernel.launches == before + 1
    refs = rwkv6_scan_bwd_ref(*args)
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    _hold(grads, refs, names, 2e-3)
    # the autograd route: the forward and the backward kernel
    xs = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    fwd_before = wkernel.launches
    y, sf = rwkv6_scan(*xs, impl="kernel")
    ((y * dy).sum() + (sf * dsf).sum()).backward()
    torch.cuda.synchronize()
    assert wkernel.launches == fwd_before + 1
    assert bkernel.launches == before + 2
    _hold([x.grad for x in xs], refs, names, 2e-3)


@pytest.mark.cuda
def test_wkv_bwd_kernel_gives_the_same_bits(cuda_device):
    """Two calls give the same bits: the cross-block sums meet in a fixed
    order, with no atomics."""
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as bkernel
    b, s, h, hd = 2, 300, 32, 64
    r, k, v, w, u, s0 = (t.to(cuda_device) for t in
                         _wkv_inputs(5, b, s, h, hd))
    rng = np.random.default_rng(6)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).to(cuda_device)
    dsf = torch.from_numpy((rng.standard_normal((b, h, hd, hd)) * 0.1)
                           .astype(np.float32)).to(cuda_device)
    first = bkernel.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dsf)
    again = bkernel.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dsf)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_wkv_bwd_kernel_misaligned_inputs(cuda_device):
    """Contiguous views that start off a 16-byte boundary are staged
    element by element, to the same gradients."""
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as bkernel
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref
    b, s, h, hd = 2, 45, 3, 64
    r, k, v, w, u, s0 = _wkv_inputs(12, b, s, h, hd)
    dy = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (b, s, h, hd)).astype(np.float32))
    views = []
    for t in (r, k, v, w, dy):
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        views.append(view)
    r, k, v, w, dy = views
    args = (r, k, v, w, u.to(cuda_device), s0.to(cuda_device), dy,
            torch.zeros_like(s0.to(cuda_device)))
    grads = bkernel.rwkv6_scan_bwd(*args)
    torch.cuda.synchronize()
    _hold(grads, rwkv6_scan_bwd_ref(*args),
          ("dr", "dk", "dv", "dw", "du", "ds0"), 2e-3)


@pytest.mark.cuda
def test_wkv_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as bkernel
    args = [t.to(cuda_device) for t in _wkv_inputs(2, 1, 8, 2, 64)]
    dy = torch.zeros_like(args[0])
    with pytest.raises(ValueError, match="float32"):
        bkernel.rwkv6_scan_bwd(*[a.bfloat16() if i < 4 else a
                                 for i, a in enumerate(args)], dy.bfloat16())
    narrow = [t.to(cuda_device) for t in _wkv_inputs(2, 1, 8, 2, 48)]
    with pytest.raises(ValueError, match="head_dim"):
        bkernel.rwkv6_scan_bwd(*narrow, torch.zeros_like(narrow[0]))
    with pytest.raises(ValueError, match="contiguous"):
        bkernel.rwkv6_scan_bwd(*args, dy.transpose(1, 2).contiguous()
                               .transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        bkernel.rwkv6_scan_bwd(*[a.cpu() for a in args], dy.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype,state,wide", [
    (2, 300, 8192, 16, torch.bfloat16, False, False),  # the training shape
    (1, 200, 8192, 16, torch.float32, False, False),
    (1, 100, 2048, 16, torch.float32, False, False),   # ragged S
    (1, 70, 8200, 16, torch.bfloat16, False, False),   # D off the tile
    (2, 45, 1000, 1, torch.float32, True, False),
    (2, 50, 1001, 13, torch.float32, True, False),
    (2, 40, 1024, 64, torch.float32, True, False),
    (2, 96, 1024, 16, torch.float32, True, True),      # e^{delta A} = 0
    (2, 1, 1024, 16, torch.float32, True, False),      # one step, 31 pad
    (2, 7, 1024, 16, torch.bfloat16, True, False),     # 1-step groups
    (2, 33, 1024, 64, torch.float32, True, False),     # a step into chunk 2
    (2, 1000, 1024, 16, torch.float32, True, False),   # ragged S, long
])
def test_scan_bwd_kernel_matches_plain_version(cuda_device, b, s, d, n,
                                               dtype, state, wide):
    """dx, ddelta, dA, dB, dC, dD and dh0 of the backward kernel against
    ``selective_scan_bwd_ref``, within 2e-3 (x f32) or 2e-2 (x bf16) of
    each gradient's own max |value|, and through ``SelectiveScanFn`` by
    autograd."""
    from repro_torch.kernels.selective_scan import kernel as skernel
    from repro_torch.kernels.selective_scan import kernel_bwd as bkernel
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    x, dt, a, bm, cm, dd, h0 = _scan_inputs(s + n, b, s, d, n, dtype,
                                            cuda_device)
    rng = np.random.default_rng(s + n + 1)
    if wide:
        dt = torch.from_numpy(rng.uniform(0, 1, (b, s, d)).astype(
            np.float32)).to(cuda_device)
        a = -torch.from_numpy(np.exp(rng.uniform(
            np.log(0.01), np.log(1000.0), (d, n))).astype(np.float32)).to(
            cuda_device)
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(
        np.float32)).to(cuda_device, dtype)
    dhf = torch.from_numpy((rng.standard_normal((b, d, n)) * 0.1).astype(
        np.float32)).to(cuda_device)
    if not state:
        h0.zero_()
        dhf.zero_()
    args = (x, dt, a, bm, cm, dd, h0, dy, dhf)
    before = bkernel.launches
    grads = bkernel.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    assert bkernel.launches == before + 1
    refs = selective_scan_bwd_ref(*args)
    names = ("dx", "ddelta", "da", "db", "dc", "dd", "dh0")
    _hold(grads, refs, names, tol)
    xs = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, dd, h0)]
    fwd_before = skernel.launches
    y, hf = selective_scan(*xs, impl="kernel")
    ((y.float() * dy.float()).sum() + (hf * dhf).sum()).backward()
    torch.cuda.synchronize()
    assert skernel.launches == fwd_before + 1
    assert bkernel.launches == before + 2
    # autograd's cotangent of y is dy rounded to y's dtype: the same dy
    _hold([t.grad for t in xs], refs, names, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype", [
    (2, 300, 8192, 16, torch.bfloat16),   # the training shape, S cut
    (2, 70, 8200, 64, torch.float32),     # D off the tile and the cluster
])
def test_scan_bwd_kernel_gives_the_same_bits_twice(cuda_device, b, s, d, n,
                                                   dtype):
    """No atomics: two calls give the same bits, with the forward's
    checkpoints given or made by the wrapper, and the direct call leaves
    the forward's launch count alone."""
    from repro_torch.kernels.selective_scan import kernel as skernel
    from repro_torch.kernels.selective_scan import kernel_bwd as bkernel
    x, dt, a, bm, cm, dd, h0 = _scan_inputs(s + 3, b, s, d, n, dtype,
                                            cuda_device)
    rng = np.random.default_rng(s + 4)
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(
        np.float32)).to(cuda_device, dtype)
    dhf = torch.from_numpy((rng.standard_normal((b, d, n)) * 0.1).astype(
        np.float32)).to(cuda_device)
    args = (x, dt, a, bm, cm, dd, h0, dy, dhf)
    fwd_before = skernel.launches
    first = bkernel.selective_scan_bwd(*args)
    assert skernel.launches == fwd_before
    _, _, ckpt = skernel.selective_scan(x, dt, a, bm, cm, dd, h0, ckpt=True)
    second = bkernel.selective_scan_bwd(*args, ckpt=ckpt)
    third = bkernel.selective_scan_bwd(*args, ckpt=ckpt)
    torch.cuda.synchronize()
    for p, q, r in zip(first, second, third):
        assert torch.equal(p, q) and torch.equal(q, r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype", [
    (2, 1, 1024, 16, torch.float32),
    (2, 7, 1024, 16, torch.bfloat16),     # the 1-step-group instance
    (2, 33, 1024, 64, torch.float32),
    (1, 1000, 8200, 13, torch.float32),   # ragged S, D and N
    (2, 300, 8192, 16, torch.bfloat16),
])
def test_scan_kernel_checkpoints_match_plain_state(cuda_device, b, s, d, n,
                                                   dtype):
    """The forward's checkpoint mode: h before every 32nd step (h0 first)
    against the plain version's state at each chunk start, within 2e-3 of
    its max |value|, with y and h_final as without the mode."""
    from repro_torch.kernels.selective_scan import kernel as skernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    x, dt, a, bm, cm, dd, h0 = _scan_inputs(s + 5, b, s, d, n, dtype,
                                            cuda_device)
    y, hf, ckpt = skernel.selective_scan(x, dt, a, bm, cm, dd, h0,
                                         ckpt=True)
    y0, hf0 = skernel.selective_scan(x, dt, a, bm, cm, dd, h0)
    torch.cuda.synchronize()
    step = skernel.CKPT_STEPS
    assert ckpt.shape == skernel.ckpt_shape(b, s, d, n) == (
        b, -(-s // step), d, n)
    assert torch.equal(y, y0) and torch.equal(hf, hf0)
    h = h0
    for k in range(ckpt.shape[1]):
        want = h
        scale = float(want.abs().max())
        err = float((ckpt[:, k] - want).abs().max())
        assert err <= 2e-3 * scale, (k, err, scale)
        sl = slice(step * k, step * (k + 1))
        _, h = selective_scan_ref(x[:, sl].contiguous(), dt[:, sl]
                                  .contiguous(), a, bm[:, sl].contiguous(),
                                  cm[:, sl].contiguous(), dd, h)


@pytest.mark.cuda
def test_scan_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.selective_scan import kernel_bwd as bkernel
    args = _scan_inputs(6, 1, 8, 64, 16, torch.float32, cuda_device)
    dy = torch.zeros_like(args[0])
    with pytest.raises(ValueError, match="dy must be"):
        bkernel.selective_scan_bwd(*args, dy.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        bkernel.selective_scan_bwd(args[0], args[1].bfloat16(), *args[2:],
                                   dy)
    wide = torch.zeros((64, 65), device=cuda_device)
    with pytest.raises(ValueError, match="d_state"):
        bkernel.selective_scan_bwd(args[0], args[1], wide, *args[3:], dy)
    with pytest.raises(ValueError, match="CUDA"):
        bkernel.selective_scan_bwd(*[t.cpu() for t in args], dy.cpu())
    ckpt = torch.zeros((1, 1, 64, 16), device=cuda_device)
    with pytest.raises(ValueError, match="ckpt must be float32"):
        bkernel.selective_scan_bwd(*args, dy, ckpt=ckpt[:, :, :32])
    with pytest.raises(ValueError, match="ckpt must be float32"):
        bkernel.selective_scan_bwd(*args, dy, ckpt=ckpt.double())
    with pytest.raises(ValueError, match="ckpt must be contiguous"):
        bkernel.selective_scan_bwd(*args, dy, ckpt=ckpt.expand(1, 1, 64, 16)
                                   .transpose(2, 3).contiguous()
                                   .transpose(2, 3))
