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
