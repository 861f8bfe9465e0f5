"""The port's paged attention against the JAX package's: the plain PyTorch
version held to the JAX oracle and to the Pallas kernel (interpret mode),
on the same numpy inputs, plus the kernel's properties on the plain
version.  Tolerances are those of tests/test_kernels.py: 2e-3 in f32, 0.05
for int8 pages against fp.  The CUDA kernel itself is compared with the
plain version on the card in tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import (
    paged_attention as jax_paged_attention,
    paged_attention_mixed as jax_paged_attention_mixed,
)
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_mixed)
from repro_torch.models.attention import _quantize_kv

TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool(rng, npages, page, kv, hd):
    kp = rng.standard_normal((npages, page, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kv, hd)).astype(np.float32)
    return kp, vp


def _mixed_inputs(seed, b, qn, h, kv, hd, page, pps, npages):
    """Ragged rows as in test_kernels.py: lane 0 a prefill-style run of
    consecutive positions, other lanes random positions, pad-row tail at
    position 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, qn, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = rng.integers(0, npages, (b, pps)).astype(np.int32)
    qpos = rng.integers(0, pps * page, (b, qn)).astype(np.int32)
    qpos[0] = np.arange(qn) + rng.integers(0, pps * page - qn + 1)
    qpos[:, qn - qn // 2:] = 0
    return q, kp, vp, bt, qpos


def _quant_np(p):
    """int8 pages + f32 scales through the port's quantizer."""
    qv, s = _quantize_kv(_t(p))
    return qv.numpy(), s.float().numpy()


def _jax(fn, *args, **kw):
    args = [jnp.asarray(a) for a in args]
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return np.asarray(fn(*args, **kw), np.float32)


def _torch(fn, *args, **kw):
    args = [_t(a) for a in args]
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return fn(*args, **kw).float().numpy()


# ------------------------------------------------------------ shape sweeps
@pytest.mark.parametrize("b,h,kv,hd,page,pps,npages", [
    (2, 4, 2, 64, 128, 4, 16),
    (4, 8, 8, 128, 128, 2, 8),
    (1, 4, 1, 64, 128, 8, 32),
    (3, 6, 2, 64, 256, 2, 6),
    (3, 4, 4, 80, 16, 8, 24),          # StableLM's head_dim and page size
])
def test_decode_matches_jax(b, h, kv, hd, page, pps, npages):
    rng = np.random.default_rng(b * 1000 + hd)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = rng.integers(0, npages, (b, pps)).astype(np.int32)
    lens = rng.integers(1, pps * page, (b,)).astype(np.int32)
    ours = _torch(paged_attention, q, kp, vp, bt, lens, impl="ref")
    for impl in ("ref", "kernel"):
        theirs = _jax(jax_paged_attention, q, kp, vp, bt, lens, impl=impl)
        np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,qn,h,kv,hd,page,pps,npages", [
    (2, 8, 4, 2, 64, 128, 4, 16),
    (3, 16, 8, 4, 128, 128, 2, 8),
    (1, 4, 4, 1, 64, 128, 8, 32),
    (4, 8, 4, 4, 80, 16, 8, 40),       # StableLM: hd 80, page 16, G=1
    (2, 6, 8, 2, 80, 16, 6, 16),       # hd 80 with G=4
])
def test_mixed_matches_jax(b, qn, h, kv, hd, page, pps, npages):
    q, kp, vp, bt, qpos = _mixed_inputs(qn * 100 + hd, b, qn, h, kv, hd,
                                        page, pps, npages)
    ours = _torch(paged_attention_mixed, q, kp, vp, bt, qpos, impl="ref")
    auto = _torch(paged_attention_mixed, q, kp, vp, bt, qpos)
    np.testing.assert_array_equal(ours, auto)     # CPU "auto" is the ref
    for impl in ("ref", "kernel"):
        theirs = _jax(jax_paged_attention_mixed, q, kp, vp, bt, qpos,
                      impl=impl)
        np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hd,page", [(64, 128), (80, 16)])
def test_int8_pages_match_jax_and_stay_close_to_fp(hd, page):
    b, qn, h, kv, pps, npages = 2, 4, 4, 2, 2, 8
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((b, qn, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = rng.integers(0, npages, (b, pps)).astype(np.int32)
    qpos = rng.integers(0, pps * page, (b, qn)).astype(np.int32)
    kq, ks = _quant_np(kp)
    vq, vs = _quant_np(vp)
    fp = _torch(paged_attention_mixed, q, kp, vp, bt, qpos, impl="ref")
    i8 = _torch(paged_attention_mixed, q, kq, vq, bt, qpos, impl="ref",
                k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(i8, fp, rtol=0.05, atol=0.05)
    for impl in ("ref", "kernel"):
        theirs = _jax(jax_paged_attention_mixed, q, kq, vq, bt, qpos,
                      impl=impl, k_scales=ks, v_scales=vs)
        np.testing.assert_allclose(i8, theirs, rtol=TOL, atol=TOL)


# -------------------------------------------------------------- properties
def test_ignores_pages_beyond_length():
    b, h, kv, hd, page, pps, npages = 1, 2, 2, 80, 16, 4, 8
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = np.array([[0, 1, 2, 3]], np.int32)
    lens = np.array([20], np.int32)
    out1 = _torch(paged_attention, q, kp, vp, bt, lens, impl="ref")
    kp[2:] = 1e4                    # poison pages beyond the length
    vp[2:] = -1e4
    kp[1, 4:] = 1e4                 # and the slots past it in its page
    vp[1, 4:] = -1e4
    out2 = _torch(paged_attention, q, kp, vp, bt, lens, impl="ref")
    np.testing.assert_allclose(out1, out2, rtol=1e-5)


def test_causal_within_chunk():
    """Garbage at key slots past a row's position never reaches the row."""
    b, qn, h, kv, hd, page, pps, npages = 1, 4, 2, 2, 80, 16, 8, 8
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, qn, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = np.arange(pps, dtype=np.int32)[None]
    qpos = np.array([[60, 61, 62, 63]], np.int32)
    out1 = _torch(paged_attention_mixed, q, kp, vp, bt, qpos, impl="ref")
    for i, p in enumerate(qpos[0]):
        kp2, vp2 = kp.copy(), vp.copy()
        pg, off = divmod(int(p) + 1, page)
        kp2[pg, off:] = 1e4
        kp2[pg + 1:] = 1e4
        vp2[pg, off:] = -1e4
        vp2[pg + 1:] = -1e4
        out2 = _torch(paged_attention_mixed, q, kp2, vp2, bt, qpos,
                      impl="ref")
        np.testing.assert_allclose(out2[0, :i + 1], out1[0, :i + 1],
                                   rtol=1e-5)
        if i + 1 < qn:              # later rows do see the poison
            assert not np.allclose(out2[0, i + 1:], out1[0, i + 1:])


def test_pad_rows_at_position_zero():
    """A pad row (position 0) attends key slot 0 alone, so it returns that
    slot's V, and it changes nothing in the lane's live rows."""
    b, qn, h, kv, hd, page, pps, npages = 2, 6, 4, 2, 80, 16, 4, 12
    q, kp, vp, bt, qpos = _mixed_inputs(3, b, qn, h, kv, hd, page, pps,
                                        npages)
    out = _torch(paged_attention_mixed, q, kp, vp, bt, qpos, impl="ref")
    g = h // kv
    for lane in range(b):
        v0 = vp[bt[lane, 0], 0]                           # [KV, hd]
        for row in np.nonzero(qpos[lane] == 0)[0]:
            np.testing.assert_allclose(out[lane, row],
                                       np.repeat(v0, g, axis=0), rtol=1e-6)
    live = qn - qn // 2
    alone = _torch(paged_attention_mixed, q[:, :live], kp, vp, bt,
                   qpos[:, :live], impl="ref")
    np.testing.assert_allclose(out[:, :live], alone, rtol=1e-6, atol=1e-6)


def test_width_bucket_invariance():
    """Narrowing the block table to the live pages (the runtime's width
    bucketing) does not change the output."""
    b, qn, h, kv, hd, page, npages = 2, 3, 4, 4, 80, 16, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, qn, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = rng.integers(0, npages, (b, 8)).astype(np.int32)
    qpos = np.array([[5, 17, 31], [0, 12, 30]], np.int32)   # <= 2 pages
    wide = _torch(paged_attention_mixed, q, kp, vp, bt, qpos, impl="ref")
    narrow = _torch(paged_attention_mixed, q, kp, vp, bt[:, :2], qpos,
                    impl="ref")
    np.testing.assert_allclose(wide, narrow, rtol=1e-6, atol=1e-6)


def test_q1_matches_decode():
    b, h, kv, hd, page, pps, npages = 2, 4, 2, 80, 16, 8, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp, vp = _pool(rng, npages, page, kv, hd)
    bt = rng.integers(0, npages, (b, pps)).astype(np.int32)
    lens = np.array([50, 128], np.int32)
    dec = _torch(paged_attention, q, kp, vp, bt, lens, impl="ref")
    mix = _torch(paged_attention_mixed, q[:, None], kp, vp, bt,
                 (lens - 1)[:, None], impl="ref")
    np.testing.assert_allclose(mix[:, 0], dec, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- dispatch and card
def test_kernel_impl_refuses_cpu_tensors():
    q, kp, vp, bt, qpos = _mixed_inputs(6, 1, 2, 2, 2, 80, 16, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_mixed(_t(q), _t(kp), _t(vp), _t(bt), _t(qpos),
                              impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        paged_attention_mixed(_t(q), _t(kp), _t(vp), _t(bt), _t(qpos),
                              impl="pallas")
