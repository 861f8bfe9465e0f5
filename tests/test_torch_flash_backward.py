"""The flash-attention backward on the CPU: ``flash_attention_bwd_ref`` (the
backward kernel's plain version, by formula) against ``jax.vjp`` of the
JAX package's ``flash_attention_ref``; ``FlashAttentionFn`` (the
autograd wiring the card's training path runs, here on the plain
versions) under ``gradcheck`` in float64; and the scan ops' kernel route
under autograd, which runs inside their Functions.  The kernel
itself is held to these plain versions on the card
(``tests/test_torch_kernels_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

# B, S, T, H, KV, hd, causal, window, softcap
CASES = [
    (2, 24, 24, 4, 4, 16, True, 0, None),
    (2, 24, 24, 4, 2, 16, True, 6, None),          # GQA + window
    (1, 20, 20, 4, 1, 8, True, 0, 5.0),            # softcap, one kv head
    (2, 9, 30, 4, 2, 16, True, 0, None),           # T > S, end-aligned
    (1, 30, 9, 2, 2, 16, True, 0, None),           # T < S: rows see no key
    (2, 17, 23, 6, 3, 12, False, 0, None),         # non-causal T != S
    (1, 25, 25, 4, 2, 16, True, 7, 3.0),           # window + softcap
]


def _inputs(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd), (b, s, h, hd))]


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", CASES)
def test_bwd_ref_matches_jax_vjp(b, s, t, h, kv, hd, causal, window, cap):
    q, k, v, do = _inputs(s * t + hd, b, s, t, h, kv, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_ref(q_, k_, v_, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", CASES)
def test_lse_is_the_rows_logsumexp(b, s, t, h, kv, hd, causal, window, cap):
    """lse [B,H,S] is logsumexp of each row's kept (scaled, capped) scores,
    +inf for a row that no key reaches; the output is unchanged by asking
    for it."""
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(s + t, b, s, t, h, kv, hd))
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attention_ref(q, k, v, **kw))
    g = h // kv
    scores = torch.einsum("bskgh,btkh->bkgst",
                          q.reshape(b, s, kv, g, hd).double(),
                          k.double()) / hd ** 0.5
    if cap is not None:
        scores = torch.tanh(scores / cap) * cap
    pos_q = torch.arange(s)[:, None] + (t - s)
    pos_k = torch.arange(t)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool)
    if causal:
        mask &= pos_k <= pos_q
    if window:
        mask &= pos_k > pos_q - window
    want = torch.logsumexp(scores.masked_fill(~mask, -float("inf")), -1)
    want = want.reshape(b, h, s)
    assert torch.equal(torch.isinf(lse), ~mask.any(-1).expand(b, h, s))
    live = torch.isfinite(want)
    np.testing.assert_allclose(lse[live].numpy(), want[live].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert bool((lse[~live] == float("inf")).all())


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", [
    (1, 6, 6, 4, 2, 4, True, 0, None),
    (1, 5, 7, 2, 1, 6, True, 3, 2.0),
    (2, 6, 4, 2, 2, 4, False, 0, 1.5),
    (1, 7, 3, 2, 2, 4, True, 0, None),             # rows with no key
])
def test_flash_attention_fn_gradcheck(b, s, t, h, kv, hd, causal, window,
                                      cap):
    """The autograd Function with the plain forward and the plain
    backward by formula passes gradcheck in float64."""
    gen = torch.Generator().manual_seed(s * 10 + t)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))

    def fn(q_, k_, v_):
        return fops.FlashAttentionFn.apply(q_, k_, v_, False, causal,
                                           window, cap, None)
    assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", CASES)
def test_auto_route_matches_autograd_of_plain_version(b, s, t, h, kv, hd,
                                                      causal, window, cap):
    """On CPU tensors that require a gradient, ``impl="auto"`` runs
    ``FlashAttentionFn`` and gives the gradients autograd takes through
    the plain version (``impl="ref"``)."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(hd + s, b, s, t, h, kv, hd))
    kw = dict(causal=causal, window=window, softcap=cap)
    grads = {}
    for impl in ("auto", "ref"):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fops.flash_attention(*xs, impl=impl, **kw)
        is_fn = type(out.grad_fn).__name__.startswith("FlashAttentionFn")
        assert is_fn == (impl == "auto"), impl
        out.backward(do)
        grads[impl] = [x.grad for x in xs]
    for g, r in zip(grads["auto"], grads["ref"]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)
    with torch.no_grad():
        out = fops.flash_attention(q.requires_grad_(), k, v, **kw)
    assert out.grad_fn is None


def test_kernel_route_on_cpu_raises_in_the_function():
    """``impl="kernel"`` keeps the kernel under autograd too: a CPU tensor
    raises instead of running the plain version."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(0, 1, 4, 4, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention(q.requires_grad_(), k, v, impl="kernel")


def _wkv_args():
    rng = np.random.default_rng(3)
    r, k, v, w = (torch.from_numpy(rng.uniform(0.1, 0.9, (1, 5, 2, 4))
                                   .astype(np.float32)) for _ in range(4))
    u = torch.zeros(2, 4)
    return r, k, v, w, u


def _scan_args():
    rng = np.random.default_rng(4)
    x, dt = (torch.from_numpy(rng.uniform(0.1, 0.9, (1, 5, 6))
                              .astype(np.float32)) for _ in range(2))
    a = -torch.ones(6, 4)
    b, c = (torch.from_numpy(rng.standard_normal((1, 5, 4))
                             .astype(np.float32)) for _ in range(2))
    return x, dt, a, b, c, torch.zeros(6)


@pytest.mark.parametrize("which", ["rwkv6_scan", "selective_scan"])
def test_scan_ops_refuse_autograd_on_the_kernel_path(which):
    """Under grad, the scans' kernel route runs inside their autograd
    Function (``Rwkv6ScanFn`` / ``SelectiveScanFn``) and refuses a CPU
    tensor there instead of running the plain version; the auto route on
    the CPU gives the gradients autograd takes through the plain version
    (``impl="ref"``)."""
    if which == "rwkv6_scan":
        from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan as fn
        args = list(_wkv_args())
    else:
        from repro_torch.kernels.selective_scan.ops import (
            selective_scan as fn)
        args = list(_scan_args())
    x0 = args[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="CUDA") as err:
        fn(x0, *args[1:], impl="kernel")
    assert any(f.name == "forward" for f in err.traceback)  # the Function's
    grads = {}
    for impl in ("auto", "ref"):
        x = args[0].clone().requires_grad_()
        y, _ = fn(x, *args[1:], impl=impl)
        is_fn = type(y.grad_fn).__name__.endswith("FnBackward")
        assert is_fn == (impl == "auto"), impl
        y.square().sum().backward()
        grads[impl] = x.grad
    assert bool(grads["auto"].abs().sum() > 0)
    np.testing.assert_allclose(grads["auto"].numpy(), grads["ref"].numpy(),
                               rtol=1e-5, atol=1e-6)
    # without grad the kernel route is taken directly (and refuses a CPU
    # tensor)
    with torch.no_grad(), pytest.raises(ValueError):
        fn(*args, impl="kernel")


# head_dim, dtype, 16-byte aligned q/k/v/dO -> the backward's design: wgmma
# where a TMA map can stride the rows (bf16, hd a multiple of 8 up to MLA's
# 192, aligned), mma.sync for the other bf16 widths up to 128, the CUDA
# cores for float32 (whose exact products the lockstep runs need) and the
# bf16 widths beyond both
DESIGNS = [
    (80, torch.bfloat16, True, "wgmma"),      # StableLM's training shape
    (128, torch.bfloat16, True, "wgmma"),     # OLMo 2, Granite, StarCoder2
    (16, torch.bfloat16, True, "wgmma"),
    (72, torch.bfloat16, True, "wgmma"),
    (112, torch.bfloat16, True, "wgmma"),
    (136, torch.bfloat16, True, "wgmma"),
    (192, torch.bfloat16, True, "wgmma"),     # MLA's nope + rope rows
    (50, torch.bfloat16, True, "mma"),        # 100-byte rows: no TMA stride
    (64, torch.bfloat16, False, "mma"),       # an unaligned view
    (128, torch.bfloat16, False, "mma"),
    (192, torch.bfloat16, False, "cuda_cores"),
    (200, torch.bfloat16, True, "cuda_cores"),
    (256, torch.bfloat16, True, "cuda_cores"),
    (80, torch.float32, True, "cuda_cores"),
    (128, torch.float32, True, "cuda_cores"),
    (192, torch.float32, True, "cuda_cores"),
]


@pytest.mark.parametrize("hd,dtype,aligned,want", DESIGNS)
def test_backward_design_by_shape(hd, dtype, aligned, want):
    from repro_torch.kernels.flash_attention import kernel_bwd
    assert kernel_bwd.design(hd, dtype, aligned) == want


def test_alignment_of_views():
    """A contiguous view 2 bytes into its storage is not 16-byte aligned,
    so its call would take the mma.sync design."""
    from repro_torch.kernels.flash_attention import kernel_bwd
    base = torch.zeros(1 + 4 * 64, dtype=torch.bfloat16)
    whole = base[:4 * 64].view(1, 4, 1, 64)
    shifted = base[1:].view(1, 4, 1, 64)
    assert shifted.is_contiguous()
    assert kernel_bwd.aligned(whole)
    assert not kernel_bwd.aligned(whole, shifted)
