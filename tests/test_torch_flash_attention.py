"""The port's prefill attention against the JAX package on the same numpy
inputs: the plain version of the flash kernel against the JAX oracle and
the Pallas kernel (interpret mode, as tests/test_kernels.py runs it) on
the rows of tests/test_kernels.py, at 2e-3 in float32 and 2e-2 in bf16;
and the port's ``gqa_prefill`` / ``build_gqa_cache`` / ``gqa_decode``
against their JAX twins for a causal GQA layer, a sliding-window layer
whose ring cache wraps, and a logit-softcapped layer, in float32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.configs.base import get_config, reduced
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models import attention as jax_attn
from repro.models.common import NO_POLICY
from repro_torch.configs.base import LayerSpec
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as t_attn

ROWS = [  # tests/test_kernels.py: b, s, t, h, kv, hd, causal, window, cap, dtype
    (2, 128, 128, 4, 2, 64, True, 0, None, "float32"),
    (1, 256, 256, 8, 8, 128, True, 128, 50.0, "float32"),
    (2, 64, 192, 4, 1, 64, True, 0, None, "float32"),
    (1, 128, 128, 4, 4, 64, False, 0, None, "float32"),
    (1, 128, 128, 2, 2, 128, True, 0, None, "bfloat16"),
    (1, 384, 384, 4, 2, 64, True, 256, None, "float32"),
]


def _inputs(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap,dtype", ROWS)
def test_plain_version_matches_jax_ref_and_pallas(b, s, t, h, kv, hd, causal,
                                                  window, cap, dtype):
    q, k, v = _inputs(s + t + hd, b, s, t, h, kv, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    ours = flash_attention(tq, tk, tv, impl="ref", **kw)
    assert ours.dtype == tq.dtype
    auto = flash_attention(tq, tk, tv, **kw)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  auto.float().numpy())  # CPU auto is ref
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    for theirs in (jax_ref(jq, jk, jv, **kw),
                   jax_flash(jq, jk, jv, block_q=64, block_k=64, **kw)):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(theirs, np.float32),
                                   rtol=tol, atol=tol)


def test_rows_no_key_reaches_give_zero():
    """End-aligned with S > T under a causal mask: the first rows see no
    key and come out 0 (acc / (l + 1e-30)), as in the JAX oracle."""
    q, k, v = _inputs(3, 1, 8, 4, 2, 2, 16)
    ours = flash_attention(*map(torch.from_numpy, (q, k, v)), impl="ref")
    theirs = jax_ref(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)
    assert float(ours[:, :4].abs().max()) == 0.0


def test_kernel_route_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(4, 1, 8, 8, 2, 2, 16))
    before = tkernel.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="unknown flash_attention impl"):
        flash_attention(q, k, v, impl="triton")
    assert tkernel.launches == before


# ------------------------------------------------------- the GQA layer
def _close(ours, theirs, tol=1e-5):
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), theirs,
                               rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("kv,window,cap", [(2, 0, None), (4, 16, None),
                                           (2, 0, 30.0)],
                         ids=["causal-gqa", "window-ring", "softcap"])
def test_gqa_prefill_cache_and_decode_match_jax(kv, window, cap):
    b, s, seq_cap, steps = 2, 40, 56, 12
    jcfg = reduced(get_config("stablelm_3b")).replace(dtype="float32")
    tcfg = t_reduced(t_get_config("stablelm_3b")).replace(dtype="float32")
    jcfg = jcfg.replace(attn=dataclasses.replace(
        jcfg.attn, num_kv_heads=kv, logit_softcap=cap))
    tcfg = tcfg.replace(attn=dataclasses.replace(
        tcfg.attn, num_kv_heads=kv, logit_softcap=cap))
    jlayer, tlayer = JaxLayerSpec(window=window), LayerSpec(window=window)
    a, d = tcfg.attn, tcfg.d_model
    rng = np.random.default_rng(kv * 100 + window)
    shapes = {"wq": (d, a.num_heads, a.head_dim),
              "wk": (d, kv, a.head_dim), "wv": (d, kv, a.head_dim),
              "wo": (a.num_heads, a.head_dim, d)}
    params = {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(
        np.float32) for n, sh in shapes.items()}
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = {n: torch.from_numpy(p) for n, p in params.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))

    jout, (jk, jv) = jax_attn.gqa_prefill(jp, jnp.asarray(x), jnp.asarray(pos),
                                          jlayer, jcfg, NO_POLICY)
    tout, (tk, tv) = t_attn.gqa_prefill(tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), tlayer, tcfg)
    _close(tout, jout)
    jcache = jax_attn.build_gqa_cache(jk, jv, jnp.asarray(pos), jlayer,
                                      seq_cap, NO_POLICY)
    tcache = t_attn.build_gqa_cache(tk, tv, torch.from_numpy(pos), tlayer,
                                    seq_cap)
    cap_slots = window or seq_cap
    assert tcache["k"].shape == (b, cap_slots, kv, a.head_dim)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    ptr = tcache["k"].data_ptr()
    for i in range(steps):               # the ring wraps for window 16
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        p1 = np.full((b,), s + i, np.int32)
        jout, jcache = jax_attn.gqa_decode(jp, jnp.asarray(x1), jcache,
                                           jnp.asarray(p1), jlayer, jcfg,
                                           NO_POLICY)
        tout = t_attn.gqa_decode(tp, torch.from_numpy(x1), tcache,
                                 torch.from_numpy(p1), tlayer, tcfg)
        _close(tout, jout)
    assert tcache["k"].data_ptr() == ptr          # written in place
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_int8_dense_cache_is_refused_by_name(monkeypatch):
    """(The name predates the int8 slot cache's port; the test keeps it.)
    ``REPRO_KV_INT8=1`` plans the reference's int8 slot cache (int8 K/V,
    bf16 scales per token and kv head, positions) for full and window
    layers, and a window-16 ring cache built from prefill and written by
    12 decode steps (it wraps) matches the JAX package's: the same
    positions, int8 codes at most one step apart, scales to 1e-2, and the
    attention outputs to 1e-2 of their largest value."""
    b, s, seq_cap, steps, window = 2, 40, 56, 12, 16
    jcfg = reduced(get_config("stablelm_3b")).replace(dtype="float32")
    tcfg = t_reduced(t_get_config("stablelm_3b")).replace(dtype="float32")
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    for w in (0, window):
        plan = t_attn.attn_cache_plan(tcfg, LayerSpec(window=w), 2, 64)
        jplan = jax_attn.attn_cache_plan(jcfg, JaxLayerSpec(window=w), 2, 64,
                                         NO_POLICY)
        assert {k: (p.shape, p.dtype) for k, p in plan.items()} == \
            {k: (p.shape, p.dtype) for k, p in jplan.items()}
        assert plan["k"].dtype == "int8" and plan["k_scale"].dtype == \
            "bfloat16"
    jlayer, tlayer = JaxLayerSpec(window=window), LayerSpec(window=window)
    a, d = tcfg.attn, tcfg.d_model
    rng = np.random.default_rng(8)
    shapes = {"wq": (d, a.num_heads, a.head_dim),
              "wk": (d, a.num_kv_heads, a.head_dim),
              "wv": (d, a.num_kv_heads, a.head_dim),
              "wo": (a.num_heads, a.head_dim, d)}
    params = {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(
        np.float32) for n, sh in shapes.items()}
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = {n: torch.from_numpy(p) for n, p in params.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    _, (jk, jv) = jax_attn.gqa_prefill(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jlayer, jcfg, NO_POLICY)
    _, (tk, tv) = t_attn.gqa_prefill(tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), tlayer, tcfg)
    jcache = jax_attn.build_gqa_cache(jk, jv, jnp.asarray(pos), jlayer,
                                      seq_cap, NO_POLICY)
    tcache = t_attn.build_gqa_cache(tk, tv, torch.from_numpy(pos), tlayer,
                                    seq_cap)

    def same_cache():
        assert sorted(tcache) == sorted(jcache)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for name in ("k", "v"):
            assert tcache[name].dtype == torch.int8
            assert np.abs(tcache[name].numpy().astype(np.int32)
                          - np.asarray(jcache[name]).astype(np.int32)
                          ).max() <= 1
            np.testing.assert_allclose(
                tcache[name + "_scale"].float().numpy(),
                np.asarray(jcache[name + "_scale"].astype(jnp.float32)),
                rtol=1e-2)

    same_cache()
    ptr = tcache["k_scale"].data_ptr()
    for i in range(steps):               # the ring wraps for window 16
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        p1 = np.full((b,), s + i, np.int32)
        jout, jcache = jax_attn.gqa_decode(jp, jnp.asarray(x1), jcache,
                                           jnp.asarray(p1), jlayer, jcfg,
                                           NO_POLICY)
        tout = t_attn.gqa_decode(tp, torch.from_numpy(x1), tcache,
                                 torch.from_numpy(p1), tlayer, tcfg)
        jo = np.asarray(jout)
        assert np.abs(tout.numpy() - jo).max() <= 1e-2 * np.abs(jo).max()
    assert tcache["k_scale"].data_ptr() == ptr    # written in place
    same_cache()
