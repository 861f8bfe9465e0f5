"""The port's RWKV-6 WKV scan and time/channel mix against the JAX package on
the same numpy inputs: the plain version of the scan kernel against the
JAX oracle and the Pallas kernel (interpret mode) on the rows of
tests/test_kernels.py at 1e-4 (S=33 taken unpadded: the port has no chunk
restriction), and ``rwkv_time_mix`` / ``rwkv_channel_mix`` against their
JAX twins on reduced RWKV-6 1.6B with bridged weights; two chained halves
through the state equal the whole sequence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_ref
from repro.models import rwkv as jax_rwkv
from repro.models.common import NO_POLICY
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.rwkv6_scan import kernel as tkernel
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.bridge import params_from_numpy

TOL = 1e-4


def _inputs(seed, b, s, h, hd):
    """r/k/v/w/u/s0 as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)) * 0.5 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, s, h, hd))))
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.1
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("b,s,h,hd,chunk", [
    (2, 64, 4, 32, 32),
    (1, 96, 2, 64, 48),
    (1, 33, 1, 32, 33),   # ragged: the JAX kernel needs chunk | S
])
def test_plain_version_matches_jax_ref_and_pallas(b, s, h, hd, chunk):
    args = _inputs(s * 10 + hd, b, s, h, hd)
    y, sf = rwkv6_scan(*map(torch.from_numpy, args), impl="ref")
    ya, sfa = rwkv6_scan(*map(torch.from_numpy, args))     # CPU auto: ref
    np.testing.assert_array_equal(_np(y), _np(ya))
    np.testing.assert_array_equal(_np(sf), _np(sfa))
    jargs = list(map(jnp.asarray, args))
    for yj, sj in (jax_ref(*jargs), jax_scan(*jargs, chunk=chunk)):
        np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(sf), np.asarray(sj), rtol=TOL,
                                   atol=TOL)


def test_zero_state_and_bf16_inputs():
    """s0=None starts from zeros; bf16 r/k/v/w give y in bf16 (computed in
    f32 from the same bf16 values as the Pallas kernel) and an f32 state."""
    r, k, v, w, u, _ = _inputs(5, 2, 32, 2, 32)
    y, sf = rwkv6_scan(*map(torch.from_numpy, (r, k, v, w, u)), impl="ref")
    yj, sj = jax_ref(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(sf), np.asarray(sj), rtol=TOL, atol=TOL)
    tb = [torch.from_numpy(a).bfloat16() for a in (r, k, v, w)]
    yb, sfb = rwkv6_scan(*tb, torch.from_numpy(u), impl="ref")
    assert yb.dtype == torch.bfloat16 and sfb.dtype == torch.float32
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v, w)]
    yjb, sjb = jax_scan(*jb, jnp.asarray(u), chunk=16)
    np.testing.assert_allclose(_np(yb), np.asarray(yjb, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(sfb), np.asarray(sjb), rtol=TOL, atol=TOL)


def test_chained_halves_equal_the_whole_scan():
    args = list(map(torch.from_numpy, _inputs(6, 1, 40, 2, 32)))
    r, k, v, w, u, s0 = args
    y, sf = rwkv6_scan(*args, impl="ref")
    y1, s1 = rwkv6_scan(r[:, :17], k[:, :17], v[:, :17], w[:, :17], u, s0,
                        impl="ref")
    y2, s2 = rwkv6_scan(r[:, 17:], k[:, 17:], v[:, 17:], w[:, 17:], u, s1,
                        impl="ref")
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(sf), rtol=1e-5, atol=1e-5)


def test_kernel_route_refuses_cpu_tensors():
    args = list(map(torch.from_numpy, _inputs(7, 1, 4, 1, 16)))
    before = tkernel.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rwkv6_scan(*args, impl="kernel")
    assert tkernel.launches == before


# ------------------------------------------------------ time/channel mix
@pytest.fixture(scope="module")
def layer():
    jcfg = reduced(get_config("rwkv6_1_6b")).replace(dtype="float32")
    tcfg = t_reduced(t_get_config("rwkv6_1_6b")).replace(dtype="float32")
    jp = jax.tree.map(lambda a: a[0], JaxModel(jcfg).init(
        jax.random.key(2))["period"]["sub0"]["rwkv"])
    # the "small" init leaves mu, w0 and u near zero: give them the spread
    # of trained weights so token-shift and decay are exercised
    rng = np.random.default_rng(8)
    jp = dict(jp)
    for name, scale in (("mu", 0.5), ("cm_mu", 0.5), ("w0", 1.0),
                        ("u", 0.5), ("ln_x", 0.2)):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * scale,
                               jp[name].dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(ours, theirs, tol=1e-5):
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(_np(ours), theirs, rtol=tol,
                               atol=tol * scale)


def _mix_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    heads, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    wkv = (rng.standard_normal((b, heads, hd, hd)) * 0.1).astype(np.float32)
    return x, prev, wkv


@pytest.mark.parametrize("s", [1, 24], ids=["decode", "prefill"])
def test_time_and_channel_mix_match_jax(layer, s):
    jcfg, tcfg, jp, tp = layer
    x, prev, wkv = _mix_inputs(tcfg, 3, s, s)
    jout, (jshift, jwkv) = jax_rwkv.rwkv_time_mix(
        jp, jnp.asarray(x), jnp.asarray(prev), jnp.asarray(wkv), jcfg,
        NO_POLICY)
    tout, (tshift, twkv) = t_rwkv.rwkv_time_mix(
        tp, torch.from_numpy(x), torch.from_numpy(prev),
        torch.from_numpy(wkv), tcfg)
    _close(tout, jout)
    _close(tshift, jshift)
    _close(twkv, jwkv)
    jcm, jcs = jax_rwkv.rwkv_channel_mix(jp, jnp.asarray(x),
                                         jnp.asarray(prev), NO_POLICY)
    tcm, tcs = t_rwkv.rwkv_channel_mix(tp, torch.from_numpy(x),
                                       torch.from_numpy(prev))
    _close(tcm, jcm)
    _close(tcs, jcs)


def test_time_mix_chained_halves_equal_the_whole(layer):
    _, tcfg, _, tp = layer
    x, prev, wkv = map(torch.from_numpy, _mix_inputs(tcfg, 2, 30, 9))
    out, (shift, st) = t_rwkv.rwkv_time_mix(tp, x, prev, wkv, tcfg)
    o1, (sh1, st1) = t_rwkv.rwkv_time_mix(tp, x[:, :11], prev, wkv, tcfg)
    o2, (sh2, st2) = t_rwkv.rwkv_time_mix(tp, x[:, 11:], sh1, st1, tcfg)
    np.testing.assert_allclose(_np(torch.cat([o1, o2], 1)), _np(out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(sh2), _np(shift))
    np.testing.assert_allclose(_np(st2), _np(st), rtol=1e-5, atol=1e-5)


def test_state_plan_keeps_shift_in_model_dtype():
    cfg = t_reduced(t_get_config("rwkv6_1_6b"))
    plan = t_rwkv.rwkv_state_plan(cfg, 4)
    assert plan["shift_att"].dtype == cfg.dtype == "bfloat16"
    assert plan["wkv"].dtype == "float32"
    assert plan["wkv"].shape == (4, cfg.d_model // 32, 32, 32)
    plan32 = t_rwkv.rwkv_state_plan(cfg.replace(dtype="float32"), 4)
    assert plan32["shift_ffn"].dtype == "float32"


def test_stabilize_random_keeps_a_deep_stack_finite():
    """The plan's random init diverges through 8 RWKV-6 layers (as the JAX
    model's does); ``Model`` applies ``stabilize_random`` to the random
    weights it draws, which keeps the logits finite."""
    from repro_torch.models.model import Model, model_plan, prefill
    from repro_torch.models.params import init_from_plan
    cfg = t_reduced(t_get_config("rwkv6_1_6b")).replace(repeats=8)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 64)))
    raw = init_from_plan(model_plan(cfg), torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    logits, _ = prefill(raw, cfg, toks)
    assert not bool(torch.isfinite(logits).all())
    model = Model(cfg, seed=0, device="cpu")
    logits, cache = prefill(model.params, cfg, toks)
    assert bool(torch.isfinite(logits).all())
    assert cache["period"]["sub0"]["self"]["wkv"].shape[:2] == (8, 1)
    # the same draw, rescaled once: Model's weights are exactly these
    t_rwkv.stabilize_random(raw, model.plan, cfg.repeats)
    for a, b in zip(model.parameters(), Model(cfg, raw, device="cpu")
                    .parameters()):
        assert torch.equal(a, b)
