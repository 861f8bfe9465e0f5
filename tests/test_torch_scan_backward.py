"""The two scans' backward on the CPU: ``Rwkv6ScanFn`` and
``SelectiveScanFn`` (the autograd wiring the card's training path runs,
here on the plain forward and the backward kernels' plain versions, by
formula) under ``gradcheck`` in float64 with initial states and
cotangents on both outputs; the formula backward against torch autograd
of the plain forward in f32, with the decay past f32 underflow and
delta * A past the exponential's flush to 0; and the port's RWKV-6
time-mix and Mamba layer on the Function path against ``jax.vjp`` of the
JAX package's layers, on bridged weights and the same inputs.  The
kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels_cuda.py``).

Tolerances: the formula against autograd to 1e-5 of each gradient's max
|value| (two f32 sums in another order); the layers against JAX to 1e-4
of each gradient's max |value| (JAX's associative scan and lax.scan sum
in other orders than the port's sequential loops)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
from repro.models.common import NO_POLICY
from repro.models.model import Model as JaxModel
from repro.models.params import init_from_plan as jax_init
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.rwkv6_scan import kernel_bwd as wkv_bwd_kernel
from repro_torch.kernels.rwkv6_scan.kernel import HEAD_DIMS
from repro_torch.kernels.rwkv6_scan.ops import Rwkv6ScanFn, rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_bwd_ref,
                                                rwkv6_scan_ref)
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.selective_scan import kernel_bwd as scan_bwd_kernel
from repro_torch.kernels.selective_scan.ops import (SelectiveScanFn,
                                                    selective_scan)
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import ssm as t_ssm
from repro_torch.models.bridge import params_from_numpy

W_UNDERFLOW = float(np.exp(-np.exp(6.0)))     # w at w_log = 6: 0 in f32


def _wkv_inputs(seed, b, s, h, hd, dtype=np.float64, underflow=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)) * 0.5 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, s, h, hd))))
    if underflow:
        w[..., ::3] = W_UNDERFLOW
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.1
    return [torch.from_numpy(a.astype(dtype)) for a in (r, k, v, w, u, s0)]


def _scan_inputs(seed, b, s, d, n, dtype=np.float64, wide=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)) * 0.5
    dt = np.abs(rng.standard_normal((b, s, d))) * 0.1 + 0.01
    a = -np.abs(rng.standard_normal((d, n))) - 0.1
    if wide:
        # delta * A from ~0 to far past -126 / ln 2: e^{delta A} is 0 in f32
        dt = rng.uniform(0.05, 1.0, (b, s, d))
        a = -np.exp(rng.uniform(np.log(0.01), np.log(1000.0), (d, n)))
    bm, cm = (rng.standard_normal((b, s, n)) * 0.5 for _ in range(2))
    dd = rng.standard_normal((d,))
    h0 = rng.standard_normal((b, d, n)) * 0.1
    return [torch.from_numpy(v.astype(dtype))
            for v in (x, dt, a, bm, cm, dd, h0)]


@pytest.mark.parametrize("b,s,h,hd", [(2, 5, 2, 3), (1, 7, 3, 4)])
def test_rwkv6_scan_fn_gradcheck(b, s, h, hd):
    """Plain forward, formula backward, float64: both outputs' cotangents,
    every input's gradient, s0 included."""
    inputs = [t.requires_grad_() for t in _wkv_inputs(s + hd, b, s, h, hd)]

    def fn(*xs):
        return Rwkv6ScanFn.apply(*xs, False)
    assert torch.autograd.gradcheck(fn, tuple(inputs))


@pytest.mark.parametrize("b,s,d,n", [(2, 5, 3, 2), (1, 7, 4, 3)])
def test_selective_scan_fn_gradcheck(b, s, d, n):
    inputs = [t.requires_grad_() for t in _scan_inputs(s + n, b, s, d, n)]

    def fn(*xs):
        return SelectiveScanFn.apply(*xs, False)
    assert torch.autograd.gradcheck(fn, tuple(inputs))


def _autograd(fn, inputs, cotangents):
    xs = [t.clone().requires_grad_() for t in inputs]
    outs = fn(*xs)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(loss, xs)


def _close_to_scale(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(scale, 1e-30), err_msg=name)


@pytest.mark.parametrize("underflow", [False, True],
                         ids=["w-in-range", "w-past-underflow"])
def test_wkv_formula_matches_autograd_of_plain_version(underflow):
    inputs = _wkv_inputs(3, 2, 40, 3, 8, np.float32, underflow=underflow)
    if underflow:
        assert float(inputs[3].min()) == 0.0
    rng = np.random.default_rng(4)
    dy = torch.from_numpy(rng.standard_normal((2, 40, 3, 8)).astype(
        np.float32))
    dsf = torch.from_numpy((rng.standard_normal((2, 3, 8, 8)) * 0.1).astype(
        np.float32))
    want = _autograd(rwkv6_scan_ref, inputs, (dy, dsf))
    got = rwkv6_scan_bwd_ref(*inputs, dy, dsf)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close_to_scale(g, w, 1e-5, name)


def test_wkv_decay_gradient_stays_finite_past_underflow():
    """Through w = exp(-exp(w_log)) with w_log = 6 (w is 0 in f32), the
    Function's dw chains to a finite d w_log equal to autograd's through
    the plain version (0 where w underflowed)."""
    r, k, v, w, u, s0 = _wkv_inputs(5, 1, 30, 2, 8, np.float32)
    w_log = torch.log(-torch.log(w))
    w_log[..., ::2] = 6.0
    grads = {}
    for impl in ("auto", "ref"):
        wl = w_log.clone().requires_grad_()
        y, sf = rwkv6_scan(r, k, v, torch.exp(-torch.exp(wl)), u, s0,
                           impl=impl)
        (y.square().sum() + sf.sum()).backward()
        grads[impl] = wl.grad
    assert bool(torch.isfinite(grads["auto"]).all())
    assert bool((grads["auto"][..., ::2] == 0).all())
    _close_to_scale(grads["auto"], grads["ref"], 1e-5)


@pytest.mark.parametrize("wide", [False, True],
                         ids=["exp-in-range", "exp-flushed"])
def test_scan_formula_matches_autograd_of_plain_version(wide):
    inputs = _scan_inputs(6, 2, 40, 5, 4, np.float32, wide=wide)
    if wide:
        ea = torch.exp(inputs[1][..., None] * inputs[2])
        assert float(ea.min()) == 0.0          # flushed on some steps
    rng = np.random.default_rng(7)
    dy = torch.from_numpy(rng.standard_normal((2, 40, 5)).astype(np.float32))
    dhf = torch.from_numpy((rng.standard_normal((2, 5, 4)) * 0.1).astype(
        np.float32))
    want = _autograd(selective_scan_ref, inputs, (dy, dhf))
    got = selective_scan_bwd_ref(*inputs, dy, dhf)
    names = ("dx", "ddelta", "da", "db", "dc", "dd", "dh0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close_to_scale(g, w, 1e-5, name)


def test_bf16_scan_backward_keeps_x_dtype():
    """dx comes back in x's dtype (bf16), the rest in f32."""
    x, dt, a, bm, cm, dd, h0 = _scan_inputs(8, 1, 6, 4, 3, np.float32)
    x = x.to(torch.bfloat16).requires_grad_()
    y, _ = selective_scan(x, dt, a.requires_grad_(), bm, cm, dd, h0)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and a.grad.dtype == torch.float32


def test_backward_kernels_refuse_cpu_tensors():
    wkv = _wkv_inputs(0, 1, 4, 2, 16, np.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wkv_bwd_kernel.rwkv6_scan_bwd(*wkv, torch.zeros_like(wkv[0]))
    scan = _scan_inputs(0, 1, 4, 3, 2, np.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        scan_bwd_kernel.selective_scan_bwd(*scan, torch.zeros_like(scan[0]))
    assert wkv_bwd_kernel.launches == scan_bwd_kernel.launches == 0


@pytest.mark.parametrize("hd,blocks", [(16, 1), (32, 2), (64, 2), (128, 8)])
def test_wkv_bwd_cluster_size(hd, blocks):
    """Blocks of 16 key rows (32 at hd 64, where 4 blocks of 16 do not fit
    the training shape's 64 clusters on an H100 at once), within the
    portable cluster size of 8, for every head width the kernel
    compiles."""
    assert hd in HEAD_DIMS
    assert wkv_bwd_kernel.cluster_size(hd) == blocks <= 8


@pytest.mark.parametrize("b,s,h,hd", [(2, 4096, 32, 64), (3, 70, 5, 128),
                                      (1, 1, 2, 16), (4, 333, 40, 64)])
def test_wkv_bwd_scratch_plan(b, s, h, hd):
    """A call's scratch is the chunk checkpoints of S and one du share per
    batch row: no [hd / 16, 3, B, S, H, hd] buffer of column-tile partials
    (805 MB at RWKV-6's training shape)."""
    plan = wkv_bwd_kernel.scratch_shapes(b, s, h, hd)
    assert plan == {"ckpt": (b, h, -(-s // 32), hd, hd), "du_part": (b, h, hd)}
    assert (hd // 16, 3, b, s, h, hd) not in plan.values()


@pytest.mark.parametrize("b,s,d,n,planes", [(2, 4096, 8192, 16, 128),
                                            (1, 70, 8200, 16, 129),
                                            (2, 40, 1024, 64, 64),
                                            (3, 1, 100, 1, 2)])
def test_scan_bwd_scratch_plan(b, s, d, n, planes):
    """A call's scratch is one dB / dC plane per block of 64 channels (16
    for N > 16), each batch row's share of dA and its dD shares by step
    offset (four); the checkpoints of h (before every 32nd step, 134 MB at
    Jamba's training shape) come from the forward."""
    plan = scan_bwd_kernel.scratch_shapes(b, s, d, n)
    assert plan == {"bc_part": (planes, 2, b, s, n), "a_part": (b, d, n),
                    "d_part": (b, scan_bwd_kernel.XSTEPS, d)}
    assert scan_bwd_kernel.XSTEPS == 4
    assert scan_kernel.ckpt_shape(b, s, d, n) == (b, -(-s // 32), d, n)
    if (b, s, d, n) == (2, 4096, 8192, 16):
        assert 4 * np.prod(plan["bc_part"]) == 134217728
        assert 4 * np.prod(scan_kernel.ckpt_shape(b, s, d, n)) == 134217728


# ---------------------------------------------- layers against jax.vjp
def _np(t):
    return t.detach().numpy()


def _hold_tree(got, want, tol=1e-4):
    """Every leaf's gradient within ``tol`` of its own max |value|."""
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        _close_to_scale(_np(got[name]), np.asarray(want[name]), tol, name)


@pytest.fixture(scope="module")
def rwkv_layer():
    """One reduced float32 RWKV-6 layer (every leaf in f32: the plan keeps
    matrices in bf16, whose gradients would round at 4e-3), ``mu``,
    ``w0``, ``u`` and ``ln_x`` redrawn with the spread of trained weights,
    and ``w0`` = 6 on every fourth channel, so the decay underflows to 0
    there."""
    jcfg = reduced(get_config("rwkv6_1_6b")).replace(dtype="float32")
    tcfg = t_reduced(t_get_config("rwkv6_1_6b")).replace(dtype="float32")
    jp = dict(jax.tree.map(lambda a: a[0].astype(jnp.float32), JaxModel(
        jcfg).init(jax.random.key(2))["period"]["sub0"]["rwkv"]))
    rng = np.random.default_rng(8)
    for name, scale in (("mu", 0.5), ("cm_mu", 0.5), ("w0", 1.0),
                        ("u", 0.5), ("ln_x", 0.2)):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * scale,
                               jp[name].dtype)
    jp["w0"] = jp["w0"].at[::4].set(6.0)
    return jcfg, tcfg, jp


def test_rwkv_time_mix_vjp_matches_jax(rwkv_layer):
    jcfg, tcfg, jp = rwkv_layer
    heads, hd = tcfg.d_model // tcfg.rwkv.head_dim, tcfg.rwkv.head_dim
    rng = np.random.default_rng(9)
    b, s = 2, 24
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((b, tcfg.d_model)).astype(np.float32)
    wkv = (rng.standard_normal((b, heads, hd, hd)) * 0.1).astype(np.float32)
    d_out = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    d_wkv = (rng.standard_normal((b, heads, hd, hd)) * 0.1).astype(
        np.float32)

    def jfn(p, x_, prev_, wkv_):
        out, (_, s_final) = jax_rwkv.rwkv_time_mix(p, x_, prev_, wkv_, jcfg,
                                                   NO_POLICY)
        return out, s_final
    _, vjp = jax.vjp(jfn, jp, jnp.asarray(x), jnp.asarray(prev),
                     jnp.asarray(wkv))
    jgp, jgx, jgprev, jgwkv = vjp((jnp.asarray(d_out), jnp.asarray(d_wkv)))

    tp = {k: t.requires_grad_() for k, t in params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu").items()}
    tx, tprev, twkv = (torch.from_numpy(a).requires_grad_()
                       for a in (x, prev, wkv))
    out, (_, s_final) = t_rwkv.rwkv_time_mix(tp, tx, tprev, twkv, tcfg)
    assert type(s_final.grad_fn).__name__.startswith("Rwkv6ScanFn")
    loss = (out * torch.from_numpy(d_out)).sum() + (
        s_final * torch.from_numpy(d_wkv)).sum()
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names]
                                + [tx, tprev, twkv], allow_unused=True,
                                materialize_grads=True)
    _hold_tree(dict(zip(names, grads)), jgp)
    for g, w in zip(grads[len(names):], (jgx, jgprev, jgwkv)):
        _close_to_scale(_np(g), np.asarray(w), 1e-4)


@pytest.fixture(scope="module")
def mamba_layer():
    """One reduced float32 Jamba Mamba layer, every leaf in f32, redrawn
    with the spread of trained weights (as ``tests/test_torch_ssm_moe.py``
    does), and
    ``A_log`` = 7 on every fourth channel (A = -1097), so e^{delta A}
    flushes to 0 there."""
    jcfg = reduced(get_config("jamba_v0_1_52b")).replace(dtype="float32")
    tcfg = t_reduced(t_get_config("jamba_v0_1_52b")).replace(
        dtype="float32")
    plan = jax_ssm.mamba_plan(jcfg)
    d_inner, dt_rank = jax_ssm._dims(jcfg)
    rng = np.random.default_rng(3)
    spread = {"in_proj": jcfg.d_model ** -0.5, "conv_w": 0.5, "conv_b": 0.1,
              "x_proj": d_inner ** -0.5, "dt_proj": dt_rank ** -0.5,
              "dt_bias": 0.5, "out_proj": d_inner ** -0.5, "D": 0.1}
    jp = {k: a.astype(jnp.float32)
          for k, a in jax_init(plan, jax.random.key(0)).items()}
    for name, scale in spread.items():
        base = 1.0 if name == "D" else (-1.0 if name == "dt_bias" else 0.0)
        jp[name] = jnp.asarray(
            base + rng.standard_normal(plan[name].shape) * scale,
            jnp.float32)
    jp["A_log"] = jp["A_log"].at[::4].set(7.0)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "given-state"])
def test_mamba_prefill_vjp_matches_jax(mamba_layer, with_state):
    jcfg, tcfg, jp = mamba_layer
    d_inner, _ = jax_ssm._dims(jcfg)
    n, pad = jcfg.mamba.d_state, jcfg.mamba.d_conv - 1
    rng = np.random.default_rng(10)
    b, s = 2, 19
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((b, d_inner, pad)).astype(np.float32)
    ssm = (rng.standard_normal((b, d_inner, n)) * 0.3).astype(np.float32)
    d_out = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    d_ssm = (rng.standard_normal((b, d_inner, n)) * 0.3).astype(np.float32)

    def jfn(p, x_, conv_, ssm_):
        kw = dict(conv_init=conv_, ssm_init=ssm_) if with_state else {}
        out, st = jax_ssm.mamba_prefill(p, x_, jcfg, NO_POLICY, **kw)
        return out, st["ssm"]
    _, vjp = jax.vjp(jfn, jp, jnp.asarray(x), jnp.asarray(conv),
                     jnp.asarray(ssm))
    jgp, jgx, jgconv, jgssm = vjp((jnp.asarray(d_out), jnp.asarray(d_ssm)))

    tp = {k: t.requires_grad_() for k, t in params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu").items()}
    tx, tconv, tssm = (torch.from_numpy(a).requires_grad_()
                       for a in (x, conv, ssm))
    kw = dict(conv_init=tconv, ssm_init=tssm) if with_state else {}
    out, st = t_ssm.mamba_prefill(tp, tx, tcfg, **kw)
    assert type(st["ssm"].grad_fn).__name__.startswith("SelectiveScanFn")
    loss = (out * torch.from_numpy(d_out)).sum() + (
        st["ssm"] * torch.from_numpy(d_ssm)).sum()
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names]
                                + [tx, tconv, tssm], allow_unused=True,
                                materialize_grads=True)
    gtree = dict(zip(names, grads))
    # A = -exp(A_log) and D keep their gradients
    assert bool(gtree["A_log"].abs().sum() > 0)
    assert bool(gtree["D"].abs().sum() > 0)
    _hold_tree(gtree, jgp)
    _close_to_scale(_np(grads[len(names)]), np.asarray(jgx), 1e-4)
    if with_state:
        _close_to_scale(_np(grads[-2]), np.asarray(jgconv), 1e-4)
        _close_to_scale(_np(grads[-1]), np.asarray(jgssm), 1e-4)
