"""The port's Mamba mixer and MoE FFN against their JAX twins on the same
numpy inputs and bridged weights, at reduced Jamba widths in float32:
``mamba_prefill`` (from a zero state and from a given conv/ssm state) and
``mamba_decode`` (state written in place) to 1e-5 of the output's scale;
``moe_ffn`` with a near-uniform router, with a skewed router that forces
capacity drops (the same pairs must be dropped, so the outputs still
agree), and with DeepSeek-V2's shared expert; the plans match JAX's at
full width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models.common import NO_POLICY
from repro.models.params import init_from_plan as jax_init
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models.bridge import params_from_numpy

TOL = 1e-5


def _cfgs(arch="jamba_v0_1_52b"):
    return (reduced(get_config(arch)).replace(dtype="float32"),
            t_reduced(t_get_config(arch)).replace(dtype="float32"))


def _close(ours, theirs, tol=TOL):
    """Agree to ``tol`` relative to the output's own scale (two f32
    libraries sum in different orders; JAX's prefill scan is associative,
    the port's sequential)."""
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), theirs,
                               rtol=tol, atol=tol * scale)


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------------ mamba
@pytest.fixture(scope="module")
def mamba():
    """One reduced Jamba Mamba layer's weights, redrawn with the spread of
    trained weights (the plan's stacked init scales in_proj and x_proj by
    1/sqrt(repeats), which blows delta up to hundreds)."""
    jcfg, tcfg = _cfgs()
    plan = jax_ssm.mamba_plan(jcfg)
    d_inner, dt_rank = jax_ssm._dims(jcfg)
    rng = np.random.default_rng(3)
    spread = {"in_proj": jcfg.d_model ** -0.5, "conv_w": 0.5, "conv_b": 0.1,
              "x_proj": d_inner ** -0.5, "dt_proj": dt_rank ** -0.5,
              "dt_bias": 0.5, "out_proj": d_inner ** -0.5, "D": 0.1}
    jp = dict(jax_init(plan, jax.random.key(0)))
    for name, scale in spread.items():
        base = 1.0 if name == "D" else (-1.0 if name == "dt_bias" else 0.0)
        jp[name] = jnp.asarray(
            base + rng.standard_normal(plan[name].shape) * scale,
            plan[name].dtype)
    return jcfg, tcfg, jp, _bridge(jp)


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    d_inner, _ = jax_ssm._dims(cfg)
    conv = rng.standard_normal((b, d_inner, cfg.mamba.d_conv - 1))
    ssm = rng.standard_normal((b, d_inner, cfg.mamba.d_state)) * 0.3
    return conv.astype(np.float32), ssm.astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "given-state"])
def test_mamba_prefill_matches_jax(mamba, with_state):
    jcfg, tcfg, jp, tp = mamba
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, jcfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if with_state:
        conv, ssm = _state(jcfg, 2, 5)
        kw_j = dict(conv_init=jnp.asarray(conv), ssm_init=jnp.asarray(ssm))
        kw_t = dict(conv_init=torch.from_numpy(conv),
                    ssm_init=torch.from_numpy(ssm))
    jout, jst = jax_ssm.mamba_prefill(jp, jnp.asarray(x), jcfg, NO_POLICY,
                                      **kw_j)
    before = scan_kernel.launches
    tout, tst = t_ssm.mamba_prefill(tp, torch.from_numpy(x), tcfg, **kw_t)
    assert scan_kernel.launches == before       # the CPU runs the plain scan
    _close(tout, jout)
    _close(tst["conv"], jst["conv"])
    _close(tst["ssm"], jst["ssm"])
    assert tst["conv"].dtype == torch.float32


def test_mamba_decode_matches_jax_in_place(mamba):
    """Three decode steps from a given state: the port writes the slot
    cache views in place, the JAX step returns a new state; both agree."""
    jcfg, tcfg, jp, tp = mamba
    conv, ssm = _state(jcfg, 3, 6)
    jstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    tstate = {"conv": torch.from_numpy(conv.copy()),
              "ssm": torch.from_numpy(ssm.copy())}
    ptrs = {k: t.data_ptr() for k, t in tstate.items()}
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
        jout, jstate = jax_ssm.mamba_decode(jp, jnp.asarray(x), jstate, jcfg,
                                            NO_POLICY)
        tout = t_ssm.mamba_decode(tp, torch.from_numpy(x), tstate, tcfg)
        _close(tout, jout)
        _close(tstate["conv"], jstate["conv"])
        _close(tstate["ssm"], jstate["ssm"])
    assert {k: t.data_ptr() for k, t in tstate.items()} == ptrs


def test_prefill_then_decode_equals_one_longer_prefill(mamba):
    """Decode is prefill at S = 1 from the cached state: a prompt of 12
    followed by 4 decode steps gives the outputs and state of one prefill
    of all 16 tokens."""
    _, tcfg, _, tp = mamba
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    whole, st_whole = t_ssm.mamba_prefill(tp, x, tcfg)
    out, st = t_ssm.mamba_prefill(tp, x[:, :12], tcfg)
    outs = [out]
    for t in range(12, 16):
        outs.append(t_ssm.mamba_decode(tp, x[:, t:t + 1], st, tcfg))
    _close(torch.cat(outs, 1), whole.numpy())
    _close(st["conv"], st_whole["conv"].numpy())
    _close(st["ssm"], st_whole["ssm"].numpy())


def test_state_plan_keeps_conv_in_model_dtype():
    cfg = t_reduced(t_get_config("jamba_v0_1_52b"))
    plan = t_ssm.mamba_state_plan(cfg, 4)
    assert plan["conv"].dtype == cfg.dtype == "bfloat16"
    assert plan["conv"].shape == (4, 2 * cfg.d_model, 3)
    assert plan["ssm"].dtype == "float32"
    assert plan["ssm"].shape == (4, 2 * cfg.d_model, cfg.mamba.d_state)
    plan32 = t_ssm.mamba_state_plan(cfg.replace(dtype="float32"), 4)
    assert plan32["conv"].dtype == "float32"


# -------------------------------------------------------------------- moe
def _moe_params(jcfg, spec, seed):
    return jax_init(jax_moe.moe_plan(jcfg, spec), jax.random.key(seed))


def _dropped(tp, x, spec):
    """(token, choice) pairs over capacity, counted from the router."""
    tokens = x.reshape(-1, x.shape[-1])
    _, _, idx = t_moe.route(tp, tokens, spec)
    counts = torch.bincount(idx.reshape(-1), minlength=spec.num_experts)
    cap = t_moe._capacity(tokens.shape[0], spec)
    return int((counts - cap).clamp(min=0).sum())


def _moe_both(jcfg, tcfg, spec, jp, x):
    tp = _bridge(jp)
    jout, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), spec, jcfg, NO_POLICY)
    tout, taux = t_moe.moe_ffn(tp, torch.from_numpy(x), spec, tcfg)
    _close(tout, jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    return tp


@pytest.mark.parametrize("b,s", [(2, 24), (8, 1)], ids=["prefill", "decode"])
def test_moe_matches_jax(b, s):
    jcfg, tcfg = _cfgs()
    spec = jcfg.moe
    x = np.random.default_rng(9).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    _moe_both(jcfg, tcfg, tcfg.moe, _moe_params(jcfg, spec, 1), x)


def test_moe_matches_jax_when_capacity_drops_pairs():
    """A router skewed toward expert 0 sends every token's first choice
    there: 48 tokens x 2 choices on 4 experts at capacity 30 drop at least
    18 pairs; the same pairs are dropped (a stable sort, the same slots),
    so the outputs still agree."""
    jcfg, tcfg = _cfgs()
    spec = jcfg.moe
    jp = dict(_moe_params(jcfg, spec, 2))
    router = np.asarray(jp["router"]).copy()
    router[:, 0] = 0.05
    jp["router"] = jnp.asarray(router)
    x = (np.random.default_rng(10).standard_normal((2, 24, jcfg.d_model))
         + 1.0).astype(np.float32)
    tp = _moe_both(jcfg, tcfg, tcfg.moe, jp, x)
    assert t_moe._capacity(48, tcfg.moe) == 30
    assert _dropped(tp, torch.from_numpy(x), tcfg.moe) >= 18


def test_moe_shared_expert_matches_jax():
    """DeepSeek-V2's MoE (reduced: 4 routed experts of top-2 and one
    shared expert computed densely on every token)."""
    jcfg, tcfg = _cfgs("deepseek_v2_236b")
    spec = jcfg.moe
    assert spec.num_shared_experts == 1
    x = np.random.default_rng(11).standard_normal(
        (1, 20, jcfg.d_model)).astype(np.float32)
    tp = _moe_both(jcfg, tcfg, tcfg.moe, _moe_params(jcfg, spec, 3), x)
    assert "shared_wi" in tp


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "mixtral_8x7b"])
def test_plans_match_jax_at_full_width(arch):
    """Same leaf names, shapes, dtypes and init as the JAX model plan, and
    the same cache plan (the conv state takes the model dtype, bf16 here,
    so equal too)."""
    def flat(plan):
        return [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype)
                + ((l.init, l.fan_in) if hasattr(l, "init") else ())
                for p, l in jax.tree_util.tree_flatten_with_path(
                    plan, is_leaf=lambda x: hasattr(x, "shape"))[0]]
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    assert flat(t_model.model_plan(tcfg)) == flat(
        jax_model.model_plan(jcfg))
    assert flat(t_model.cache_plan(tcfg, 8, 2048)) == flat(
        jax_model.cache_plan(jcfg, 8, 2048, NO_POLICY))
