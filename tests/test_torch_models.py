"""The port's model pieces against their JAX twins on the same numpy inputs
and the same (bridged) weights, in float32 to 1e-5: rms_norm, RoPE, the
gated FFN (silu and tanh-gelu), int8 KV quantization, embedding, logits;
plus the weight bridge and the parameter plan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import model as jax_model
from repro.models.common import NO_POLICY
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import model as t_model
from repro_torch.models.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.models.params import count_params

TOL = 1e-5
RNG = np.random.default_rng(0)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close(ours, theirs, tol=TOL):
    """Agree to ``tol`` relative to the output's own scale: two f32
    libraries sum in different orders, so an element that cancels to near
    zero carries the rounding of its large terms."""
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), theirs,
                               rtol=tol, atol=tol * scale)


def test_rms_norm():
    x = RNG.standard_normal((3, 5, 64)).astype(np.float32)
    w = (0.1 * RNG.standard_normal(64)).astype(np.float32)
    _close(t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("hd,theta", [(64, 10_000.0), (80, 10_000.0),
                                      (128, 1_000_000.0)])
def test_rope(hd, theta):
    x = RNG.standard_normal((2, 7, 4, hd)).astype(np.float32)
    pos = RNG.integers(0, 4096, (2, 7)).astype(np.int32)
    # cos/sin of large f32 angles differ by an ulp of the angle between
    # the two libraries; scale the tolerance by the largest angle
    _close(t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tol=4096 * 1.2e-7 * 4)


def test_rope_small_positions():
    x = RNG.standard_normal((1, 9, 2, 80)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)[None]
    _close(t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gated_ffn(activation):
    d, ff = 32, 48
    x = RNG.standard_normal((2, 3, d)).astype(np.float32)
    w_in = (RNG.standard_normal((d, 2, ff)) / np.sqrt(d)).astype(np.float32)
    w_out = (RNG.standard_normal((ff, d)) / np.sqrt(ff)).astype(np.float32)
    _close(t_common.gated_ffn(torch.from_numpy(x), torch.from_numpy(w_in),
                              torch.from_numpy(w_out), activation),
           jax_common.gated_ffn(jnp.asarray(x), jnp.asarray(w_in),
                                jnp.asarray(w_out), activation, NO_POLICY))


def test_softcap():
    x = (30 * RNG.standard_normal((4, 9))).astype(np.float32)
    _close(t_common.softcap(torch.from_numpy(x), 50.0),
           jax_common.softcap(jnp.asarray(x), 50.0))
    assert t_common.softcap(torch.from_numpy(x), None) is not None


def test_quantize_kv_codes_within_one_scales_equal():
    x = (3 * RNG.standard_normal((6, 4, 80))).astype(np.float32)
    x[0, 0] = 0.0                        # all-zero row: the 1e-8 floor
    q_t, s_t = t_attn._quantize_kv(torch.from_numpy(x))
    q_j, s_j = jax_attn._quantize_kv(jnp.asarray(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.bfloat16
    diff = np.abs(q_t.numpy().astype(np.int32)
                  - np.asarray(q_j).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_array_equal(s_t.float().numpy(),
                                  np.asarray(s_j, np.float32))


def _bridged(cfg_name="stablelm_3b", **replace):
    jcfg = reduced(get_config(cfg_name)).replace(dtype="float32", **replace)
    tcfg = t_reduced(t_get_config(cfg_name)).replace(dtype="float32",
                                                     **replace)
    jparams = jax_model.Model(jcfg).init(jax.random.key(3))
    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_embed_tokens():
    jcfg, tcfg, jp, tp = _bridged()
    toks = RNG.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    _close(t_model.embed_tokens(tp, tcfg, torch.from_numpy(toks).long()),
           jax_model.embed_tokens(jp, jcfg, jnp.asarray(toks), NO_POLICY))


@pytest.mark.parametrize("tie,cap", [(False, None), (True, None),
                                     (False, 30.0)])
def test_logits(tie, cap):
    jcfg, tcfg, jp, tp = _bridged(tie_embeddings=tie,
                                  final_logit_softcap=cap)
    assert ("lm_head" in tp) == (not tie)
    h = RNG.standard_normal((1, 5, jcfg.d_model)).astype(np.float32)
    ours = t_model._logits(tp, tcfg, torch.from_numpy(h))
    assert ours.dtype == torch.float32
    _close(ours, jax_model._logits(jp, jcfg, jnp.asarray(h), NO_POLICY))


def test_dense_ffn_layer():
    jcfg, tcfg, jp, tp = _bridged()
    layer = jcfg.period[0]
    lp_j = jax.tree.map(lambda a: a[0], jp["period"]["sub0"])
    lp_t = {k: v for k, v in tp["period"]["sub0"].items()}
    lp_t = jax.tree.map(lambda a: a[0], lp_t)
    h = RNG.standard_normal((1, 4, jcfg.d_model)).astype(np.float32)
    ours = t_model._apply_ffn(lp_t, torch.from_numpy(h), layer, tcfg)
    theirs, _, _ = jax_model._apply_ffn(lp_j, jnp.asarray(h), layer, jcfg,
                                        NO_POLICY)
    _close(ours, theirs)


def test_plan_matches_jax_plan():
    """Same leaf names, shapes and dtypes as the JAX plan, at full width."""
    for arch in ("stablelm_3b", "olmo2_7b", "granite_3_8b", "rwkv6_1_6b"):
        jplan = jax_model.model_plan(get_config(arch))
        tplan = t_model.model_plan(t_get_config(arch))
        flat_j = jax.tree_util.tree_flatten_with_path(
            jplan, is_leaf=lambda x: hasattr(x, "shape"))[0]
        flat_t = jax.tree_util.tree_flatten_with_path(
            tplan, is_leaf=lambda x: hasattr(x, "shape"))[0]
        assert [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype, l.init,
                 l.fan_in) for p, l in flat_j] == \
            [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype, l.init,
              l.fan_in) for p, l in flat_t]


@pytest.mark.parametrize("arch", ["stablelm_3b", "rwkv6_1_6b"])
def test_cache_plan_matches_jax_plan(arch):
    """The dense decode cache: same leaves, shapes and dtypes as the JAX
    cache plan at full width, except the RWKV shift states, which take the
    model dtype (bf16 here, so equal too; see models/rwkv.py)."""
    jplan = jax_model.cache_plan(get_config(arch), 8, 2048, NO_POLICY)
    tplan = t_model.cache_plan(t_get_config(arch), 8, 2048)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jplan, is_leaf=lambda x: hasattr(x, "shape"))[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        tplan, is_leaf=lambda x: hasattr(x, "shape"))[0]
    assert [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype)
            for p, l in flat_j] == \
        [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype)
         for p, l in flat_t]


def test_model_init_from_generator_scales():
    cfg = t_reduced(t_get_config("stablelm_3b"))
    m = t_model.Model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    p = m.params
    assert p["embed"].dtype == torch.bfloat16
    assert p["final_norm"].dtype == torch.float32
    assert float(p["final_norm"].abs().max()) == 0.0
    # "small" init: std 0.02; scaled-normal: 1/sqrt(fan_in)
    assert abs(float(p["embed"].float().std()) - 0.02) < 2e-3
    w_out = p["period"]["sub0"]["ffn"]["w_out"].float()
    assert abs(float(w_out.std()) * np.sqrt(cfg.ffn.d_ff) - 1.0) < 0.05
    assert sum(t.numel() for t in m.parameters()) == count_params(m.plan)


def test_cuda_default_raises_without_a_card(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_reduced(t_get_config("stablelm_3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_model.Model(cfg)


def test_bridge_bf16_bits_exact():
    x = jnp.asarray(RNG.standard_normal((5, 7)), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    tree = params_from_numpy({"a": {"b": np.asarray(x)},
                              "c": np.arange(3, dtype=np.int32)},
                             device="cpu")
    assert tree["c"].dtype == torch.int32
    assert torch.equal(tree["a"]["b"], t)
