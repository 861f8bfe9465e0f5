"""DeepSeek-V2's multi-head latent attention (MLA) in the port against the
JAX package, on the same numpy inputs and bridged weights, in float32 at
the reduced widths (nope 32 + rope 16 per head, v 32, kv_lora 32):

* the full-width model and cache plans equal the JAX plans leaf for leaf,
  with and without ``REPRO_KV_INT8=1`` (the compressed cache is never
  quantized);
* ``mla_prefill`` (the flash kernel's plain version on the
  ``[nope | rope]`` rows, V zero-padded), ``build_mla_cache`` and the
  absorbed ``mla_decode`` equal JAX's to 1e-5 scaled;
* decode after a prefill equals the prefill of the longer sequence;
* the dense engine is token-identical to the JAX dense engine, with the
  reduced config and with DeepSeek-V2's dense first layer put back."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models.common import NO_POLICY
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as t_attn
from repro_torch.models import model as t_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.params import count_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

ARCH = "deepseek_v2_236b"
TOL = 1e-5


def _close(ours, theirs, tol=TOL):
    """tests/test_torch_models.py's tolerance: ``tol`` relative to the
    output's own scale."""
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), theirs,
                               rtol=tol, atol=tol * scale)


def _flat(plan):
    return [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype)
            + ((l.init, l.fan_in) if hasattr(l, "init") else ())
            for p, l in jax.tree_util.tree_flatten_with_path(
                plan, is_leaf=lambda x: hasattr(x, "shape"))[0]]


def _cfgs(keep_prefix=False):
    jcfg = reduced(get_config(ARCH)).replace(dtype="float32")
    tcfg = t_reduced(t_get_config(ARCH)).replace(dtype="float32")
    if keep_prefix:
        jcfg = jcfg.replace(prefix=get_config(ARCH).prefix)
        tcfg = tcfg.replace(prefix=t_get_config(ARCH).prefix)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs(keep_prefix=True)
    jparams = jax_model.Model(jcfg).init(jax.random.key(4))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _layer(params):
    """The first period layer's attention params (un-stacked)."""
    return jax.tree.map(lambda a: a[0], params["period"]["sub0"]["attn"])


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "kv-int8"])
def test_plans_match_jax_at_full_width(monkeypatch, int8):
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    jcfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    tplan = t_model.model_plan(tcfg)
    assert _flat(tplan) == _flat(jax_model.model_plan(jcfg))
    assert set(tplan["period"]["sub0"]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
    tcache = t_model.cache_plan(tcfg, 8, 2048)
    assert _flat(tcache) == _flat(jax_model.cache_plan(jcfg, 8, 2048,
                                                       NO_POLICY))
    leaf = tcache["period"]["sub0"]["self"]
    assert set(leaf) == {"ckv", "krope", "pos"}
    assert leaf["ckv"].shape == (59, 8, 2048, 512)
    assert leaf["krope"].dtype == "bfloat16"


# ---------------------------------------------------- the layer functions
def test_mla_prefill_cache_and_decode_match_jax(bridged):
    jcfg, tcfg, jparams, tparams = bridged
    jp, tp = _layer(jparams), jax.tree.map(lambda a: a[0], dict(
        tparams["period"]["sub0"]["attn"]))
    layer = tcfg.period[0]
    b, s, seq_cap, steps = 2, 37, 64, 10
    rng = np.random.default_rng(21)
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jout, (jckv, jkr) = jax_attn.mla_prefill(
        jp, jnp.asarray(x), jnp.asarray(pos), jcfg.period[0], jcfg,
        NO_POLICY)
    before = flash_kernel.launches
    tout, (tckv, tkr) = t_attn.mla_prefill(
        tp, torch.from_numpy(x), torch.from_numpy(pos), layer, tcfg)
    assert flash_kernel.launches == before      # the CPU runs the plain one
    _close(tout, jout)
    _close(tckv, jckv)
    _close(tkr, jkr)
    jcache = jax_attn.build_mla_cache(jckv, jkr, jnp.asarray(pos), seq_cap,
                                      NO_POLICY)
    tcache = t_attn.build_mla_cache(tckv, tkr, torch.from_numpy(pos),
                                    seq_cap)
    assert tcache["ckv"].shape == (b, seq_cap, tcfg.attn.kv_lora_rank)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name])
    ptr = tcache["ckv"].data_ptr()
    for i in range(steps):
        x1 = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
        p1 = np.array([s + i, s + 2 * i], np.int32)   # rows apart
        jout, jcache = jax_attn.mla_decode(jp, jnp.asarray(x1), jcache,
                                           jnp.asarray(p1), jcfg.period[0],
                                           jcfg, NO_POLICY)
        tout = t_attn.mla_decode(tp, torch.from_numpy(x1), tcache,
                                 torch.from_numpy(p1), layer, tcfg)
        _close(tout, jout)
    assert tcache["ckv"].data_ptr() == ptr      # written in place
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name])


def test_decode_after_prefill_equals_the_longer_prefill(bridged):
    """Decode of tokens 11 and 12 after a prefill of tokens 0..10 gives
    the logits of a prefill of 0..11 and 0..12, and matches JAX's.  The
    MoE's capacity is raised to the token count (a factor of experts /
    top_k), so a longer prefill drops no (token, expert) pair that a
    one-token decode keeps."""
    jcfg, tcfg, jparams, tparams = bridged
    no_drops = tcfg.moe.num_experts / tcfg.moe.top_k
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=no_drops))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                capacity_factor=no_drops))
    toks = np.random.default_rng(22).integers(0, tcfg.vocab_size, 13)
    tok = torch.from_numpy(toks).long()[None]
    logits, cache = t_model.prefill(tparams, tcfg, tok[:, :11], seq_cap=32)
    jlogits, jcache = jax_model.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks[None, :11], jnp.int32)},
        NO_POLICY, seq_cap=32)
    _close(logits, jlogits)
    for i in (11, 12):
        pos = torch.tensor([i], dtype=torch.int32)
        step = t_model.decode_step(tparams, tcfg, cache, tok[:, i], pos)
        jstep, jcache = jax_model.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[None, i], jnp.int32),
            jnp.asarray([i], jnp.int32), NO_POLICY)
        _close(step, jstep)
        full, _ = t_model.prefill(tparams, tcfg, tok[:, :i + 1])
        _close(step, full.numpy())


# ----------------------------------------------------------------- engine
TRACE = [(40, 4), (7, 8), (21, 2), (3, 6), (60, 3)]


def _serve(eng, cls, prompts):
    reqs = [cls(req_id=i, tenant="T1", prompt_len=n, max_new_tokens=mn,
                arrival=0.0,
                prompt_tokens=None if p is None else p.copy())
            for i, (p, (n, mn)) in enumerate(zip(prompts, TRACE))]
    for r in reqs:
        assert eng.submit(r)
    steps = 0
    while eng.has_work():
        eng.finalize_step(eng.step(), float(steps))
        steps += 1
        assert steps < 400, "engine did not converge"
    assert all(r.done for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("keep_prefix,drawn", [(False, False), (True, False),
                                               (True, True)],
                         ids=["reduced", "dense-first-layer",
                              "drawn-prompts"])
def test_dense_engine_token_identical_to_jax_engine(keep_prefix, drawn):
    """The JAX dense engine plans the compressed cache in bf16 even for a
    float32 config, and so does the port's: both round the prefill's rows
    into it and decode over the rounded rows."""
    jcfg, tcfg = _cfgs(keep_prefix)
    jparams = jax_model.Model(jcfg).init(jax.random.key(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(23)
    prompts = [None if drawn else rng.integers(0, tcfg.vocab_size, n)
               for n, _ in TRACE]
    kw = dict(max_slots=4, seq_cap=96, page_size=8, seed=0)
    jout = _serve(JaxEngine(jcfg, params=jparams, **kw), JaxRequest, prompts)
    teng = ServingEngine(tcfg, params=tparams, device="cpu", **kw)
    assert teng.cache["period"]["sub0"]["self"]["ckv"].dtype == torch.bfloat16
    tout = _serve(teng, Request, prompts)
    assert tout == jout
    assert all(len(o) == mn for o, (_, mn) in zip(tout, TRACE))
    assert teng.logits_finite
    assert teng.prefill_passes == len(TRACE)


def test_repeats_cut_keeps_the_dense_first_layer():
    """``serve --repeats 6`` cuts the MoE period of the published config
    and keeps its dense first layer: 7 layers of full width, the plan the
    JAX package counts (25.22 B parameters, 46.98 GiB in bf16)."""
    from repro.models.params import param_bytes
    full = t_get_config(ARCH)
    cut = serve_mod.with_repeats(full, 6)
    assert (cut.num_layers, cut.prefix, cut.attn, cut.moe) == (
        7, full.prefix, full.attn, full.moe)
    jplan = jax_model.model_plan(get_config(ARCH).replace(repeats=6))
    n = count_params(t_model.model_plan(cut))
    assert n == sum(int(np.prod(p.shape)) for p in jax.tree.leaves(
        jplan, is_leaf=lambda x: hasattr(x, "pspec")))
    assert round(n / 1e9, 2) == 25.22
    assert round(param_bytes(jplan) / 2**30, 2) == 46.98


def test_serve_cli_serves_and_paged_refuses(capsys):
    serve_mod.main(["--device", "cpu", "--arch", ARCH, "--requests", "2",
                    "--max-new", "3", "--qps", "50"])
    out = capsys.readouterr().out
    assert "completed 2/2" in out and "logits_finite=True" in out
    with pytest.raises(ValueError, match="paged backend does not support "
                                         "attention kind 'mla'"):
        serve_mod.serve(arch=ARCH, backend="paged", requests=1,
                        device="cpu", verbose=False)
