"""The port's int8 dense slot cache (``REPRO_KV_INT8=1``) against the JAX
package's, on the CPU: the same float32 reduced StableLM weights (bridged
from JAX), ``REPRO_KV_INT8=1`` set for both.

The cache plans and the prefill caches match leaf for leaf (int8 codes,
bf16 scales, positions), a decode step's logits agree to 1e-2 relative,
the dense engines stay token-identical on the paged runtime's trace, and
the twins of ``tests/test_kv_quant.py`` hold: quantized decode stays close
to the exact cache, and the int8 cache takes under 0.55 of the bf16
cache's bytes at the full-width decode shape."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES, get_config, reduced
from repro.models import model as jax_model
from repro.models.model import Model as JaxModel
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.models import model as t_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.params import plan_leaves
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

JCFG = reduced(get_config("stablelm_3b")).replace(dtype="float32")
TCFG = t_reduced(t_get_config("stablelm_3b")).replace(dtype="float32")
# the trace of tests/test_torch_dense_engine.py: (prompt_len, max_new)
TRACE = [(40, 4), (7, 8), (21, 2), (3, 6), (60, 3)]


@pytest.fixture
def kv_int8(monkeypatch):
    monkeypatch.setenv("REPRO_KV_INT8", "1")


@pytest.fixture(scope="module")
def weights():
    jparams = JaxModel(JCFG).init(jax.random.key(1))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_prefill_fills_the_int8_cache_as_the_reference(kv_int8, weights):
    jparams, tparams = weights
    rng = np.random.default_rng(2)
    toks = rng.integers(0, JCFG.vocab_size, (1, 23))
    _, jcache = jax_model.prefill(jparams, JCFG,
                                  {"tokens": jnp.asarray(toks, jnp.int32)},
                                  seq_cap=32)
    _, tcache = t_model.prefill(tparams, TCFG, torch.from_numpy(toks),
                                seq_cap=32)
    jl, tl = dict(_leaves(jcache)), dict(_leaves(tcache))
    assert sorted(jl) == sorted(tl)
    assert {k.rsplit("/", 1)[1] for k in tl} == {"k", "v", "k_scale",
                                                 "v_scale", "pos"}
    for key, t in tl.items():
        j = jl[key]
        assert str(t.dtype).split(".")[1] == str(j.dtype), key
        assert tuple(t.shape) == j.shape, key
        if key.endswith("pos"):
            np.testing.assert_array_equal(_np(t), _np(j))
        elif key.endswith("scale"):
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-2)
        else:
            # an int8 code may sit on a rounding edge of the two
            # frameworks' f32 products: off by one step at most
            assert np.abs(_np(t).astype(np.int32)
                          - _np(j).astype(np.int32)).max() <= 1, key


def test_int8_decode_logits_close_to_jax(kv_int8, weights):
    """A decode step through the int8 caches: the port's logits agree
    with the JAX package's to 1e-2 relative, and its cache leaves keep
    their dtypes and storage (written in place)."""
    jparams, tparams = weights
    rng = np.random.default_rng(3)
    toks = rng.integers(0, JCFG.vocab_size, (2, 12))
    _, jcache = jax_model.prefill(jparams, JCFG,
                                  {"tokens": jnp.asarray(toks[:, :11],
                                                         jnp.int32)},
                                  seq_cap=16)
    _, tcache = t_model.prefill(tparams, TCFG, torch.from_numpy(toks[:, :11]),
                                seq_cap=16)
    ptrs = {k: t.data_ptr() for k, t in _leaves(tcache)}
    jlg, _ = jax_model.decode_step(jparams, JCFG, jcache,
                                   jnp.asarray(toks[:, 11], jnp.int32),
                                   jnp.array([11, 11], jnp.int32))
    tlg = t_model.decode_step(tparams, TCFG, tcache,
                              torch.from_numpy(toks[:, 11]),
                              torch.tensor([11, 11], dtype=torch.int32))
    jlg, tlg = _np(jlg), _np(tlg)
    err = np.abs(tlg - jlg).max() / (np.abs(jlg).max() + 1e-6)
    assert err < 1e-2, f"relative logits error {err:.4f}"
    for k, t in _leaves(tcache):
        assert t.data_ptr() == ptrs[k], k
    assert tcache["period"]["sub0"]["self"]["k"].dtype == torch.int8
    assert tcache["period"]["sub0"]["self"]["k_scale"].dtype == \
        torch.bfloat16


def test_int8_dense_engine_token_parity(kv_int8, weights):
    """The port's dense engine over its int8 slot cache gives the JAX dense
    engine's tokens, request for request, with every slot-cache leaf
    (scales included) merged and written in place."""
    jparams, tparams = weights
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, JCFG.vocab_size, n), n, mn)
             for i, (n, mn) in enumerate(TRACE)]
    kw = {"max_slots": 4, "seq_cap": 96, "page_size": 8, "seed": 0}
    jeng = JaxEngine(JCFG, params=jparams, backend="dense", **kw)
    teng = ServingEngine(TCFG, params=tparams, backend="dense", device="cpu",
                         **kw)
    leaves = dict(_leaves(teng.cache))
    assert leaves["/period/sub0/self/k"].dtype == torch.int8
    assert leaves["/period/sub0/self/v_scale"].dtype == torch.bfloat16
    ptrs = {k: t.data_ptr() for k, t in leaves.items()}
    out = {}
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        reqs = [cls(req_id=i, tenant="T1", prompt_len=n, max_new_tokens=mn,
                    arrival=0.0, prompt_tokens=p.copy())
                for i, p, n, mn in specs]
        for r in reqs:
            assert eng.submit(r)
        steps = 0
        while eng.has_work():
            eng.finalize_step(eng.step(), float(steps))
            steps += 1
            assert steps < 400
        out[cls] = [r.output_tokens for r in reqs]
    assert out[Request] == out[JaxRequest]
    assert {k: t.data_ptr() for k, t in _leaves(teng.cache)} == ptrs
    assert teng.kv.reserved_pages == 0


def test_quantized_decode_close_to_exact(kv_int8, monkeypatch):
    """Twin of tests/test_kv_quant.py: the port's int8 cache decodes
    within 8% (relative, max |logit|) of its exact cache."""
    cfg = t_reduced(t_get_config("stablelm_3b"))
    model = t_model.Model(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)))
    _, cache = t_model.prefill(model.params, cfg, toks[:, :11], seq_cap=16)
    assert cache["period"]["sub0"]["self"]["k"].dtype == torch.int8
    lg_q = t_model.decode_step(model.params, cfg, cache, toks[:, 11],
                               torch.tensor([11], dtype=torch.int32))
    monkeypatch.delenv("REPRO_KV_INT8")
    _, cache_f = t_model.prefill(model.params, cfg, toks[:, :11], seq_cap=16)
    assert cache_f["period"]["sub0"]["self"]["k"].dtype == torch.bfloat16
    lg_f = t_model.decode_step(model.params, cfg, cache_f, toks[:, 11],
                               torch.tensor([11], dtype=torch.int32))
    err = (lg_q.float() - lg_f.float()).abs().max().item()
    ref = lg_f.float().abs().max().item() + 1e-6
    assert err / ref < 0.08, f"relative logits error {err / ref:.3f}"


def test_quantized_cache_halves_bytes(kv_int8, monkeypatch):
    """Twin of tests/test_kv_quant.py at the full-width decode_32k shape:
    int8 K/V plus bf16 scales take under 0.55 of the bf16 cache, and the
    port's plans hold the same leaves as the JAX package's."""
    from repro.models.common import NO_POLICY
    cfg = t_get_config("stablelm_3b")
    shape = INPUT_SHAPES["decode_32k"]
    batch, seq = shape.global_batch, shape.seq_len

    def nbytes(plan, pred, width):
        return sum(int(np.prod(p.shape)) * width for p in plan_leaves(plan)
                   if pred(p))

    plan = t_model.cache_plan(cfg, batch, seq)
    jplan = JaxModel(get_config("stablelm_3b")).cache_plan(batch, seq,
                                                           NO_POLICY)
    jleaves = jax.tree.leaves(jplan, is_leaf=lambda x: hasattr(x, "pspec"))
    assert [(p.shape, p.dtype) for p in plan_leaves(plan)] == \
        [(p.shape, p.dtype) for p in jleaves]
    kv = nbytes(plan, lambda p: p.dtype == "int8", 1)
    scales = nbytes(plan, lambda p: p.dtype == "bfloat16", 2)
    monkeypatch.delenv("REPRO_KV_INT8")
    kv_f = nbytes(t_model.cache_plan(cfg, batch, seq),
                  lambda p: p.dtype == "bfloat16", 2)
    assert kv + scales < 0.55 * kv_f
