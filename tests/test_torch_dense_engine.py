"""The port's dense slot-cache engine against the JAX dense engine: the same
float32 reduced weights (bridged from JAX), the same traces, on the CPU.

Greedy output must be token-identical for reduced StableLM-3B (flash
prefill, slot-cache decode), reduced RWKV-6 1.6B (the WKV scan in
prefill and decode) and Jamba's whole 8-layer period at reduced widths
(Mamba through the selective scan, MoE with capacity drops in prefill,
one attention layer), including prompts the engines draw themselves; the
port's dense and paged backends must agree token for token; admission
(``POOL_EXHAUSTED``), ``drain_requests`` and the refusals match.

The JAX dense engine cannot decode RWKV-6 or Mamba in float32 as it
stands: its state plans keep RWKV's token-shift states and Mamba's conv
tail in bfloat16, and its decode step refuses to write float32 into them.
The port keeps them in the model dtype (the same for every bf16 config),
and these tests give the JAX engine the same plans in-process
(``jax_rwkv_f32_shift``, ``jax_mamba_f32_conv``)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
from repro.models.model import Model as JaxModel
from repro.models.params import P as JaxP
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.models import moe as t_moe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import POOL_EXHAUSTED, Request

# the trace of tests/test_torch_paged_runtime.py: (prompt_len, max_new)
TRACE = [(40, 4), (7, 8), (21, 2), (3, 6), (60, 3)]
ENGINE_KW = {"max_slots": 4, "seq_cap": 96, "page_size": 8, "seed": 0}


def _cfgs(arch):
    return (reduced(get_config(arch)).replace(dtype="float32"),
            t_reduced(t_get_config(arch)).replace(dtype="float32"))


@pytest.fixture(scope="module")
def stablelm():
    jcfg, tcfg = _cfgs("stablelm_3b")
    jparams = JaxModel(jcfg).init(jax.random.key(0))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = _cfgs("rwkv6_1_6b")
    jparams = JaxModel(jcfg).init(jax.random.key(1))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def jamba():
    """Reduced Jamba with its whole published 8-layer period (``reduced``
    keeps only its first two layers, both Mamba), in float32."""
    period = get_config("jamba_v0_1_52b").period
    jcfg, tcfg = _cfgs("jamba_v0_1_52b")
    jcfg, tcfg = jcfg.replace(period=period), tcfg.replace(period=period)
    jparams = JaxModel(jcfg).init(jax.random.key(2))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture
def jax_mamba_f32_conv(monkeypatch):
    """The JAX Mamba state plan with the conv tail in the model dtype."""
    orig = jax_ssm.mamba_state_plan

    def plan(cfg, batch, policy):
        p = orig(cfg, batch, policy)
        conv = p["conv"]
        return {**p, "conv": JaxP(conv.shape, dtype=cfg.dtype,
                                  init=conv.init, pspec=conv.pspec)}
    monkeypatch.setattr(jax_ssm, "mamba_state_plan", plan)


@pytest.fixture
def jax_rwkv_f32_shift(monkeypatch):
    """The JAX RWKV state plan with the shift states in the model dtype."""
    orig = jax_rwkv.rwkv_state_plan

    def plan(cfg, batch, policy):
        return {k: (JaxP(p.shape, dtype=cfg.dtype, init=p.init,
                         pspec=p.pspec) if k.startswith("shift") else p)
                for k, p in orig(cfg, batch, policy).items()}
    monkeypatch.setattr(jax_rwkv, "rwkv_state_plan", plan)


def engines(model, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = {**ENGINE_KW, **kw}
    return (JaxEngine(jcfg, params=jparams, backend="dense", **kw),
            ServingEngine(tcfg, params=tparams, backend="dense",
                          device="cpu", **kw))


def requests(specs, cls):
    """(req_id, prompt or None, prompt_len, max_new) -> requests."""
    return [cls(req_id=i, tenant="T1", prompt_len=n, max_new_tokens=mn,
                arrival=0.0,
                prompt_tokens=None if p is None else np.array(p))
            for i, p, n, mn in specs]


def drain(eng, max_steps=400):
    reports = []
    while eng.has_work():
        rep = eng.step()
        eng.finalize_step(rep, float(len(reports)))
        reports.append(rep)
        assert len(reports) < max_steps, "engine did not converge"
    return reports


def run_both(jeng, teng, specs):
    jreqs, treqs = requests(specs, JaxRequest), requests(specs, Request)
    for j, t in zip(jreqs, treqs):
        assert bool(jeng.submit(j)) == bool(teng.submit(t))
    return jreqs, treqs, drain(jeng), drain(teng)


def assert_same_tokens(jreqs, treqs):
    for j, t in zip(jreqs, treqs):
        assert j.done and t.done
        assert t.output_tokens == j.output_tokens, \
            f"req {t.req_id}: {t.output_tokens} != {j.output_tokens}"


def assert_no_leaks(eng):
    assert eng.kv.reserved_pages == 0 and not eng.kv.tables
    assert all(s is None for s in eng.slots) and not eng.queue


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("drawn", [False, True],
                         ids=["given-prompts", "drawn-prompts"])
def test_stablelm_dense_token_parity(stablelm, drawn):
    rng = np.random.default_rng(0)
    specs = [(i, None if drawn else rng.integers(0, 1024, n), n, mn)
             for i, (n, mn) in enumerate(TRACE)]
    jeng, teng = engines(stablelm)
    before = flash_kernel.launches
    jreqs, treqs, jreps, treps = run_both(jeng, teng, specs)
    assert_same_tokens(jreqs, treqs)
    assert [r.kind for r in treps] == [r.kind for r in jreps]
    assert [r.tokens for r in treps] == [r.tokens for r in jreps]
    # the CPU engine never reaches the CUDA kernel
    assert flash_kernel.launches == before
    assert teng.logits_finite
    assert teng.forward_passes == len(treps)
    assert teng.prefill_passes == len(TRACE)
    assert_no_leaks(teng)


@pytest.mark.parametrize("drawn", [False, True],
                         ids=["given-prompts", "drawn-prompts"])
def test_rwkv_dense_token_parity(rwkv, jax_rwkv_f32_shift, drawn):
    rng = np.random.default_rng(1)
    specs = [(i, None if drawn else rng.integers(0, 1024, n), n, mn)
             for i, (n, mn) in enumerate(TRACE)]
    jeng, teng = engines(rwkv)
    st = teng.cache["period"]["sub0"]["self"]
    assert st["shift_att"].dtype == torch.float32
    assert st["wkv"].shape == (1, 4, 8, 32, 32)
    before = wkv_kernel.launches
    jreqs, treqs, jreps, treps = run_both(jeng, teng, specs)
    assert_same_tokens(jreqs, treqs)
    assert [r.kind for r in treps] == [r.kind for r in jreps]
    assert wkv_kernel.launches == before
    assert teng.logits_finite
    assert_no_leaks(teng)


def test_jamba_dense_token_parity(jamba, jax_mamba_f32_conv, monkeypatch):
    """Jamba's period (7 Mamba layers, 4 MoE, 1 attention) through both
    dense engines.  The 90-token prompt overflows an expert's capacity in
    prefill (counted from the port's router), so dropped pairs must be
    the same pairs in both."""
    jcfg, tcfg, _, _ = jamba
    assert [l.mixer for l in tcfg.layer_specs()].count("mamba") == 7
    assert [l.ffn for l in tcfg.layer_specs()].count("moe") == 4
    over = []
    moe_ffn = t_moe.moe_ffn

    def counting(params, x, spec, cfg):
        tokens = x.reshape(-1, x.shape[-1])
        _, _, idx = t_moe.route(params, tokens, spec)
        load = torch.bincount(idx.reshape(-1), minlength=spec.num_experts)
        cap = t_moe._capacity(tokens.shape[0], spec)
        over.append(int((load - cap).clamp(min=0).sum()))
        return moe_ffn(params, x, spec, cfg)
    monkeypatch.setattr(t_moe, "moe_ffn", counting)
    rng = np.random.default_rng(2)
    trace = TRACE + [(90, 3)]
    specs = [(i, rng.integers(0, 1024, n), n, mn)
             for i, (n, mn) in enumerate(trace)]
    jeng, teng = engines(jamba)
    st = teng.cache["period"]["sub0"]["self"]
    assert st["conv"].dtype == torch.float32
    assert st["ssm"].shape == (1, 4, 512, 8)
    before = (scan_kernel.launches, flash_kernel.launches)
    jreqs, treqs, jreps, treps = run_both(jeng, teng, specs)
    assert_same_tokens(jreqs, treqs)
    assert [r.kind for r in treps] == [r.kind for r in jreps]
    assert (scan_kernel.launches, flash_kernel.launches) == before
    assert sum(over) > 0, "no prefill overflowed an expert's capacity"
    assert teng.logits_finite
    assert_no_leaks(teng)


def test_stablelm_dense_matches_paged(stablelm):
    """The port's two backends serve the same trace token-identically
    (the paged runtime's chunked mixed steps against whole-prompt
    prefill and slot-cache decode)."""
    _, tcfg, _, tparams = stablelm
    rng = np.random.default_rng(4)
    specs = [(i, rng.integers(0, 1024, n), n, mn)
             for i, (n, mn) in enumerate(TRACE)]
    out = {}
    for backend in ("dense", "paged"):
        eng = ServingEngine(tcfg, params=tparams, backend=backend,
                            chunk_tokens=16, attn_impl="ref", device="cpu",
                            **ENGINE_KW)
        reqs = requests(specs, Request)
        assert all(eng.submit(r) for r in reqs)
        reps = drain(eng)
        assert eng.forward_passes == len(reps)
        out[backend] = [r.output_tokens for r in reqs]
    assert out["dense"] == out["paged"]
    assert [len(o) for o in out["dense"]] == [mn for _, mn in TRACE]


# ------------------------------------------------------- slot cache state
def test_prefill_merges_into_its_slot_in_place(stablelm):
    """A prefill lands in its slot along axis 1 of the stacked period
    cache (not on the repeats axis), in the preallocated tensors, and
    touches no other slot."""
    _, teng = engines(stablelm)
    cache = teng.cache["period"]["sub0"]["self"]
    ptrs = {k: t.data_ptr() for k, t in cache.items()}
    teng.submit(Request(req_id=0, tenant="T1", prompt_len=5,
                        max_new_tokens=3, arrival=0.0,
                        prompt_tokens=np.arange(5)))
    teng.submit(Request(req_id=1, tenant="T1", prompt_len=9,
                        max_new_tokens=3, arrival=0.0,
                        prompt_tokens=np.arange(9)))
    for _ in range(2):
        teng.finalize_step(teng.step(), 0.0)
    assert {k: t.data_ptr() for k, t in cache.items()} == ptrs
    pos = cache["pos"]
    assert pos.shape == (1, 4, 96)
    assert pos[0, 0, :5].tolist() == list(range(5))
    assert pos[0, 1, :9].tolist() == list(range(9))
    assert (pos[0, 0, 5:] == -1).all() and (pos[0, 2:] == -1).all()
    assert float(cache["k"][0, 2:].abs().sum()) == 0
    teng.finalize_step(teng.step(), 0.0)          # one decode step
    assert int(pos[0, 0, 5]) == 5 and int(pos[0, 1, 9]) == 9
    drain(teng)


# -------------------------------------------------- admission and drain
def test_pool_exhausted_admission_matches(stablelm):
    """A small pool (2 slots x 32 tokens, 8-token pages): the same
    requests are admitted or refused with POOL_EXHAUSTED by both engines,
    and a refused request fits once the pool drains."""
    jeng, teng = engines(stablelm, max_slots=2, seq_cap=32)
    specs = [(i, None, n, mn) for i, (n, mn) in
             enumerate([(20, 4), (17, 8), (9, 2), (3, 4)])]
    jreqs, treqs = requests(specs, JaxRequest), requests(specs, Request)
    jout = [jeng.submit(r) for r in jreqs]
    tout = [teng.submit(r) for r in treqs]
    assert [(o.ok, o.reason, o.transient) for o in tout] == \
        [(o.ok, o.reason, o.transient) for o in jout]
    assert tout[2] == POOL_EXHAUSTED and tout[2].transient
    assert teng.kv.reserved_pages == jeng.kv.reserved_pages
    drain(jeng)
    drain(teng)
    assert bool(jeng.submit(jreqs[2])) and bool(teng.submit(treqs[2]))
    drain(jeng)
    drain(teng)
    assert_same_tokens(jreqs, treqs)


def test_exceeds_seq_cap_is_refused(stablelm):
    _, teng = engines(stablelm, max_slots=2, seq_cap=32)
    out = teng.submit(Request(req_id=0, tenant="T1", prompt_len=30,
                              max_new_tokens=3, arrival=0.0))
    assert not out and out.reason == "exceeds_seq_cap"


def test_drain_and_redrive_parity(stablelm):
    """``drain_requests`` mid-run hands back the same resident requests as
    the JAX engine, rolled to a restartable state, and releases every
    page; redriven, they finish token-identical to the JAX engine's."""
    rng = np.random.default_rng(3)
    specs = [(i, rng.integers(0, 1024, n), n, mn)
             for i, (n, mn) in enumerate(TRACE)]
    jeng, teng = engines(stablelm)
    jreqs, treqs = requests(specs, JaxRequest), requests(specs, Request)
    for j, t in zip(jreqs, treqs):
        assert jeng.submit(j) and teng.submit(t)
    for i in range(5):
        for eng in (jeng, teng):
            eng.finalize_step(eng.step(), float(i + 1))
    jdrained, tdrained = jeng.drain_requests(), teng.drain_requests()
    assert [r.req_id for r in tdrained] == [r.req_id for r in jdrained]
    assert tdrained and all(r.generated == 0 and not r.output_tokens
                            and r.slot == -1 for r in tdrained)
    assert_no_leaks(teng)
    assert teng.kv.used_pages == 0
    for j, t in zip(jdrained, tdrained):
        assert jeng.submit(j) and teng.submit(t)
    drain(jeng)
    drain(teng)
    assert_same_tokens(jreqs, treqs)


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,exc,match", [
    ({"kv_dtype": "int8"}, ValueError, "REPRO_KV_INT8"),
    ({"spec_k": 2}, ValueError, "spec_k"),
    ({"response_cache": True}, ValueError, "response cache"),
    ({"backend": "slots"}, ValueError, "unknown backend"),
])
def test_dense_refusals(stablelm, kw, exc, match):
    _, tcfg, _, tparams = stablelm
    with pytest.raises(exc, match=match):
        ServingEngine(tcfg, params=tparams, device="cpu",
                      **{"backend": "dense", **kw})


def test_int8_dense_cache_is_refused_by_name(stablelm, monkeypatch):
    _, tcfg, _, tparams = stablelm
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    with pytest.raises(NotImplementedError, match="A4"):
        ServingEngine(tcfg, params=tparams, backend="dense", device="cpu")
