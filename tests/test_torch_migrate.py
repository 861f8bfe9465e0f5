"""The port's live lane migration (``serving/migrate.py``) on the CPU.

Within the port: a lane drained with ``ship_state=True`` from one paged
replica and imported into another lands with every pool leaf's bytes (f32,
bf16, and int8 codes with their scales), its chain digests and refcounts
intact; in float32 the merged run finishes token-identical to a fault-free
one.  A flipped byte of any page leaf, token or digest is always caught,
the destination is left untouched, and the lane recomputes token-
identically.  Shared prompt pages attach instead of copying, and the
planner prices a transfer as the reference's does.

Across frameworks: a lane exported from a JAX paged replica verifies and
imports into a port replica for f32, bf16 and int8 pools (same pool
layout, same bytes), and in f32 resumes token-identically; an f32 lane
exported by the port imports into a JAX replica the same way."""
import copy
from dataclasses import astuple

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models.model import Model as JaxModel
from repro.serving import migrate as jax_migrate
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import migrate as t_migrate
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.migrate import (LaneManifest, MigrationPlanner,
                                         PageImporter, _page_digest,
                                         _pool_leaves)
from repro_torch.serving.request import Request

ENGINE_KW = dict(max_slots=4, seq_cap=64, page_size=4, seed=0,
                 backend="paged", pool_pages=48, chunk_tokens=8,
                 attn_impl="ref")
POOLS = {"f32": ("float32", "auto"), "bf16": ("bfloat16", "auto"),
         "int8": ("float32", "int8")}


@pytest.fixture(scope="module")
def weights():
    """(dtype -> (JAX config, port config, JAX params, port params))."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = reduced(get_config("stablelm_3b")).replace(dtype=dtype)
        tcfg = t_reduced(t_get_config("stablelm_3b")).replace(dtype=dtype)
        jparams = JaxModel(jcfg).init(jax.random.key(0))
        out[dtype] = (jcfg, tcfg, jparams, params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


def port_engine(weights, pool):
    dtype, kv_dtype = POOLS[pool]
    _, tcfg, _, tparams = weights[dtype]
    return ServingEngine(tcfg, params=tparams, kv_dtype=kv_dtype,
                         device="cpu", **ENGINE_KW)


def jax_engine(weights, pool):
    dtype, kv_dtype = POOLS[pool]
    jcfg, _, jparams, _ = weights[dtype]
    return JaxEngine(jcfg, params=jparams, kv_dtype=kv_dtype, **ENGINE_KW)


def mk_req(cls, rid, prompt, max_new=6):
    return cls(req_id=rid, tenant="T1", prompt_len=len(prompt),
               max_new_tokens=max_new, arrival=0.0,
               prompt_tokens=np.asarray(prompt, np.int64))


def run_out(eng, t=0.0):
    while eng.has_work():
        t += 0.01
        eng.finalize_step(eng.step(), t, t - 0.01)
    return t


def step_n(eng, n, t=0.0):
    for _ in range(n):
        if not eng.has_work():
            break
        t += 0.01
        eng.finalize_step(eng.step(), t, t - 0.01)
    return t


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, n) for n in lens]


def fault_free(make, cls, ps):
    eng = make()
    reqs = [mk_req(cls, i, p) for i, p in enumerate(ps)]
    for r in reqs:
        assert eng.submit(r)
    run_out(eng)
    return {r.req_id: list(r.output_tokens) for r in reqs}


def pool_bytes(pools, pages):
    """Every leaf of the given pages as raw bytes, by leaf key."""
    out = []
    for page in pages:
        payload = {}
        for key, group, name, fld in _pool_leaves(pools):
            pool = pools[group][name][fld]
            sel = pool[:, page] if group == "period" else pool[page]
            if isinstance(sel, torch.Tensor):
                sel = (sel.view(torch.int16).numpy() if sel.dtype ==
                       torch.bfloat16 else sel.numpy())
            payload[key] = np.ascontiguousarray(np.asarray(sel))
        out.append(payload)
    return out


def assert_landed(man, dst_kv, dst_pools):
    entry = dst_kv.tables[man.req.req_id]
    assert entry.length == man.cache_tokens
    prev = b""
    for rec, payload in zip(man.pages, pool_bytes(dst_pools, entry.pages)):
        for key in rec.payload:
            assert np.ascontiguousarray(rec.payload[key]).tobytes() == \
                payload[key].tobytes(), key
        prev = _page_digest(prev, rec.tokens, payload)
        assert prev == rec.digest
    assert all(dst_kv.ref.get(p, 0) >= 1 for p in entry.pages)


# ----------------------------------------------------------- round trip
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_round_trip_within_the_port(weights, pool):
    ps = prompts(1, (13, 7, 19))
    src = port_engine(weights, pool)
    reqs = [mk_req(Request, i, p) for i, p in enumerate(ps)]
    for r in reqs:
        assert src.submit(r)
    t = step_n(src, 5)
    mans = src.drain_requests(ship_state=True)
    assert src.kv.reserved_pages == 0 and not src.kv.tables
    assert sum(m.warm for m in mans) >= 2
    dst = port_engine(weights, pool)
    imp = PageImporter(dst.runtime)
    for man in mans:
        assert imp.import_lane(man) == man.warm
        if not man.warm:
            assert dst.submit(man.req)
            continue
        assert any("scale" in k for k in man.pages[0].payload) == \
            (pool == "int8")
        assert_landed(man, dst.kv, dst.runtime.pools)
        assert man.req.generated == man.generated
    assert imp.verify_failures == 0
    run_out(dst, t)
    assert dst.kv.reserved_pages == 0
    assert all(r.done and len(r.output_tokens) == r.max_new_tokens
               for r in reqs)
    if pool == "f32":
        base = fault_free(lambda: port_engine(weights, pool), Request, ps)
        assert {r.req_id: list(r.output_tokens) for r in reqs} == base


# ---------------------------------------------- corruption -> recompute
def _warm_manifest(weights):
    prompt = prompts(7, (13,))[0]
    src = port_engine(weights, "int8")
    req = mk_req(Request, 0, prompt)
    assert src.submit(req)
    step_n(src, 4)
    (man,) = src.drain_requests(ship_state=True)
    assert man.warm and len(man.pages) >= 2
    return man, req, prompt


@pytest.mark.parametrize("seed", range(6))
def test_corrupted_byte_is_always_detected(weights, seed):
    """Flip one byte of a shipped page leaf, a token or a digest, drawn
    from ``seed``: the importer rejects the whole lane before a byte
    lands."""
    man, _, _ = _warm_manifest(weights)
    man = copy.deepcopy(man)
    rng = np.random.default_rng(seed)
    rec = man.pages[int(rng.integers(len(man.pages)))]
    kind = ("payload", "token", "digest")[seed % 3]
    if kind == "payload":
        keys = sorted(rec.payload)
        key = keys[int(rng.integers(len(keys)))]
        arr = np.array(rec.payload[key], copy=True)
        flat = arr.view(np.uint8).reshape(-1)
        flat[int(rng.integers(flat.size))] ^= 0xFF
        rec.payload[key] = arr
    elif kind == "token":
        toks = list(rec.tokens)
        toks[int(rng.integers(len(toks)))] ^= 1
        rec.tokens = tuple(toks)
    else:
        rec.digest = bytes(b ^ 0xFF for b in rec.digest)
    dst = port_engine(weights, "int8")
    before = [t.clone() for t in (dst.runtime.pools["period"]["sub0"]
                                  ["k"], dst.runtime.pools["period"]
                                  ["sub0"]["k_scale"])]
    imp = PageImporter(dst.runtime)
    assert imp.import_lane(man) is False
    assert imp.verify_failures == 1
    assert not dst.kv.tables and dst.kv.reserved_pages == 0
    assert not dst.runtime.sched.active and not dst.runtime.sched.prefilling
    after = (dst.runtime.pools["period"]["sub0"]["k"],
             dst.runtime.pools["period"]["sub0"]["k_scale"])
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_rejected_lane_recomputes_token_identically(weights):
    man, req, prompt = _warm_manifest(weights)
    base = fault_free(lambda: port_engine(weights, "int8"), Request,
                      [prompt])[0]
    bad = copy.deepcopy(man)
    key = sorted(bad.pages[0].payload)[0]
    arr = np.array(bad.pages[0].payload[key], copy=True)
    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
    bad.pages[0].payload[key] = arr
    dst = port_engine(weights, "int8")
    imp = PageImporter(dst.runtime)
    assert imp.import_lane(bad) is False
    assert dst.submit(req)                       # the recompute redrive
    run_out(dst)
    assert list(req.output_tokens) == base
    assert dst.kv.reserved_pages == 0


def test_import_attaches_shared_prefix_pages(weights):
    prompt = prompts(11, (12,))[0]               # 3 full pages of 4
    dst = port_engine(weights, "f32")
    primer = mk_req(Request, 100, prompt)
    assert dst.submit(primer)
    run_out(dst)
    assert dst.kv.prefix_index
    src = port_engine(weights, "f32")
    req = mk_req(Request, 0, prompt)
    assert src.submit(req)
    step_n(src, 4)
    (man,) = src.drain_requests(ship_state=True)
    imp = PageImporter(dst.runtime)
    assert imp.import_lane(man)
    assert imp.attached_pages >= 2
    assert imp.copied_pages == len(man.pages) - imp.attached_pages
    assert dst.kv.tables[0].shared_tokens == \
        imp.attached_pages * dst.kv.page_size
    run_out(dst)
    assert list(req.output_tokens) == list(primer.output_tokens)
    assert dst.kv.reserved_pages == 0


def test_planner_prices_as_the_reference():
    class _Fabric:
        pcie_capacity = 10e9

    class _Topo:
        def root_of(self, device):
            return device.split(":")[0]

    class _Ledger:
        def __init__(self, demand):
            self.demand = demand

        def root_demand(self, root):
            return self.demand.get(root, 0.0)

    def manifests(mod, req_cls):
        man = mod.LaneManifest(req=mk_req(req_cls, 0, np.arange(8)),
                               prompt_tokens=np.arange(8))
        man.cache_tokens = 8
        for i in range(3):
            man.pages.append(mod.PageRecord(
                src_page=i, tokens=(1, 2, 3, 4),
                payload={"k": np.zeros(250_000 + i, np.int8)}, digest=b"x"))
        cold = mod.LaneManifest(req=mk_req(req_cls, 1, np.arange(4)),
                                prompt_tokens=np.arange(4))
        return [man, cold]

    for demand in ({"h0": 8e9, "h1": 0.0}, {"h0": 50e9}, {}):
        for args in (("h0:g0", "h1:g0"), ("h1:g0", "h1:g1"), (None, None)):
            plans = [mod.MigrationPlanner(
                fabric=_Fabric(), topo=_Topo(), ledger=_Ledger(demand),
                min_frac=0.1, setup_s=0.005).price(manifests(mod, cls),
                                                   *args)
                for mod, cls in ((jax_migrate, JaxRequest),
                                 (t_migrate, Request))]
            assert astuple(plans[0]) == astuple(plans[1])
    plan = MigrationPlanner(fabric=_Fabric()).price(
        manifests(t_migrate, Request))
    assert (plan.lanes, plan.warm_lanes, plan.pages) == (2, 1, 3)
    assert plan.bandwidth == pytest.approx(10e9)


# ------------------------------------------------------ across frameworks
def _convert(man, mod, req_cls):
    """A manifest handed to the other framework's importer: the same
    fields, the request rebuilt as that framework's Request (what a wire
    transport would carry)."""
    r = man.req
    req = req_cls(req_id=r.req_id, tenant=r.tenant, prompt_len=r.prompt_len,
                  max_new_tokens=r.max_new_tokens, arrival=r.arrival,
                  slo_ms=r.slo_ms, prompt_tokens=r.prompt_tokens,
                  priority=r.priority)
    req.submitted, req.prefill_done = r.submitted, r.prefill_done
    return mod.LaneManifest(
        req=req, prompt_tokens=np.asarray(man.prompt_tokens, np.int64),
        prefilled=man.prefilled, generated=man.generated,
        output_tokens=list(man.output_tokens),
        decode_times=list(man.decode_times), last_token=man.last_token,
        prefix_hit=man.prefix_hit, chunks_done=man.chunks_done,
        cache_tokens=man.cache_tokens,
        pages=[mod.PageRecord(src_page=p.src_page, tokens=tuple(p.tokens),
                              payload=dict(p.payload), digest=p.digest)
               for p in man.pages])


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_jax_lane_imports_into_the_port(weights, pool):
    ps = prompts(3, (13, 9, 17))
    src = jax_engine(weights, pool)
    jreqs = [mk_req(JaxRequest, i, p) for i, p in enumerate(ps)]
    for r in jreqs:
        assert src.submit(r)
    t = step_n(src, 5)
    mans = src.drain_requests(ship_state=True)
    assert sum(m.warm for m in mans) >= 2
    dst = port_engine(weights, pool)
    imp = PageImporter(dst.runtime)
    treqs = []
    for jman in mans:
        man = _convert(jman, t_migrate, Request)
        treqs.append(man.req)
        if jman.warm:
            assert imp.import_lane(man)
            assert_landed(man, dst.kv, dst.runtime.pools)
        else:
            assert dst.submit(man.req)
    assert imp.verify_failures == 0
    assert imp.imported_lanes == sum(m.warm for m in mans)
    run_out(dst, t)
    assert dst.kv.reserved_pages == 0
    assert all(r.done for r in treqs)
    if pool == "f32":
        base = fault_free(lambda: jax_engine(weights, pool), JaxRequest, ps)
        assert {r.req_id: list(r.output_tokens) for r in treqs} == base


def test_port_lane_imports_into_jax(weights):
    ps = prompts(4, (13, 9, 17))
    src = port_engine(weights, "f32")
    treqs = [mk_req(Request, i, p) for i, p in enumerate(ps)]
    for r in treqs:
        assert src.submit(r)
    t = step_n(src, 5)
    mans = src.drain_requests(ship_state=True)
    assert sum(m.warm for m in mans) >= 2
    dst = jax_engine(weights, "f32")
    imp = jax_migrate.PageImporter(dst.runtime)
    jreqs = []
    for tman in mans:
        man = _convert(tman, jax_migrate, JaxRequest)
        jreqs.append(man.req)
        if tman.warm:
            assert imp.import_lane(man)
        else:
            assert dst.submit(man.req)
    assert imp.verify_failures == 0
    run_out(dst, t)
    base = fault_free(lambda: port_engine(weights, "f32"), Request, ps)
    assert {r.req_id: list(r.output_tokens) for r in jreqs} == base
    assert dst.kv.reserved_pages == 0


def test_dense_engines_ship_cold_manifests(weights):
    _, tcfg, _, tparams = weights["float32"]
    eng = ServingEngine(tcfg, params=tparams, backend="dense", max_slots=2,
                        seq_cap=64, device="cpu")
    reqs = [mk_req(Request, i, p) for i, p in enumerate(prompts(5, (9, 6)))]
    for r in reqs:
        assert eng.submit(r)
    step_n(eng, 2)
    mans = eng.drain_requests(ship_state=True)
    assert [m.req.req_id for m in mans] == [0, 1]
    assert all(isinstance(m, LaneManifest) and not m.warm for m in mans)
    assert all(r.generated == 0 and not r.output_tokens for r in reqs)
    assert eng.kv.reserved_pages == 0
