"""The gateway (a copy of the reference's) in front of the port's engines:
the engine-facing tests of ``tests/test_gateway.py`` on real port engines
on the CPU.  Verdict conservation under churn, the client stream's ITLs
equal to the engine's metrics (with speculative bursts, and across
preemption restarts), ``warm_engine`` leaving no trace, the Prometheus
histograms aggregating across replicas, and serve()'s rejections at pool
exhaustion."""
import re

import numpy as np
import pytest

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.serve import serve, warm_engine
from repro_torch.serving.directory import PrefixDirectory, ResponseCache
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.gateway import DoorConfig, Gateway, Verdict
from repro_torch.serving.metrics import DEFAULT_BUCKETS
from repro_torch.serving.request import Request

CFG = reduced(get_config("stablelm_3b")).replace(dtype="float32")


def engine(**kw):
    kw = {"max_slots": 2, "seq_cap": 32, "device": "cpu", **kw}
    return ServingEngine(CFG, **kw)


def make_req(i, tenant="T1", arrival=0.0, prompt_len=8, max_new=3):
    return Request(req_id=i, tenant=tenant, prompt_len=prompt_len,
                   max_new_tokens=max_new, arrival=arrival)


def test_verdict_conservation_under_churn():
    """Random traffic, pauses, stepping and a mid-run tenant add over real
    engines (dense pools of 4 pages, a paged replica): the per-tenant
    ledger balances at every virtual-time step, and every offered request
    ends in exactly one terminal verdict."""
    rng = np.random.default_rng(7)
    pauses = {}
    engines = {"T1": [engine(), engine(max_slots=1)],
               "T2": [engine(backend="paged", seq_cap=32, pool_pages=4)]}
    gw = Gateway(engines,
                 default_cfg=DoorConfig(max_queue=4, deadline_s=2.0,
                                        max_attempts=2),
                 paused_until=lambda n: pauses.get(n, 0.0))
    now, i = 0.0, 0
    for _ in range(400):
        now += float(rng.exponential(0.05))
        op = int(rng.integers(5))
        if op == 0:
            for _ in range(int(rng.integers(1, 4))):
                name = str(rng.choice(sorted(engines)))
                gw.offer(make_req(i, name, arrival=now,
                                  max_new=int(rng.integers(1, 5))), now)
                i += 1
        elif op == 1:
            gw.dispatch(now)
        elif op == 2:
            name = str(rng.choice(sorted(engines)))
            for eng in engines[name]:
                if eng.has_work():
                    gw.finalize(name, eng, eng.step(), now)
        elif op == 3:
            name = str(rng.choice(sorted(engines)))
            pauses[name] = now + float(rng.exponential(0.2))
        elif op == 4 and "T9" not in engines:
            engines["T9"] = [engine()]           # tenant admitted mid-run
        gw.check()       # the invariant holds at every step, not just at end
    for _ in range(400):
        now += 0.1
        gw.dispatch(now)
        for name, engs in engines.items():
            for eng in engs:
                while eng.has_work():
                    gw.finalize(name, eng, eng.step(), now)
        gw.check()
        if gw.queued_total() == 0 and \
                all(not e.has_work() for es in engines.values() for e in es):
            break
    assert i > 100                       # the trace actually offered load
    for door in gw.doors.values():
        assert door.in_flight == 0
        assert door.offered == door.completed + door.rejected + \
            door.shed + door.expired
        assert all(v in (Verdict.REJECTED, Verdict.SHED, Verdict.EXPIRED,
                         Verdict.COMPLETED) for v in door._state.values())
    total = {k: sum(d.counters()[k] for d in gw.doors.values())
             for k in ("completed", "rejected", "shed", "expired")}
    assert total["completed"] > 0
    assert total["rejected"] + total["shed"] + total["expired"] > 0


def _drain_through_gateway(eng, reqs):
    gw = Gateway({"T1": [eng]}, door_cfgs={"T1": DoorConfig(max_queue=64)})
    for r in reqs:
        assert gw.offer(r, 0.0) is Verdict.ACCEPTED
    gw.dispatch(0.0)
    t, preempted = 0.0, 0
    while eng.has_work():
        t += 0.01
        rep = eng.step()
        preempted += len(rep.preempted)
        gw.finalize("T1", eng, rep, t)
    gw.check()
    return gw.door("T1"), preempted


@pytest.mark.parametrize("spec_k", [0, 3])
def test_stream_itl_matches_metrics(spec_k):
    """The client-visible stream measures exactly the ITLs the engine
    records, including speculative bursts (same-step tokens, zero gap)."""
    eng = engine(max_slots=4, seq_cap=64, backend="paged", spec_k=spec_k)
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, tenant="T1", prompt_len=pl,
                    max_new_tokens=mn, arrival=0.0,
                    prompt_tokens=rng.integers(0, CFG.vocab_size, pl))
            for i, (pl, mn) in enumerate([(40, 4), (7, 8), (21, 2), (3, 6)])]
    door, _ = _drain_through_gateway(eng, reqs)
    assert door.completed == len(reqs)
    all_gaps = []
    for r in reqs:
        st = door.streams[r.req_id]
        assert st.first_time == r.prefill_done
        assert [ts for _, ts in st.events[1:]] == r.decode_times
        assert [tok for tok, _ in st.events] == r.output_tokens
        assert st.gaps == pytest.approx(r.itls)
        all_gaps.extend(st.gaps)
    itl_samples = [v for _, v in eng.metrics.itl.samples]
    assert sorted(all_gaps) == pytest.approx(sorted(itl_samples))


def test_stream_rolls_back_across_preemption():
    """A page pool too small for every lane forces SLO-aware preemption;
    the preempted requests' streams roll back, keep their pre-preemption
    gaps (the metrics window keeps its samples too) and end on the tokens
    the engine finally delivered."""
    eng = engine(max_slots=4, seq_cap=64, backend="paged", pool_pages=9,
                 page_size=8)
    rng = np.random.default_rng(1)
    reqs = [Request(req_id=i, tenant="T1", prompt_len=pl,
                    max_new_tokens=mn, arrival=0.0, slo_ms=slo,
                    prompt_tokens=rng.integers(0, CFG.vocab_size, pl))
            for i, (pl, mn, slo) in enumerate(
                [(30, 12, 400.0), (20, 12, 100.0), (25, 10, 300.0),
                 (18, 12, 50.0)])]
    door, preempted = _drain_through_gateway(eng, reqs)
    assert preempted > 0
    assert door.completed == len(reqs)
    all_gaps = []
    for r in reqs:
        st = door.streams[r.req_id]
        n = len(r.output_tokens)
        assert [tok for tok, _ in st.events[-(n - 1):]] == \
            r.output_tokens[1:]
        assert st.events[0][0] == r.output_tokens[0]
        all_gaps.extend(st.gaps)
    itl_samples = [v for _, v in eng.metrics.itl.samples]
    assert sorted(all_gaps) == pytest.approx(sorted(itl_samples))


def test_warm_engine_leaves_no_trace():
    """The req_id=-1 warm request leaves no metrics sample, response-cache
    entry or published directory page behind, and the wiring comes back."""
    rc = ResponseCache()
    eng = engine(seq_cap=64, backend="paged", response_cache=rc)
    directory = PrefixDirectory(page_size=16)
    directory.attach("T1", 0, eng.kv)
    warm_engine(eng, "T1", prompt_len=48)
    m = eng.metrics
    assert m.latency.total == 0 and m.itl.total == 0
    assert m.engine_ttft.total == 0
    assert m.prefill_tokens_total == 0 and m.drafted_tokens_total == 0
    assert m.response_cache_lookups == 0
    assert eng.runtime.sched.rc_lookups == 0
    assert eng.runtime.sched.rc_hits == 0
    assert len(rc) == 0
    assert directory.stats.published == 0
    assert eng.kv.listener is not None
    assert eng.runtime.sched.response_cache is rc
    assert eng.queue is eng.runtime.sched.waiting


def test_prometheus_histograms_aggregate_across_replicas():
    """The ``le`` buckets sum element-wise across a tenant's replica
    engines, stay monotone, and ``_count`` is the all-time total."""
    e1, e2 = engine(), engine(backend="paged", seq_cap=32)
    gw = Gateway({"T1": [e1, e2]})
    e1.metrics.latency.observe(0.0, 0.003)   # -> le 0.005
    e1.metrics.latency.observe(1.0, 0.05)    # -> le 0.05 (edge-inclusive)
    e2.metrics.latency.observe(0.5, 0.3)     # -> le 0.4, other replica
    text = gw.prometheus()
    rows = dict(re.findall(
        r'gateway_door_ttft_seconds_bucket\{tenant="T1",le="([^"]+)"\}'
        r' (\S+)', text))
    assert rows["0.0025"] == "0"
    assert rows["0.005"] == "1"
    assert rows["0.05"] == "2"
    assert rows["0.4"] == "3"
    assert rows["+Inf"] == "3"
    vals = [float(rows[f"{le:g}"]) for le in DEFAULT_BUCKETS]
    assert vals == sorted(vals)
    assert 'gateway_door_ttft_seconds_count{tenant="T1"} 3' in text
    assert 'gateway_door_ttft_seconds_sum{tenant="T1"} 0.353' in text
    assert 'gateway_active_lanes{tenant="T1"} 0' in text


def test_serve_counts_rejections_at_pool_exhaustion():
    """Burst traffic into a 1-slot dense engine exhausts the prompt+max_new
    page reservation; every failed submit surfaces as a REJECTED verdict
    (after one requeue), and the ledger balances."""
    out = serve(requests=10, qps=500.0, slots=1, max_new=16,
                with_controller=False, verbose=False, device="cpu")
    t = out["T1"]
    assert t["offered"] == 10
    assert t["offered"] == t["completed"] + t["shed"] + t["rejected"] \
        + t["expired"]
    assert t["rejected"] > 0
    assert t["reject_reasons"].get("pool_exhausted") == t["rejected"]
    assert 'gateway_offered_total{tenant="T1"} 10' in out["prometheus"]
    for v in ("completed", "rejected", "shed", "expired"):
        assert f'gateway_verdict_total{{tenant="T1",verdict="{v}"}}' \
            in out["prometheus"]
