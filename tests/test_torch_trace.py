"""The flight recorder (``serving/trace.py``, a copy of the reference's) on
the port's engines and harness, on the CPU.

``serve(trace_out=...)`` under ``det_timing`` + ``exact_tokens`` writes the
reference's Chrome trace event for event, and its segment-conservation
lint (``FlightRecorder.check``) holds; tracing off is token- and timing-
identical to tracing on; a real preemption on the port's paged engine
lands in the victim's timeline; and every method of the port's actuator
(and of its copy of the simulator) emits exactly one trace event, the
twin of ``tests/test_trace.py``'s lint.

A recorder with a clock gets the paged step's spans: its phases tile
``engine.step`` in order, the forward's phases tile ``step.forward``'s
inside, the spans around the forward are ``StepReport.compute_s``, the
counters count the lane-major call's padding, and with no tracer no
tracer method runs."""
import json

import numpy as np
import pytest

from repro.launch.serve import serve as jax_serve
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.obs import Tracer
from repro_torch.launch.serve import serve
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.serving.trace import FlightRecorder
from test_torch_harness import bridged_params

CFG = reduced(get_config("stablelm_3b")).replace(dtype="float32")


@pytest.mark.parametrize("kw", [
    dict(requests=8, qps=40.0, max_new=4, replicas=2, backend="paged",
         spec_k=2),
    dict(requests=6, qps=30.0, max_new=4, num_tenants=2, listen=True,
         door_queue=2, door_deadline_ms=5.0),
], ids=["paged-1x2-spec", "dense-2x1-listen"])
def test_chrome_trace_matches_the_reference(tmp_path, kw):
    kw = dict(kw, det_timing=True, exact_tokens=True, seed=0, verbose=False)
    ref = jax_serve(**kw, trace_out=str(tmp_path / "ref.json"))
    out = serve(**kw, trace_out=str(tmp_path / "port.json"),
                params=bridged_params(), device="cpu")
    ref_trace = json.loads((tmp_path / "ref.json").read_text())
    port_trace = json.loads((tmp_path / "port.json").read_text())
    assert len(port_trace["traceEvents"]) > 20
    assert port_trace == ref_trace
    assert out["trace"] == ref["trace"]
    names = [k for k in ref if k.startswith(("T", "L"))]
    for name in names:
        assert out[name]["outputs"] == ref[name]["outputs"]


def test_serve_tracing_off_is_token_and_timing_identical():
    kw = dict(requests=8, qps=40.0, max_new=4, replicas=2, backend="paged",
              det_timing=True, exact_tokens=True, seed=0, verbose=False,
              params=bridged_params(), device="cpu")
    on, off = serve(**kw, trace=True), serve(**kw)
    assert "trace" in on and "trace" not in off
    for key in ("outputs", "ttft_by_id", "itl_p99_ms", "completed"):
        assert on["T1"][key] == off["T1"][key]
    assert on["device"]["virtual_s"] == off["device"]["virtual_s"]


def _overcommitted_engine():
    # a pool of 6 pages x 4 tokens; two 16-token sequences need 8 pages
    return ServingEngine(CFG, max_slots=4, seq_cap=32, page_size=4, seed=0,
                         backend="paged", pool_pages=6, chunk_tokens=8,
                         attn_impl="ref", device="cpu")


def _drive(eng, reqs, tracer=None, dt=0.01):
    eng.tracer = tracer
    for r in reqs:
        assert eng.submit(r)
    t, steps = 0.0, 0
    while eng.has_work():
        eng.finalize_step(eng.step(), t + dt, t)
        t += dt
        steps += 1
        assert steps < 800


def test_real_paged_preemption_is_traced():
    rng = np.random.default_rng(11)
    rec = FlightRecorder()
    hi = Request(req_id=0, tenant="T1", prompt_len=8, max_new_tokens=8,
                 arrival=0.0, slo_ms=50.0, priority=2.0,
                 prompt_tokens=rng.integers(0, CFG.vocab_size, 8))
    lo = Request(req_id=1, tenant="T1", prompt_len=8, max_new_tokens=8,
                 arrival=0.0, priority=0.5,
                 prompt_tokens=rng.integers(0, CFG.vocab_size, 8))
    _drive(_overcommitted_engine(), [hi, lo], tracer=rec)
    rec.check()
    assert rec.finished == 2
    by_id = {s.req_id: s for s in rec.summaries["T1"]}
    assert by_id[1].preemptions >= 1 and by_id[0].preemptions == 0
    tls = {tl.req_id: tl for tl in rec.retained()}
    assert "preempted" in [ev.name for ev in tls[1].instants]
    assert [s for s in tls[1].segments
            if s.name == "prefill_chunk" and s.args.get("restart")]


def test_engine_tracing_off_is_token_and_timing_identical():
    def go(tracer):
        rng = np.random.default_rng(13)
        reqs = [Request(req_id=j, tenant="T1", prompt_len=8,
                        max_new_tokens=6, arrival=0.0,
                        priority=float(1 + (j % 2)),
                        prompt_tokens=rng.integers(0, CFG.vocab_size, 8))
                for j in range(3)]
        _drive(_overcommitted_engine(), reqs, tracer=tracer)
        return [(list(r.output_tokens), list(r.decode_times),
                 r.prefill_done, r.finished) for r in reqs]

    assert go(None) == go(FlightRecorder())


# ------------------------------------------------------------ actuator lint
def _protocol_methods():
    from repro_torch.core.controller import Actuator
    return sorted(n for n, v in vars(Actuator).items()
                  if not n.startswith("_") and callable(v))


def _lint_actuator(act, tracer, first, second):
    """Call every Actuator protocol method once; each must emit exactly
    one trace event, and action events carry their pause window."""
    from repro_torch.core.profiles import A100_MIG

    cur = act.ledger.slots_of(second)[0]
    target = next(s for s in act.ledger.free_slots()
                  if s.device != cur.device
                  and act.ledger.headroom_units(s.device) >= 2)
    calls = {
        "reconfigure": lambda: act.reconfigure(first, A100_MIG["3g.40gb"]),
        "move": lambda: act.move(second, target),
        "set_io_throttle": lambda: act.set_io_throttle("ETL", 3e8),
        "set_mps_quota": lambda: act.set_mps_quota(first, 0.7),
        "pin_cpu_away_from_irq":
            lambda: act.pin_cpu_away_from_irq(first),
        "free_slots": lambda: act.free_slots(),
        "headroom_units": lambda: act.headroom_units(cur.device),
        "migrate": lambda: act.migrate(first, 0, 1),
    }
    methods = _protocol_methods()
    assert set(calls) == set(methods)
    for name in methods:
        before = len(tracer.events)
        calls[name]()
        assert len(tracer.events) == before + 1, \
            f"{type(act).__name__}.{name} emitted " \
            f"{len(tracer.events) - before} trace events, expected 1"
        ev = tracer.events[-1]
        assert tracer.actions and tracer.actions[-1] is ev
        if name in ("reconfigure", "move", "migrate"):
            assert ev.ph == "X" and ev.dur > 0
        else:
            assert ev.ph == "i"


def test_every_actuator_method_emits_exactly_one_event():
    """Over the port's ``ClusterSim`` copy and its ``ServingActuator``
    with live paged engines (so ``migrate`` ships a real lane)."""
    from repro_torch.core.ledger import DeviceLedger
    from repro_torch.core.profiles import A100_MIG
    from repro_torch.core.tenancy import TenantRegistry
    from repro_torch.core.topology import make_p4d_cluster
    from repro_torch.serving.actuator import FabricState, ServingActuator
    from repro_torch.sim.cluster import ClusterSim
    from repro_torch.sim.params import SimParams

    reg = TenantRegistry.slo_fleet(2, 2)
    specs = tuple(reg)
    p = SimParams(duration_s=60.0, schedule=(), tenants=specs)
    sim_tracer = Tracer()
    sim = ClusterSim(p, tracer=sim_tracer)
    first, second = list(sim.lat)[:2]
    _lint_actuator(sim, sim_tracer, first, second)

    act_tracer = Tracer()
    topo = make_p4d_cluster(2)
    reg2 = TenantRegistry(specs)
    ledger = DeviceLedger.from_registry(
        topo, reg2, A100_MIG, home_devices=p.home_devices,
        ambient_units=p.ambient_units)
    engines = {s.name: [ServingEngine(CFG, max_slots=2, seq_cap=32,
                                      page_size=4, backend="paged",
                                      attn_impl="ref", device="cpu")
                        for _ in range(2)]
               for s in reg2.latency()}
    src = engines[first][0]
    assert src.submit(Request(req_id=0, tenant=first, prompt_len=9,
                              max_new_tokens=4, arrival=0.0))
    src.finalize_step(src.step(), 0.01, 0.0)
    act = ServingActuator(engines, FabricState(), topo, lambda: 5.0,
                          ledger=ledger, rng=np.random.default_rng(0),
                          tracer=act_tracer)
    _lint_actuator(act, act_tracer, first, second)
    (rec,) = act.migrations
    assert len(rec["warm"]) == 1 and rec["pages"] >= 2
    (ev,) = [e for e in act_tracer.actions if e.name == "migrate"]
    assert ev.args["warm"] == 1 and ev.args["pages"] == rec["pages"]


# ------------------------------------------------------------ step spans
STEP_PHASES = ["step.plan", "step.pack", "step.sync_in", "step.copy_in",
               "step.forward", "step.sync_out", "step.readback",
               "step.commit"]
LAYER_PHASES = ["fwd.qkv", "fwd.kv_write", "fwd.attention", "fwd.out",
                "fwd.ffn"]


def _mixed_requests(n=3, prompt_len=12, max_new=5, seed=17):
    rng = np.random.default_rng(seed)
    return [Request(req_id=j, tenant="T1", prompt_len=prompt_len,
                    max_new_tokens=max_new, arrival=0.0,
                    prompt_tokens=rng.integers(0, CFG.vocab_size,
                                               prompt_len))
            for j in range(n)]


def _clocked_run():
    """A paged engine served to the end under a recorder with a clock,
    each step stamped by the same clock; (engine, recorder, reports)."""
    import time
    eng = ServingEngine(CFG, max_slots=4, seq_cap=64, page_size=4, seed=0,
                        backend="paged", chunk_tokens=8, attn_impl="ref",
                        device="cpu")
    rec = FlightRecorder(clock=time.perf_counter)
    eng.tracer = rec
    for r in _mixed_requests():
        assert eng.submit(r)
    reports = []
    while eng.has_work():
        t0 = time.perf_counter()
        rep = eng.step()
        t1 = time.perf_counter()
        eng.finalize_step(rep, t1, t0)
        reports.append(rep)
        assert len(reports) < 200
    return eng, rec, reports


def test_step_spans_tile_the_step():
    eng, rec, reports = _clocked_run()
    assert len(rec.steps) == len(reports)
    assert {r.kind for r in reports} >= {"prefill", "mixed", "decode"}
    n_layers = len(eng.runtime._layers)
    root = own = 0.0
    for st in rec.steps:
        top = [(n, s, e) for n, s, e in zip(st.names, st.starts, st.ends)
               if n.startswith("step.")]
        assert [n for n, _, _ in top] == STEP_PHASES
        # the children run back to back from the step's start
        assert top[0][1] == st.t0
        for (_, _, e), (_, s, _) in zip(top, top[1:]):
            assert s == e
        assert top[-1][2] <= st.t1
        root += st.t1 - st.t0
        own += (st.t1 - st.t0) - sum(e - s for _, s, e in top)
        # the forward's phases, in order, back to back inside step.forward
        fwd = [(n, s, e) for n, s, e in zip(st.names, st.starts, st.ends)
               if n.startswith("fwd.")]
        assert [n for n, _, _ in fwd] == (
            ["fwd.embed"] + LAYER_PHASES * n_layers + ["fwd.logits"])
        for (_, _, e), (_, s, _) in zip(fwd, fwd[1:]):
            assert s == e
        (f0, f1), = [(s, e) for n, s, e in top if n == "step.forward"]
        assert f0 <= fwd[0][1] and fwd[-1][2] <= f1
        assert {"lanes", "rows", "lane_slots", "chunk_tokens"} <= set(st.args)
    assert own <= 0.05 * root
    # every finalize is a span of its step's record, on the same clock,
    # after the step; the tracer's event list gains nothing a step
    for st in rec.steps:
        (fin,) = [i for i, n in enumerate(st.names) if n == "engine.finalize"]
        assert st.starts[fin] >= st.t1 and st.ends[fin] >= st.starts[fin]
    assert not [ev for ev in rec.events if ev.name == "engine.finalize"]


def test_step_records_are_a_bounded_ring():
    import time
    rec = FlightRecorder(clock=time.perf_counter, max_steps=3)
    eng = ServingEngine(CFG, max_slots=4, seq_cap=64, page_size=4, seed=0,
                        backend="paged", chunk_tokens=8, attn_impl="ref",
                        device="cpu")
    _drive(eng, _mixed_requests(), tracer=rec)
    assert eng.forward_passes > 3
    assert len(rec.steps) == 3
    # the ring holds the last steps, each closed and finalized
    assert all(st.t1 is not None and st.total("engine.finalize") >= 0.0
               and "engine.finalize" in st.names for st in rec.steps)
    assert rec.steps[0].t0 < rec.steps[1].t0 < rec.steps[2].t0


def test_compute_spans_are_compute_s():
    _, rec, reports = _clocked_run()
    for st, rep in zip(rec.steps, reports):
        timed = sum(st.total(n) for n in ("step.copy_in", "step.forward",
                                          "step.sync_out"))
        assert abs(timed - rep.compute_s) < 1e-3
        # no drafts: a decode lane's one row commits one token
        assert st.args["rows"] == rep.tokens
        assert st.args["chunk_tokens"] == rep.prefill_tokens


def test_no_clock_records_no_step_spans():
    rec = FlightRecorder()
    _drive(_overcommitted_engine(), _mixed_requests(2), tracer=rec)
    assert not rec.steps and rec.events == []
    assert rec.finished == 2


def test_tracing_off_calls_no_tracer_method(monkeypatch):
    from repro_torch.core import obs
    from repro_torch.serving import trace

    def boom(*args, **kw):
        raise AssertionError("a tracer method ran with tracing off")
    for cls in (obs.Tracer, obs.StepSpans, trace.FlightRecorder):
        for name, v in list(vars(cls).items()):
            if callable(v):
                monkeypatch.setattr(cls, name, boom)
    eng = ServingEngine(CFG, max_slots=4, seq_cap=64, page_size=4, seed=0,
                        backend="paged", chunk_tokens=8, attn_impl="ref",
                        device="cpu")
    _drive(eng, _mixed_requests(2))
    assert eng.runtime._spans is None


@pytest.mark.parametrize("row_of,spec_k", [
    ([(0, 1), (1, 1), (2, 8)], 0),         # two decode lanes and a chunk
    ([(0, 1), (1, 1), (2, 1)], 0),         # decode alone: no pad slot
    ([(0, 3), (3, 1), (4, 5)], 2),         # drafts and a part chunk
    ([(0, 8), (8, 3)], 0),                 # two chunks, one short
], ids=["mixed", "decode", "spec", "chunks"])
def test_lane_slots_count_the_layout_padding(row_of, spec_k):
    import time

    from repro_torch.core.obs import StepSpans
    from repro_torch.serving.paged_runtime import (lane_major_layout,
                                                   lane_rows_bucket)
    eng = ServingEngine(CFG, max_slots=4, seq_cap=64, page_size=4, seed=0,
                        backend="paged", chunk_tokens=8, attn_impl="ref",
                        spec_k=spec_k, device="cpu")
    rt = eng.runtime
    n_rows = sum(n for _, n in row_of)
    t = 16
    positions = np.zeros(t, np.int32)
    for r0, n in row_of:
        positions[r0:r0 + n] = 4 + np.arange(n)
    tokens = np.ones(t, np.int32)
    bts = np.zeros((len(row_of), 4), np.int32)
    last_rows = np.array([r0 + n - 1 for r0, n in row_of], np.int32)
    rt._spans = StepSpans(time.perf_counter)
    rt._run_mixed(tokens, positions, n_rows, bts, last_rows, row_of)
    args = rt._spans.args
    q_len = lane_rows_bucket(max(n for _, n in row_of), spec_k, rt.chunk)
    _, scatter, _ = lane_major_layout(row_of, positions, q_len)
    pad = len(row_of) * q_len - np.unique(scatter[:n_rows]).size
    assert args["lanes"] == len(row_of) and args["rows"] == n_rows
    assert args["lane_slots"] - args["rows"] == pad


def test_first_token_splits_hold_live_and_finished_requests():
    _, rec, _ = _clocked_run()
    done = rec.first_token_splits()
    assert set(done) == {("T1", j) for j in range(3)}
    for segs in done.values():
        assert segs["prefill_chunk"] > 0 and segs.get("sched_queued", 0) >= 0
    # a request past its first token but not finished is still read
    eng = _overcommitted_engine()
    live = FlightRecorder()
    eng.tracer = live
    (req,) = _mixed_requests(1, prompt_len=6, max_new=6)
    assert eng.submit(req)
    t = 0.0
    while not req.generated:
        eng.finalize_step(eng.step(), t + 0.01, t)
        t += 0.01
    assert not live.summaries
    (segs,) = live.first_token_splits().values()
    assert abs(sum(segs.values()) - req.prefill_done) < 1e-9
