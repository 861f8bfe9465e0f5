"""The port's paged serving engine against the JAX paged engine: the same
float32 reduced StableLM weights (bridged from JAX), the same traces, on
the CPU.  Greedy output must be token-identical on the mixed trace, a
prefix-cache hit, forced preemption and speculative lanes (spec_k=3); with
int8 page pools the first step's logits agree to 1e-2 relative."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models.model import Model as JaxModel
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.paged_attention import kernel as tkernel
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged_runtime import (lane_major_layout,
                                               lane_rows_bucket)
from repro_torch.serving.request import Request

JCFG = reduced(get_config("stablelm_3b")).replace(dtype="float32")
TCFG = t_reduced(t_get_config("stablelm_3b")).replace(dtype="float32")
# the trace of tests/test_paged_runtime.py: (prompt_len, max_new_tokens)
TRACE = [(40, 4), (7, 8), (21, 2), (3, 6), (60, 3)]


@pytest.fixture(scope="module")
def weights():
    jparams = JaxModel(JCFG).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jparams, tparams


def engines(weights, **kw):
    kw = {"max_slots": 4, "seq_cap": 96, "page_size": 8, "seed": 0,
          "chunk_tokens": 16, "attn_impl": "ref", **kw}
    jparams, tparams = weights
    return (JaxEngine(JCFG, params=jparams, backend="paged", **kw),
            ServingEngine(TCFG, params=tparams, backend="paged", device="cpu",
                          **kw))


def twin_requests(specs):
    """The same requests for both engines: (req_id, prompt, max_new, kw)."""
    return ([JaxRequest(req_id=i, tenant="T1", prompt_len=len(p),
                        max_new_tokens=mn, arrival=0.0,
                        prompt_tokens=np.array(p), **kw)
             for i, p, mn, kw in specs],
            [Request(req_id=i, tenant="T1", prompt_len=len(p),
                     max_new_tokens=mn, arrival=0.0,
                     prompt_tokens=np.array(p), **kw)
             for i, p, mn, kw in specs])


def drain(eng, max_steps=800):
    reports = []
    while eng.has_work():
        rep = eng.step()
        eng.finalize_step(rep, float(len(reports)))
        reports.append(rep)
        assert len(reports) < max_steps, "engine did not converge"
    return reports


def run_both(jeng, teng, specs):
    jreqs, treqs = twin_requests(specs)
    for j, t in zip(jreqs, treqs):
        assert bool(jeng.submit(j)) == bool(teng.submit(t))
    return jreqs, treqs, drain(jeng), drain(teng)


def assert_same_tokens(jreqs, treqs):
    for j, t in zip(jreqs, treqs):
        assert j.done and t.done
        assert t.output_tokens == j.output_tokens, \
            f"req {t.req_id}: {t.output_tokens} != {j.output_tokens}"


def assert_no_leaks(eng):
    kv = eng.kv
    assert kv.used_pages == 0 and kv.reserved_pages == 0 and not kv.tables
    assert len(kv.free) + kv.cached_pages == kv.num_pages


# ----------------------------------------------------------------- parity
def test_token_parity_on_mixed_trace(weights):
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, JCFG.vocab_size, pl), mn, {})
             for i, (pl, mn) in enumerate(TRACE)]
    jeng, teng = engines(weights)
    before = tkernel.launches
    jreqs, treqs, jreps, treps = run_both(jeng, teng, specs)
    assert_same_tokens(jreqs, treqs)
    assert any(r.kind == "mixed" for r in treps)
    assert [r.kind for r in treps] == [r.kind for r in jreps]
    assert [r.tokens for r in treps] == [r.tokens for r in jreps]
    # the CPU engine never reaches the CUDA kernel
    assert tkernel.launches == before
    assert teng.runtime.logits_finite
    assert teng.runtime.forward_passes == len(treps)
    assert_no_leaks(teng)


def test_prefix_hit_parity(weights):
    rng = np.random.default_rng(21)
    toks = rng.integers(0, JCFG.vocab_size, 40)     # 4 shareable pages
    jeng, teng = engines(weights)
    cold = run_both(jeng, teng, [(1, toks, 6, {})])
    warm = run_both(jeng, teng, [(2, toks, 6, {})])
    for jreqs, treqs, _, _ in (cold, warm):
        assert_same_tokens(jreqs, treqs)
    assert warm[1][0].output_tokens == cold[1][0].output_tokens
    assert teng.metrics.prefix_hit_tokens_total == 32
    assert teng.metrics.prefix_hit_tokens_total == \
        jeng.metrics.prefix_hit_tokens_total
    assert teng.metrics.prefill_tokens_total == 48
    assert_no_leaks(teng)


def test_forced_preemption_parity(weights):
    """An overcommitted pool (6 pages x 4 tokens, two 16-token sequences)
    preempts the low-priority request; both engines evict the same lane
    and regenerate the same tokens."""
    rng = np.random.default_rng(11)
    specs = [(0, rng.integers(0, JCFG.vocab_size, 8), 8,
              dict(slo_ms=50.0, priority=2.0)),
             (1, rng.integers(0, JCFG.vocab_size, 8), 8,
              dict(priority=0.5))]
    jeng, teng = engines(weights, seq_cap=32, page_size=4, pool_pages=6,
                         chunk_tokens=8)
    jreqs, treqs, _, _ = run_both(jeng, teng, specs)
    assert_same_tokens(jreqs, treqs)
    tlog = teng.runtime.sched.preempt_log
    assert tlog, "overcommitted pool never preempted"
    assert tlog == jeng.runtime.sched.preempt_log
    assert_no_leaks(teng)


def test_spec_k3_parity_with_replay_hints(weights):
    """Speculative lanes (spec_k=3) replaying a cold run's output as hints:
    multi-token bursts are accepted and the output stays token-identical
    to the JAX engine's (and to non-speculative decode)."""
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, JCFG.vocab_size, pl) for pl in (40, 7, 21)]
    max_new = [6, 8, 5]
    jcold, tcold = engines(weights)
    cold = run_both(jcold, tcold, [(i, p, mn, {}) for i, (p, mn)
                                   in enumerate(zip(prompts, max_new))])
    assert_same_tokens(cold[0], cold[1])
    jeng, teng = engines(weights, spec_k=3)
    specs = [(i, p, mn, dict(draft_hints=np.array(r.output_tokens)))
             for i, (p, mn, r) in enumerate(zip(prompts, max_new, cold[1]))]
    jreqs, treqs, _, _ = run_both(jeng, teng, specs)
    assert_same_tokens(jreqs, treqs)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in cold[1]]
    assert teng.metrics.accepted_tokens_total > 0
    assert teng.metrics.drafted_tokens_total == \
        jeng.metrics.drafted_tokens_total
    assert teng.metrics.accepted_tokens_total == \
        jeng.metrics.accepted_tokens_total
    assert_no_leaks(teng)


def test_drain_and_redrive_parity_with_tracer_hook(weights):
    """``drain_requests`` mid-run releases every page and hands back the
    same resident requests as the JAX engine, rolled to a restartable
    state; redriven, they finish token-identical to the JAX engine's.  The
    tracer hook sees every finalized step."""
    class Recorder:
        def __init__(self):
            self.steps = []

        def on_step(self, report, start, end, engine=""):
            self.steps.append((report.kind, start, end, engine))

    rng = np.random.default_rng(3)
    specs = [(i, rng.integers(0, JCFG.vocab_size, pl), mn, {})
             for i, (pl, mn) in enumerate(TRACE)]
    jeng, teng = engines(weights)
    teng.tracer = Recorder()
    jreqs, treqs = twin_requests(specs)
    for j, t in zip(jreqs, treqs):
        assert jeng.submit(j) and teng.submit(t)
    for i in range(3):
        for eng in (jeng, teng):
            eng.finalize_step(eng.step(), float(i + 1), start_time=float(i))
    assert [s[1:] for s in teng.tracer.steps] == \
        [(0.0, 1.0, "paged"), (1.0, 2.0, "paged"), (2.0, 3.0, "paged")]
    jdrained, tdrained = jeng.drain_requests(), teng.drain_requests()
    assert [r.req_id for r in tdrained] == [r.req_id for r in jdrained]
    assert tdrained and all(r.generated == 0 and not r.output_tokens
                            for r in tdrained)
    assert_no_leaks(teng)
    for j, t in zip(jdrained, tdrained):
        assert jeng.submit(j) and teng.submit(t)
    drain(jeng)
    treps = drain(teng)
    assert_same_tokens(jreqs, treqs)
    assert len(teng.tracer.steps) == 3 + len(treps)
    assert_no_leaks(teng)


# ---------------------------------------------------------- int8 and pools
def _first_step_logits(eng, req):
    rt = eng.runtime
    captured = {}
    orig = rt._run_mixed

    def wrap(*args):
        logits, dt = orig(*args)
        captured["logits"] = logits
        return logits, dt

    rt._run_mixed = wrap
    try:
        assert eng.submit(req)
        eng.finalize_step(eng.step(), 0.0)
    finally:
        rt._run_mixed = orig
    lg = captured["logits"]
    return np.asarray(lg.numpy() if isinstance(lg, torch.Tensor) else lg,
                      np.float32)


def test_int8_pool_logits_close_to_jax(weights):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, JCFG.vocab_size, 12)
    jeng, teng = engines(weights, max_slots=2, seq_cap=32, kv_dtype="int8")
    pool = teng.runtime.pools["period"]["sub0"]
    assert pool["k"].dtype == torch.int8
    assert pool["k_scale"].dtype == torch.float32
    jreqs, treqs = twin_requests([(0, toks, 2, {})])
    lg_j = _first_step_logits(jeng, jreqs[0])[0]
    lg_t = _first_step_logits(teng, treqs[0])[0]
    err = np.max(np.abs(lg_t - lg_j))
    assert err / (np.max(np.abs(lg_j)) + 1e-6) < 1e-2
    assert int(lg_t.argmax()) == int(lg_j.argmax())


def test_kv_scatter_writes_the_stacked_pool_in_place(weights):
    """The per-layer views the runtime scatters into alias the stacked
    pools: after one prefill step the pages the request holds carry K/V in
    the stacked tensor itself, and the trash page only ever sees pad rows."""
    _, teng = engines(weights)
    rt = teng.runtime
    stacked = rt.pools["period"]["sub0"]["k"]
    ptr = stacked.data_ptr()
    rng = np.random.default_rng(5)
    req = Request(req_id=0, tenant="T1", prompt_len=12, max_new_tokens=2,
                  arrival=0.0, prompt_tokens=rng.integers(0, 64, 12))
    assert teng.submit(req)
    teng.finalize_step(teng.step(), 0.0)
    assert stacked.data_ptr() == ptr
    pages = rt.kv.tables[0].pages
    assert float(stacked[0, pages[0]].abs().sum()) > 0
    assert float(stacked[0, pages[1], :4].abs().sum()) > 0
    assert float(stacked[0, pages[1], 4:].abs().sum()) == 0
    drain(teng)


def test_dense_backend_and_cuda_default_refused(weights, monkeypatch):
    """The dense backend (the default, as in the reference) constructs and
    serves; asking for the card without one is refused."""
    eng = ServingEngine(TCFG, params=weights[1], device="cpu")
    assert eng.backend == "dense" and eng.runtime is None
    req = Request(req_id=0, tenant="T1", prompt_len=9, max_new_tokens=3,
                  arrival=0.0)
    assert eng.submit(req)
    reps = drain(eng)
    assert [r.kind for r in reps] == ["prefill", "decode", "decode"]
    assert len(req.output_tokens) == 3 and eng.logits_finite
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(TCFG, params=weights[1])


# ------------------------------------------------------ lane-major call
def test_lane_rows_bucket():
    assert [lane_rows_bucket(n, 3, 16) for n in (1, 2, 4, 5, 16, 17)] == \
        [1, 4, 4, 16, 16, 17]
    assert [lane_rows_bucket(n, 0, 16) for n in (1, 2, 16)] == [1, 16, 16]


def _check_layout(positions, n_rows, row_of, q_len):
    """Every live packed row maps to one (lane, slot) of its own lane and
    back; every other slot of a lane is a pad slot at position 0 that reads
    its lane's first row."""
    gather, scatter, qpos = lane_major_layout(row_of, positions, q_len)
    assert gather.shape == (len(row_of) * q_len,)
    assert qpos.shape == (len(row_of), q_len)
    live = set()
    for lane, (r0, n) in enumerate(row_of):
        for i in range(q_len):
            slot = lane * q_len + i
            if i < n:
                assert gather[slot] == r0 + i
                assert scatter[r0 + i] == slot
                assert qpos[lane, i] == positions[r0 + i]
                live.add(r0 + i)
            else:
                assert gather[slot] == r0 and qpos[lane, i] == 0
    assert live == set(range(n_rows))
    assert (scatter[n_rows:] == 0).all()


def test_lane_major_packing_maps_rows_to_lane_slots_and_back(weights,
                                                             monkeypatch):
    """Through real steps of a speculative engine (spec_k=3, replay hints)
    with a prefix hit: decode lanes of 1 + len(draft) rows, chunk lanes,
    pad packed rows and pad lane slots all map one to one."""
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, JCFG.vocab_size, pl) for pl in (40, 7, 21)]
    _, cold = engines(weights)
    creqs = twin_requests([(i, p, 6, {}) for i, p in enumerate(prompts)])[1]
    for r in creqs:
        assert cold.submit(r)
    drain(cold)
    _, teng = engines(weights, spec_k=3)
    rt = teng.runtime
    seen = []
    orig = rt._run_mixed

    def wrap(tokens, positions, n_rows, bts, last_rows, row_of):
        q_len = lane_rows_bucket(max(n for _, n in row_of), 3, rt.chunk)
        _check_layout(positions, n_rows, row_of, q_len)
        assert bts.shape[0] == len(row_of)
        seen.append((tokens.shape[0], n_rows, [n for _, n in row_of], q_len))
        return orig(tokens, positions, n_rows, bts, last_rows, row_of)

    monkeypatch.setattr(rt, "_run_mixed", wrap)
    specs = [(i, p, 6, dict(draft_hints=np.array(r.output_tokens)))
             for i, (p, r) in enumerate(zip(prompts, creqs))]
    specs.append((3, prompts[0], 6, {}))            # a prefix hit on req 0
    treqs = twin_requests(specs)[1]
    for r in treqs[:3]:
        assert teng.submit(r)
    drain(teng)
    assert teng.submit(treqs[3])
    drain(teng)
    assert teng.metrics.prefix_hit_tokens_total > 0
    rows = [n for _, _, lanes, _ in seen for n in lanes]
    assert any(1 < n <= 4 for _, _, lanes, q in seen for n in lanes
               if q == 4), "no speculative decode lane"
    assert any(n > 4 for n in rows), "no chunk lane"
    assert any(t > n for t, n, _, _ in seen), "no pad packed rows"
    assert any(q > min(lanes) for _, _, lanes, q in seen), "no pad slots"
    assert [r.output_tokens for r in treqs[:3]] == \
        [r.output_tokens for r in creqs]


def test_lane_major_call_equals_row_major_call():
    """The plain paged attention called lane-major (the runtime's shape)
    gives every live packed row the context the row-major call (one row
    per lane, the JAX runtime's shape) gives it, to 1e-6 in f32."""
    from repro_torch.kernels.paged_attention.ops import paged_attention_mixed
    rng = np.random.default_rng(9)
    page, width, kv, g, hd, npages = 8, 6, 2, 3, 16, 40
    row_of, positions, tables = [], [], []
    row = 0
    # decode lanes with 1 and 1 + 3 draft rows, a chunk, a prefix-hit chunk
    for n, start in ((1, 30), (4, 12), (16, 0), (9, 20)):
        row_of.append((row, n))
        positions.extend(start + np.arange(n))
        tables.append(rng.permutation(npages)[:width])
        row += n
    n_rows = row
    t = 32                                          # the row bucket
    positions = np.array(positions + [0] * (t - n_rows), np.int32)
    bts = np.stack(tables).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((t, kv * g, hd)).astype(
        np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (npages, page, kv, hd)).astype(np.float32)) for _ in range(2))
    q_len = lane_rows_bucket(16, 3, 16)
    gather, scatter, lane_qpos = lane_major_layout(row_of, positions, q_len)
    ql = q[torch.from_numpy(gather)].reshape(len(row_of), q_len, kv * g, hd)
    lane_ctx = paged_attention_mixed(
        ql, kp, vp, torch.from_numpy(bts), torch.from_numpy(lane_qpos),
        impl="ref").reshape(-1, kv * g, hd)[torch.from_numpy(scatter)]
    row_bts = np.zeros((t, width), np.int32)
    for lane, (r0, n) in enumerate(row_of):
        row_bts[r0:r0 + n] = bts[lane]
    row_ctx = paged_attention_mixed(
        q[:, None], kp, vp, torch.from_numpy(row_bts),
        torch.from_numpy(positions[:, None].copy()), impl="ref")[:, 0]
    np.testing.assert_allclose(lane_ctx[:n_rows].numpy(),
                               row_ctx[:n_rows].numpy(), rtol=1e-6,
                               atol=1e-6)
