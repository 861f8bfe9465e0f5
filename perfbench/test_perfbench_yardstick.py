"""The yardstick's counts against small cases worked by hand, the tail
arithmetic over every request (a missing first token censored at the
window's close), and the trace arithmetic: each device record paired with
its host launch, and the device trace read over whole steps alone."""
from __future__ import annotations

import json
import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import harness, stats, traffic, yardstick
from perfbench.harness import Context, ReqRec, StepRec
from perfbench.references import dense_gqa

M = {"hidden_size": 8, "num_attention_heads": 4, "num_key_value_heads": 2,
     "head_dim": 2, "intermediate_size": 16, "num_hidden_layers": 3,
     "vocab_size": 100}


def test_percentile_and_spread():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    for q in (0, 25, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / 3.0)


def test_step_flops_by_hand():
    # a decode lane at position 9 (10 keys) and a chunk of 3 rows at
    # positions 4, 5, 6 (5 + 6 + 7 keys); 2 logit rows
    positions = np.array([9, 4, 5, 6, 0, 0])
    row_of = [(0, 1), (1, 3)]
    per_row = 2 * (8 * 4 * 2 + 2 * 8 * 2 * 2 + 4 * 2 * 8 + 3 * 8 * 16) * 3
    attn = 4 * 4 * 2 * (10 + 5 + 6 + 7) * 3
    assert yardstick.step_flops(dense_gqa, M, positions, row_of, 2) == \
        4 * per_row + attn + 2 * 2 * 8 * 100


def test_paged_attention_counts_a_shared_page_once():
    positions = np.array([20, 17])            # two decode lanes
    row_of = [(0, 1), (1, 1)]
    tables = np.array([[7, 3, 0], [7, 5, 0]])  # page 7 shared
    flops, nbytes = yardstick.paged_attention_call(M, positions, row_of,
                                                   tables, page_size=16)
    page = 2 * 16 * 2 * 2 * 2                  # K and V, 2 heads of 2, bf16
    assert flops == 4 * 4 * 2 * (21 + 18)
    assert nbytes == 3 * page + 2 * 2 * 4 * 2 * 2
    pk = {"bf16_flops": 1e3, "hbm_bytes_s": 1e3}
    assert yardstick.roofline_s(flops, nbytes, pk) == max(flops, nbytes) / 1e3


def test_union_gaps_and_families():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 10)]
    assert yardstick.busy_union(iv) == 6
    assert yardstick.idle_gaps(iv) == [(3, 5), (7, 9)]
    assert yardstick.family("void paged_attention_tc_kernel<...>") == \
        "paged_attention"
    assert yardstick.family("nvjet_tst_128x192") == "matmul"
    assert yardstick.family("vectorized_elementwise_kernel") == \
        "elementwise/other"


def _req(rid, due, emits, finished=None, refused=False, warm=False):
    src = traffic.BenchRequest(rid, due, np.zeros(32, np.int32), 8, warm)
    return ReqRec(src, refused=refused, emits=list(emits), finished=finished)


def _ctx(reqs, steps=()):
    return Context(kind=dense_gqa, model=M, page_size=16, w0=10.0, w1=20.0,
                   steps=list(steps),
                   reqs={r.src.rid: r for r in reqs}, setup_s=3.0,
                   slo={"ttft_ms": 200, "mean_gap_ms": 100}, peak=None,
                   trace=None)


def test_tails_over_every_request_with_censoring():
    reqs = [_req(0, 10.5, [10.6, 10.65, 10.7], finished=10.7),
            _req(1, 19.0, []),                       # censored at the close
            _req(2, 12.0, [], refused=True),         # censored too
            _req(3, 5.0, [5.1, 10.2, 10.3]),         # due before the window
            _req(4, 11.0, [0.0], warm=True)]
    ctx = _ctx(reqs)
    ttft = [0.1, 1.0, 8.0]
    assert harness.load_metric("ttft_p50_ms")(ctx) == pytest.approx(
        1e3 * np.percentile(ttft, 50))
    gaps = [0.05, 0.05, 10.2 - 5.1, 0.1]            # ends inside the window
    assert harness.load_metric("itl_p95_ms")(ctx) == pytest.approx(
        1e3 * np.percentile(gaps, 95))
    assert harness.load_metric("output_tok_s")(ctx) == pytest.approx(5 / 10)
    # due up to 19.8: request 0 meets both limits, 1 and 2 miss
    assert harness.load_metric("slo_attain_pct")(ctx) == pytest.approx(
        100 / 3)


def test_slo_counts_the_open_gap_of_an_unfinished_request():
    slow = _req(0, 19.0, [19.1, 19.15])      # open gap to 20.0: mean 0.45
    fast = _req(1, 19.0, [19.1, 19.15, 19.2, 19.3], finished=19.3)
    assert harness.load_metric("slo_attain_pct")(_ctx([slow, fast])) == 50.0


def test_host_share_and_prefix_hits():
    pos = np.array([5])
    steps = [StepRec(10.0, 10.1, 0.08, 16, pos, [(0, 1)], np.zeros((1, 1)),
                     [0], [0]),
             StepRec(10.1, 10.2, 0.09, 0, pos, [(0, 1)], np.zeros((1, 1)),
                     [1], [1])]
    reqs = [_req(0, 10.0, []), _req(1, 10.0, [])]
    ctx = _ctx(reqs, steps)
    assert harness.load_metric("engine_host_pct")(ctx) == pytest.approx(15.0)
    assert harness.load_metric("prefix_hit_pct")(ctx) == pytest.approx(
        100 * 16 / 64)
    assert harness.load_metric("mfu_pct")(ctx) is None      # no card
    assert harness.load_metric("device_idle_pct")(ctx) is None
    peak = {"bf16_flops": 1e9, "hbm_bytes_s": 1e9}
    with_card = Context(**dict(vars(ctx), peak=peak))
    flops = 2 * dense_gqa.flops(M, 1, 6, 1)
    assert harness.load_metric("mfu_pct")(with_card) == pytest.approx(
        100 * flops / (0.2 * 1e9))


def test_a_variant_metric_is_read_by_its_base_reader():
    base = harness.load_metric("mfu_pct")
    variant = harness.load_metric("mfu_pct.prefill")
    assert variant.__code__.co_code == base.__code__.co_code
    assert not (harness.BENCH / "metrics" / "mfu_pct.prefill.py").exists()
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"])), m["name"]


def test_pages_read_counts_each_page_once():
    pos = np.array([20, 17])
    tables = np.array([[7, 3, 9], [7, 5, 9]])  # page 9 beyond both lanes
    steps = [StepRec(0.0, 0.1, 0.0, 0, pos, [(0, 1), (1, 1)], tables,
                     [0, 1], []),
             StepRec(0.1, 0.2, 0.0, 0, np.array([3]), [(0, 1)],
                     np.array([[4, 0, 0]]), [0], [])]
    assert harness.pages_read(steps, 16) == 4       # 7, 3, 5 and 4


def test_idle_counts_each_traced_step_at_its_kinds_unprofiled_wall():
    pos = np.zeros(8, np.int64)
    decode = dict(positions=pos, row_of=[(0, 1), (1, 1)],
                  block_tables=np.zeros((2, 1)), lanes=[0, 1], admitted=[])
    chunk = dict(decode, row_of=[(0, 1), (1, 6)])
    window = [StepRec(0.0, 0.05, 0.0, 0, **decode),
              StepRec(0.0, 0.07, 0.0, 0, **decode),
              StepRec(0.0, 0.20, 0.0, 0, **chunk)]
    traced = [StepRec(0.0, 0.5, 0.0, 0, **chunk),
              StepRec(0.0, 0.5, 0.0, 0, **decode)]
    # 0.15 s busy of a 0.20 s chunk step, 0.03 s of a 0.06 s decode step
    got = yardstick.idle_pct([0.15, 0.03], traced, window)
    assert got == pytest.approx(100 * (1 - 0.18 / 0.26))
    assert yardstick.idle_pct([0.1], traced[:1], window[:2]) is None


# ------------------------------------------- the trace, paired step by step
CPU_, CUDA_ = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
PK = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}
_DECODE = dict(positions=np.array([20, 17]), row_of=[(0, 1), (1, 1)],
               block_tables=np.array([[7, 3, 0], [7, 5, 0]]), lanes=[0, 1],
               admitted=[])
_CHUNK = dict(_DECODE, positions=np.array([22, 4, 5, 6]),
              row_of=[(0, 1), (1, 3)])
# the window's unprofiled steps, of both kinds
WINDOW = [StepRec(0.0, 0.0009, 0.0, 0, **_DECODE),
          StepRec(0.0, 0.0011, 0.0, 0, **_DECODE),
          StepRec(0.0, 0.0020, 0.0, 0, **_CHUNK)]


def _ev(name, s, e, cid=0, device=False, annotation=False):
    return SimpleNamespace(name=name, id=cid, device_type=CUDA_ if device
                           else CPU_, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=s, end=e))


def _trace(keep=range(4), drop=(), unlaunched=(), split=(),
           no_device_forward=(), lost_before=0):
    """Profiler events of 4 traced steps of 3 layers, a step i at 1,000 i
    microseconds: the host's labels, a copy in, per layer a launch of a
    matmul, a paged-attention and an elementwise kernel inside
    ``model.forward``, a readback kernel after it, each launch paired by
    its id with its device record, and the forward's range on the device.
    ``keep``: the steps traced; ``drop`` / ``unlaunched``: the (step,
    call) whose device record / host launch the trace lost; ``split``:
    steps whose attention call is two kernels; ``no_device_forward``:
    steps whose device range of ``model.forward`` is missing;
    ``lost_before``: launches before the first step whose records the
    trace lost."""
    events = [_ev("cudaLaunchKernel", -500.0 + 10 * k, -496.0 + 10 * k,
                  1000 + k) for k in range(lost_before)]
    traced = []
    cid = 0
    for i in keep:
        t = 1000.0 * i
        events += [_ev("sched.plan", t, t + 50),
                   _ev("runtime.run_mixed", t + 60, t + 900),
                   _ev("model.forward", t + 100, t + 800)]
        calls = [("cudaMemcpyAsync", t + 70, "Memcpy HtoD (Pageable -> "
                  "Device)", t + 75, 5)]
        for layer in range(3):
            t0 = t + 100 + 200 * layer
            calls.append(("cudaLaunchKernel", t0, "nvjet_tst_128x192",
                          t0 + 30, 40))
            if i in split:
                calls += [("cudaLaunchKernelExC", t0 + 20,
                           "paged_attention_split_kernel", t0 + 70, 30),
                          ("cuLaunchKernel", t0 + 25,
                           "paged_attention_combine_kernel", t0 + 100, 20)]
            else:
                calls.append(("cudaLaunchKernel", t0 + 20,
                              "paged_attention_tc_kernel", t0 + 70, 50))
            calls.append(("cudaLaunchKernel", t0 + 40,
                          "vectorized_elementwise_kernel", t0 + 120, 10))
        calls.append(("cudaLaunchKernel", t + 850, "reduce_argmax_kernel",
                      t + 855, 5))
        for k, (launch, lt, kernel, ks, kd) in enumerate(calls):
            cid += 1
            if (i, k) not in unlaunched:
                events.append(_ev(launch, lt, lt + 4, cid))
            if (i, k) not in drop:
                events.append(_ev(kernel, ks, ks + kd, cid, device=True))
        if i not in no_device_forward:
            events.append(_ev("model.forward", t + 130, t + 630,
                              device=True, annotation=True))
        start = 50.0 + 0.001 * i
        traced.append(StepRec(start, start + 0.0009, 0.0, 0,
                              **(_CHUNK if i == 2 else _DECODE)))
    return events, traced


def _read(trace):
    ctx = Context(kind=dense_gqa, model=M, page_size=16, w0=0.0, w1=1.0,
                  steps=WINDOW, reqs={}, setup_s=1.0, slo={}, peak=PK,
                  trace=trace)
    return {"roofline": harness.load_metric("paged_attention_roofline")(ctx),
            "idle": harness.load_metric("device_idle_pct")(ctx),
            "families": trace["families"]}


def _today(events, traced):
    """The readings as the parent read them: every device record, and each
    step's busy time from the forward's range on the device."""
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in events if e.device_type == CUDA_
               and e.name not in harness.LABELS]
    forwards = sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == CUDA_ and e.name == "model.forward")
    iv = [(s, e) for _, s, e in kernels]
    per_step = ([yardstick.busy_union([(s, e) for s, e in iv
                                       if f0 <= s < f1]) / 1e6
                 for f0, f1 in forwards]
                if len(forwards) == len(traced) else None)
    fam = {}
    for name, s, e in kernels:
        fam[yardstick.family(name)] = (fam.get(yardstick.family(name), 0.0)
                                       + (e - s) / 1e6)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == CPU_
                   and e.name in harness.LABELS)
    gaps = {}
    for g0, g1 in yardstick.idle_gaps(iv):
        inside = [sp for sp in spans if sp[0] <= g0 < sp[1]]
        name = (min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside
                else "engine.step or loop")
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6
    attn = sum(e - s for name, s, e in kernels
               if yardstick.family(name) == "paged_attention") / 1e6
    bound = sum(M["num_hidden_layers"] * yardstick.roofline_s(
        *yardstick.paged_attention_call(M, st.positions, st.row_of,
                                        st.block_tables, 16), PK)
        for st in traced)
    return {"roofline": 100.0 * bound / attn,
            "idle": (yardstick.idle_pct(per_step, traced, WINDOW)
                     if per_step else None),
            "families": fam, "gaps": gaps,
            "busy_s": yardstick.busy_union(iv) / 1e6,
            "window_s": traced[-1].end - traced[0].start}


def _same(got, want):
    for key in ("roofline", "idle"):
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            assert got[key] == pytest.approx(want[key]), key
    assert got["families"] == pytest.approx(want["families"])


def _random_drop(seed):
    rng = np.random.default_rng(seed)
    return {(i, k) for i in range(4) for k in range(11)
            if rng.random() < 0.08}


# case: (trace arguments, the steps it holds whole)
CASES = {
    "all_records": ({}, [0, 1, 2, 3]),
    "half_of_one_step_dropped": ({"drop": {(2, k) for k in range(1, 6)}},
                                 [0, 1, 3]),
    "two_kernels_a_call": ({"split": {1}}, [0, 1, 2, 3]),
    "no_device_forward_range": ({"no_device_forward": {3}}, [0, 1, 2, 3]),
    "launch_record_lost": ({"unlaunched": {(1, 2)}}, [0, 2, 3]),
    "lost_before_the_first_step": ({"lost_before": 3}, [0, 1, 2, 3]),
    "most_dropped": ({"drop": {(0, 4), (1, 0), (3, 9)}}, [2]),
    **{f"random_drop_{s}": ({"drop": _random_drop(s)},
                            sorted(set(range(4))
                                   - {i for i, _ in _random_drop(s)}))
       for s in range(4)}}


@pytest.mark.parametrize("case", list(CASES))
def test_the_trace_is_read_over_its_whole_steps_alone(case):
    kw, whole = CASES[case]
    events, traced = _trace(**kw)
    tr = harness.read_events(events, traced)
    got = _read(tr)
    census = tr["census"]
    assert census["traced_steps"] == 4
    assert census["whole_steps"] == len(whole)
    assert census["lost_records"] == (len(kw.get("drop", ()))
                                      + kw.get("lost_before", 0))
    assert census["unpaired_records"] == len(kw.get("unlaunched", ()))
    assert census["graph_launches"] == 0
    if len(whole) < 2:
        # under half the steps whole: the device trace's metrics read null
        assert got["roofline"] is None and got["idle"] is None
        assert tr["steps"] == [] and tr["step_busy_s"] == []
        return
    # the same readings as a trace that held those steps alone, whole
    alone = _read(harness.read_events(*_trace(keep=whole)))
    _same(got, alone)
    assert tr["steps"] == [traced[i] for i in whole]
    if case in ("all_records", "two_kernels_a_call",
                "no_device_forward_range", "lost_before_the_first_step"):
        # every record held, and the bound unchanged by how the call is cut
        full = _read(harness.read_events(*_trace()))
        _same(got, full)
        today = _today(*_trace())
        _same(full, today)
        assert tr["busy_s"] == pytest.approx(today["busy_s"])
        assert tr["window_s"] == pytest.approx(today["window_s"])
        assert tr["gaps"] == pytest.approx(today["gaps"])
        assert len(tr["kernels"]) == census["device_records"]
        assert census["host_launches"] == (census["device_records"]
                                           + kw.get("lost_before", 0))
    if case == "half_of_one_step_dropped":
        # the parent divided the full bound by what the trace held
        assert _today(events, traced)["roofline"] > got["roofline"]
