"""``spans.py`` on the CPU: the program's step spans mapped onto the
profiler's clock, the idle gaps put down to them, and a tiny traced run's
readings with the recorder attached at the schedule's origin."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from perfbench import spans
from perfbench.test_perfbench_run import TINY


def test_a_profiled_step_maps_onto_its_engine_step():
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.trace import FlightRecorder

    cfg = reduced(get_config("stablelm_3b")).replace(dtype="float32")
    eng = ServingEngine(cfg, max_slots=2, seq_cap=32, page_size=4,
                        backend="paged", chunk_tokens=8, attn_impl="ref",
                        device="cpu")
    rng = np.random.default_rng(3)
    assert eng.submit(Request(req_id=0, tenant="T", prompt_len=10,
                              max_new_tokens=4, arrival=0.0,
                              prompt_tokens=rng.integers(0, cfg.vocab_size,
                                                         10)))
    eng.tracer = FlightRecorder(clock=time.perf_counter)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("warm"):   # the first range's set-up
        pass
    anchor = (time.perf_counter(), time.time_ns())
    for _ in range(3):
        with torch.profiler.record_function("around.step"):
            eng.step()
    prof.stop()
    off = spans.trace_offset_us(
        anchor, prof.profiler.kineto_results.trace_start_ns())
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == "around.step")
    mapped = [(st.t0 * 1e6 + off, st.t1 * 1e6 + off)
              for st in eng.tracer.steps]
    assert len(ranges) == len(mapped) == 3
    for (a, b), (s, e) in zip(ranges, mapped):
        assert abs(s - a) < 200 and abs(e - b) < 200


def test_gaps_fall_to_the_innermost_label_or_span():
    labels = [(0, 100, "runtime.run_mixed"), (10, 90, "model.forward")]
    program = [(-5, 105, "engine.step"), (2, 8, "step.pack"),
               (12, 50, "fwd.qkv"), (50, 88, "fwd.ffn")]
    gaps = [(6, 7), (20, 21), (60, 64), (89, 90), (95, 96), (200, 202)]
    out = spans.attribute(gaps, labels, program)
    assert out["old"] == pytest.approx({
        "model.forward": 6e-6, "runtime.run_mixed": 2e-6,
        spans.OUTSIDE: 2e-6})
    assert out["new"] == pytest.approx({
        "step.pack": 1e-6, "fwd.qkv": 1e-6, "fwd.ffn": 4e-6,
        "model.forward": 1e-6, "runtime.run_mixed": 1e-6,
        spans.OUTSIDE: 2e-6})
    assert sum(out["old"].values()) == pytest.approx(
        sum(out["new"].values()))
    assert out["moved_from_model_forward"] == pytest.approx(5 / 6)


def test_overhead_pairs_consecutive_steps():
    walls = [(True, 0.0, 0.012), (False, 0.02, 0.030),
             (False, 0.04, 0.050), (True, 0.06, 0.073),
             (True, 0.08, 0.090), (True, 0.10, 0.110),
             (True, 5.0, 5.1), (False, 5.2, 5.201)]      # after the window
    out = spans.overhead(walls, 0.0, 1.0)
    # pairs (0, 1) and (2, 3) differ in kind; (4, 5) do not
    assert out["pairs"] == 2
    assert out["diff_ms_mean"] == pytest.approx(2.5)
    assert out["diff_ms_p50"] == pytest.approx(2.5)
    assert out["step_ms_p50_without"] == pytest.approx(10.0)
    assert out["step_ms_p50_with"] == pytest.approx(11.0)
    assert out["diff_pct_of_step_p50"] == pytest.approx(25.0)   # of 10 ms


def test_per_step_counts_where_the_pad_lies():
    from repro_torch.core.obs import StepSpans
    recs = []
    for lanes, rows, slots, chunk in [(3, 10, 24, 8), (3, 3, 3, 0),
                                      (2, 9, 16, 8)]:
        rec = StepSpans(time.perf_counter)
        rec.args.update(lanes=lanes, rows=rows, lane_slots=slots,
                        chunk_tokens=chunk)
        recs.append((rec,))
    out = spans.per_step(recs)
    assert out["lanes"] == pytest.approx(8 / 3)
    assert out["lane_slots"] == pytest.approx(43 / 3)
    assert out["chunk_tokens"] == pytest.approx(16 / 3)
    assert out["pad_on_chunk_steps_pct"] == pytest.approx(100.0)
    assert spans.attention_pad_pct(recs) == pytest.approx(
        100 * (1 - 22 / 43))


def test_host_costs_are_read():
    assert -1.0 < spans.guard_cost_us(50, reps=200) < 50.0
    # forty layers' spans cost more than none, and each is timed
    assert 0.0 < spans.span_cost_us(0, reps=50) < spans.span_cost_us(
        40, reps=50)


@pytest.mark.parametrize("trace,alternate", [(True, False), (False, True)],
                         ids=["traced", "alternate"])
def test_tiny_traced_run_reads_the_program(monkeypatch, trace, alternate):
    import perfbench.harness as harness
    cell_name = "granite_3_8b.shared_prefix"
    from perfbench.conftest import tiny
    cell, pc = tiny(cell_name)
    cell.limits = TINY
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: [])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        row, seen = spans.run(cell, 20261, 1.5, trace, True,
                              t_start=time.perf_counter(), device="cpu",
                              port_cfg=pc, alternate=alternate)
    finally:
        torch.set_num_threads(threads)
    assert row["correct"]
    prog = row["program"]
    for name in ("forward_host_pct", "attention_pad_pct"):
        assert 0.0 <= prog[name] <= 100.0, (name, prog)
    assert prog["queue_wait_p90_ms"] >= 0.0
    assert abs(prog["compute_spans_over_compute_s"] - 1.0) < 0.01
    assert prog["children_cover_step"] >= 0.9
    per = prog["per_step"]
    assert per["lanes"] >= 1 and per["lane_slots"] >= per["rows"] >= 1
    assert per["chunk_tokens"] >= 0
    # the step spans lie on the harness's clock, inside its stamps: the
    # clock's base is read on entering the first finalize_step, a moment
    # after the harness's stamp, so it may read that moment low
    ctx, att = seen["ctx"], seen["att"]
    for rec, start, end, _ in att.steps:
        assert start - 1e-3 <= rec.t0 <= rec.t1 <= end
    if alternate:
        # the spans on every other step; the rest had none
        walls = [w for w in att.walls
                 if ctx.w0 <= w[1] and w[2] <= ctx.w1]
        assert any(on for on, *_ in walls) and any(
            not on for on, *_ in walls)
        assert row["overhead"]["pairs"] >= 2
        assert len(att.window(ctx.w0, ctx.w1)) == sum(
            1 for on, *_ in walls if on)
        return
    assert "gaps" in row
    # each request's queue wait lies within its time to first token
    splits = att.recorder.first_token_splits()
    due = [r for r in ctx.window_requests() if r.emits and not r.refused]
    assert due
    for r in due:
        wait = splits[("bench", r.src.rid)].get("sched_queued", 0.0)
        assert 0.0 <= wait <= r.emits[0] - r.src.due + 1e-9
    # the window's steps are the harness's
    assert len(att.window(ctx.w0, ctx.w1)) == len(ctx.steps)
